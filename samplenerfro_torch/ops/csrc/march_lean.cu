// K1: lean eikonal march, hand-written for Hopper (sm_90a).
//
// Replaces samplenerfro_tpu/ops/pallas/march_kernel.py:_march_kernel in
// lean-emit mode (emit_rows=7, in-kernel jittered subsample, no so3 head),
// reached there through march_tiled_pallas_lean.
//
// What it computes, per ray, for s = 0 .. S-1 (ops/eikonal.march:95-97):
//   (n, grad n) = trilinear(grid, p)          clamp-to-edge, fp32
//   emit dense[ray, s] = (p, d, t)             state BEFORE the update
//   if s == jitter[s / num_path]: sub[ray, s / num_path] = (p, d, t)
//   p' = p + (h / n) * d;  d' = d + h * grad n;  t' = t + |p - p'|
// starting from p = o + near * d0, d = d0, t = near. Directions are emitted
// raw; the wrapper normalizes them (march_kernel.py:709-722).
//
// Design: one thread per ray, the whole march in registers. The grid is
// [N^3, 4] fp32 in x-major order, so one voxel is one aligned float4 and a
// trilinear lookup is 8 float4 loads through the read-only cache. There are
// no grid windows: the TPU kernel stages windows in VMEM and counts
// out-of-window clamps; here every lookup reads the whole grid in global
// memory, so nothing is clamped and there is no window to size.
// Interpolation follows ops/grid.trilinear exactly: x first, then y, then
// z; corner indices clamped to [0, N-1]; the fraction x - floor(x) is not
// clamped. The build turns off FMA contraction (-fmad=false) so each
// product and sum rounds as in the plain PyTorch version.
//
// What bounds it on the card, per 8192-ray chunk at S=768, Nc=64:
//   writes: dense 8192*768*7*4 B = 176 MB, subsample 8192*64*7*4 B = 15 MB;
//   reads: 8 corner float4 per step = 805 MB of gathers, mostly L1/L2 hits:
//   the device-memory floor is the distinct voxels the chunk touches.
// So its bound is (bytes written + distinct grid bytes) / HBM bandwidth;
// the arithmetic (~100 fp32 operations per step) is far below the fp32
// peak. Known weaknesses, left for later work: each thread stores 28 B at a
// stride of S*28 B, so the dense stores coalesce poorly; nothing is staged
// in shared memory; the per-step gathers are latency-bound.

#include <cuda_runtime.h>

namespace {

struct MarchArgs {
  const float* origins;  // [B, 3]
  const float* dirs;     // [B, 3]
  const float4* grid;    // [nx*ny*nz] of (n, gx, gy, gz)
  const int* jitter;     // [Nc]
  float* dense;          // [B, S, 7]
  float* sub;            // [B, Nc, 7]
  int batch, num_samples, num_coarse, num_path;
  int nx, ny, nz;
  float near, step;
  float nmin_x, nmin_y, nmin_z;
  float nd_x, nd_y, nd_z;
};

__device__ __forceinline__ float4 lerp4(float4 a, float4 b, float t) {
  const float u = 1.0f - t;
  return make_float4(a.x * u + b.x * t, a.y * u + b.y * t,
                     a.z * u + b.z * t, a.w * u + b.w * t);
}

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

__device__ __forceinline__ float4 trilinear(const MarchArgs& a, float px,
                                            float py, float pz) {
  const float cx = (px - a.nmin_x) / a.nd_x;
  const float cy = (py - a.nmin_y) / a.nd_y;
  const float cz = (pz - a.nmin_z) / a.nd_z;
  const float fx0 = floorf(cx), fy0 = floorf(cy), fz0 = floorf(cz);
  const float xd = cx - fx0, yd = cy - fy0, zd = cz - fz0;
  const int ix = (int)fx0, iy = (int)fy0, iz = (int)fz0;
  const long long x0 = clampi(ix, a.nx - 1), x1 = clampi(ix + 1, a.nx - 1);
  const long long y0 = clampi(iy, a.ny - 1), y1 = clampi(iy + 1, a.ny - 1);
  const long long z0 = clampi(iz, a.nz - 1), z1 = clampi(iz + 1, a.nz - 1);
  const long long sy = a.nz, sx = (long long)a.ny * a.nz;
  const float4* g = a.grid;
  const float4 c000 = __ldg(g + sx * x0 + sy * y0 + z0);
  const float4 c100 = __ldg(g + sx * x1 + sy * y0 + z0);
  const float4 c001 = __ldg(g + sx * x0 + sy * y0 + z1);
  const float4 c101 = __ldg(g + sx * x1 + sy * y0 + z1);
  const float4 c010 = __ldg(g + sx * x0 + sy * y1 + z0);
  const float4 c110 = __ldg(g + sx * x1 + sy * y1 + z0);
  const float4 c011 = __ldg(g + sx * x0 + sy * y1 + z1);
  const float4 c111 = __ldg(g + sx * x1 + sy * y1 + z1);
  const float4 c00 = lerp4(c000, c100, xd);
  const float4 c01 = lerp4(c001, c101, xd);
  const float4 c10 = lerp4(c010, c110, xd);
  const float4 c11 = lerp4(c011, c111, xd);
  const float4 c0 = lerp4(c00, c10, yd);
  const float4 c1 = lerp4(c01, c11, yd);
  return lerp4(c0, c1, zd);
}

__device__ __forceinline__ void store7(float* out, float px, float py,
                                       float pz, float dx, float dy, float dz,
                                       float t) {
  out[0] = px; out[1] = py; out[2] = pz;
  out[3] = dx; out[4] = dy; out[5] = dz;
  out[6] = t;
}

__global__ void march_lean_kernel(const MarchArgs a) {
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= a.batch) return;
  float dx = a.dirs[3 * ray], dy = a.dirs[3 * ray + 1],
        dz = a.dirs[3 * ray + 2];
  float px = a.origins[3 * ray] + a.near * dx;
  float py = a.origins[3 * ray + 1] + a.near * dy;
  float pz = a.origins[3 * ray + 2] + a.near * dz;
  float t = a.near;
  float* dense = a.dense + (long long)ray * a.num_samples * 7;
  float* sub = a.sub + (long long)ray * a.num_coarse * 7;

  int bin = 0, in_bin = 0;
  int pick = __ldg(a.jitter);
  for (int s = 0; s < a.num_samples; ++s) {
    const float4 v = trilinear(a, px, py, pz);
    store7(dense + 7 * (long long)s, px, py, pz, dx, dy, dz, t);
    if (s == pick) store7(sub + 7 * bin, px, py, pz, dx, dy, dz, t);

    const float hn = a.step / v.x;
    const float nx = px + hn * dx, ny = py + hn * dy, nz = pz + hn * dz;
    dx = dx + a.step * v.y;
    dy = dy + a.step * v.z;
    dz = dz + a.step * v.w;
    const float ex = px - nx, ey = py - ny, ez = pz - nz;
    t = t + sqrtf(ex * ex + ey * ey + ez * ez);
    px = nx; py = ny; pz = nz;

    if (++in_bin == a.num_path && s + 1 < a.num_samples) {
      in_bin = 0;
      ++bin;
      pick = __ldg(a.jitter + bin);
    }
  }
}

}  // namespace

extern "C" int march_lean_launch(
    const float* origins, const float* dirs, const float* grid,
    const int* jitter, float* dense, float* sub, int batch, int num_samples,
    int num_coarse, int nx, int ny, int nz, float near, float step,
    float nmin_x, float nmin_y, float nmin_z, float nd_x, float nd_y,
    float nd_z, void* stream) {
  MarchArgs a;
  a.origins = origins;
  a.dirs = dirs;
  a.grid = reinterpret_cast<const float4*>(grid);
  a.jitter = jitter;
  a.dense = dense;
  a.sub = sub;
  a.batch = batch;
  a.num_samples = num_samples;
  a.num_coarse = num_coarse;
  a.num_path = num_samples / num_coarse;
  a.nx = nx; a.ny = ny; a.nz = nz;
  a.near = near;
  a.step = step;
  a.nmin_x = nmin_x; a.nmin_y = nmin_y; a.nmin_z = nmin_z;
  a.nd_x = nd_x; a.nd_y = nd_y; a.nd_z = nd_z;
  // 64 threads a block: an 8192-ray chunk spreads over 128 blocks, about
  // one per SM of the 132.
  const int threads = 64;
  const int blocks = (batch + threads - 1) / threads;
  march_lean_kernel<<<blocks, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
