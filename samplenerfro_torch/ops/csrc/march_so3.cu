// K2: eikonal march with the so3-refined gradient, hand-written for
// Hopper (sm_90a).
//
// Replaces samplenerfro_tpu/ops/pallas/march_kernel.py:_march_kernel in
// full-emit mode with the so3 head (_annealed_pe_t, _so3_refine_t), reached
// there through march_tiled_pallas(so3_params=...): the forward march of
// the 'all' stage.
//
// What it computes, per ray, for s = 0 .. S-1 (ops/eikonal.march):
//   (n, g) = trilinear(grid, p)                 clamp-to-edge, fp32
//   emit traj[ray, s] = (p, d, t, n, g)         11 channels, raw d
//   u = g;  if |g| > 1e-3:
//     x   = annealed PE of p: per degree k < K, [sin(p 2^k) w_k,
//           sin(p 2^k + pi/2) w_k]               (6K features, K = 10)
//     raw = MLP(x): 4 ReLU layers of width W (128), the inputs concatenated
//           after the third, then a linear layer to 3
//     u   = Rodrigues rotation of g by the axis-angle raw
//   p' = p + (h / n) d;  d' = d + h u;  t' = t + |p - p'|
// starting from p = o + near d0, d = d0, t = near. The window weights w_k
// come from the wrapper, computed there exactly as the plain version
// computes them. Skipping the MLP where |g| <= 1e-3 is exact: the plain
// version's `where` discards its result there.
//
// Design. A 1024-ray training batch is too few rays for one thread per ray
// to fill the card, and the so3 MLP (~1.3e5 fp32 operations per active
// ray-step) is the work. So a block of 128 threads marches a tile of
// R = 8 rays together: threads 0..R-1 each own one ray's state (p, d, t)
// in registers and do its trilinear gathers (8 float4 __ldg loads, as K1)
// and Euler update; all 128 threads then evaluate the MLP for the tile,
// thread j computing hidden unit j for the R rays, with the activations in
// shared memory. The fp32 weights (~65k floats = 260 KB) do not fit the
// 227 KB of shared memory a block may use, so they stay in device memory,
// stored input-major ([in][out]) so that a warp's 32 loads of one weight
// row are one coalesced 128-byte line, and are read through L1/L2: all 128
// blocks read the same 260 KB, which stays resident in the 50 MB L2. Each
// weight loaded is used for R rays. A tile with no active ray skips the
// MLP; the choice is uniform across the block, so every __syncthreads is
// reached by all threads.
//
// What bounds it: the MLP's fp32 arithmetic on the active ray-steps (at
// 67 TFLOP/s on CUDA cores; no tensor cores and no TF32, which would round
// differently from the plain version and flip ReLU masks) against the
// trajectory written (B*S*11*4 bytes) and the distinct voxels read. The
// known weakness of this first version: each step's weight reads stream
// 260 KB through L1 per block, and with 4 warps a block the load latency
// is poorly hidden. The dot products use explicit fmaf (the build turns
// off FMA contraction for everything else, so the march arithmetic rounds
// as in the plain version); the plain version's matrix products sum in
// another order, so the MLP agrees to rounding, not bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kRays = 8;        // rays per block
constexpr int kThreads = 128;   // threads per block = max hidden width
constexpr int kMaxIn = 64;      // max PE features (6 * max_deg)
constexpr int kMaxDeg = 10;
constexpr float kHalfPi = 1.5707963267948966f;

struct So3Args {
  const float* origins;  // [B, 3]
  const float* dirs;     // [B, 3]
  const float4* grid;    // [nx*ny*nz] of (n, gx, gy, gz)
  const float* wpack;    // W0t b0 W1t b1 W2t b2 W3t b3 Woutt bout
  const float* window;   // [max_deg] annealing weights
  float* traj;           // [B, S, 11]
  int batch, num_samples, max_deg, in_dim, width;
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

// ops/grid.trilinear: x first, then y, then z; clamped corner indices,
// unclamped fractions (the same code as K1).
__device__ __forceinline__ float4 trilinear(const So3Args& a, float px,
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

// out[r][j] = act(bias[j] + sum_k in[r][k] * w[k * width + j]) for the
// tile's R rays; thread j owns column j. The inputs of layer 3 are the
// concatenation [h3, x], passed as two pieces.
__device__ __forceinline__ void dense_tile(
    const float* __restrict__ w, const float* __restrict__ bias,
    const float (*in_a)[kThreads], int ka, const float (*in_b)[kMaxIn],
    int kb, int width, bool relu, float (*out)[kThreads]) {
  const int j = threadIdx.x;
  if (j >= width) return;
  float acc[kRays];
#pragma unroll
  for (int r = 0; r < kRays; ++r) acc[r] = 0.0f;
  for (int k = 0; k < ka; ++k) {
    const float wk = __ldg(w + k * width + j);
#pragma unroll
    for (int r = 0; r < kRays; ++r) acc[r] = __fmaf_rn(in_a[r][k], wk, acc[r]);
  }
  for (int k = 0; k < kb; ++k) {
    const float wk = __ldg(w + (ka + k) * width + j);
#pragma unroll
    for (int r = 0; r < kRays; ++r) acc[r] = __fmaf_rn(in_b[r][k], wk, acc[r]);
  }
  const float b = __ldg(bias + j);
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const float v = acc[r] + b;
    out[r][j] = relu ? fmaxf(v, 0.0f) : v;
  }
}

__device__ __forceinline__ float safe_norm(float x, float y, float z) {
  return sqrtf(fmaxf(x * x + y * y + z * z, 1e-6f));
}

__global__ void __launch_bounds__(kThreads)
march_so3_kernel(const So3Args a) {
  __shared__ float x_s[kRays][kMaxIn];
  __shared__ float h_s[4][kRays][kThreads];
  __shared__ float p_s[kRays][3];
  __shared__ float raw_s[kRays][3];
  __shared__ int act_s[kRays];
  __shared__ float win_s[kMaxDeg];

  const int tid = threadIdx.x;
  const int W = a.width, IN = a.in_dim;
  const float* w0 = a.wpack;
  const float* b0 = w0 + IN * W;
  const float* w1 = b0 + W;
  const float* b1 = w1 + W * W;
  const float* w2 = b1 + W;
  const float* b2 = w2 + W * W;
  const float* w3 = b2 + W;
  const float* b3 = w3 + (W + IN) * W;
  const float* wo = b3 + W;
  const float* bo = wo + W * 3;
  if (tid < a.max_deg) win_s[tid] = a.window[tid];

  const int ray = blockIdx.x * kRays + tid;
  const bool owner = tid < kRays && ray < a.batch;
  float px = 0.f, py = 0.f, pz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float t = a.near, n = 1.f, gx = 0.f, gy = 0.f, gz = 0.f;
  float* traj = nullptr;
  if (owner) {
    dx = a.dirs[3 * ray]; dy = a.dirs[3 * ray + 1]; dz = a.dirs[3 * ray + 2];
    px = a.origins[3 * ray] + a.near * dx;
    py = a.origins[3 * ray + 1] + a.near * dy;
    pz = a.origins[3 * ray + 2] + a.near * dz;
    traj = a.traj + (long long)ray * a.num_samples * 11;
  }

  for (int s = 0; s < a.num_samples; ++s) {
    if (owner) {
      const float4 v = trilinear(a, px, py, pz);
      n = v.x; gx = v.y; gy = v.z; gz = v.w;
      float* o = traj + 11 * (long long)s;
      o[0] = px; o[1] = py; o[2] = pz;
      o[3] = dx; o[4] = dy; o[5] = dz;
      o[6] = t; o[7] = n; o[8] = gx; o[9] = gy; o[10] = gz;
      p_s[tid][0] = px; p_s[tid][1] = py; p_s[tid][2] = pz;
      act_s[tid] = sqrtf(gx * gx + gy * gy + gz * gz) > 1e-3f;
    } else if (tid < kRays) {
      p_s[tid][0] = p_s[tid][1] = p_s[tid][2] = 0.0f;
      act_s[tid] = 0;
    }
    __syncthreads();
    int any = 0;
#pragma unroll
    for (int r = 0; r < kRays; ++r) any |= act_s[r];
    if (any) {
      for (int i = tid; i < kRays * IN; i += kThreads) {
        const int r = i / IN, f = i % IN;
        const int deg = f / 6, c = f % 3;
        const float xb = p_s[r][c] * (float)(1 << deg);
        const float arg = (f % 6) < 3 ? xb : xb + kHalfPi;
        x_s[r][f] = sinf(arg) * win_s[deg];
      }
      __syncthreads();
      dense_tile(w0, b0, nullptr, 0, x_s, IN, W, true, h_s[0]);
      __syncthreads();
      dense_tile(w1, b1, h_s[0], W, nullptr, 0, W, true, h_s[1]);
      __syncthreads();
      dense_tile(w2, b2, h_s[1], W, nullptr, 0, W, true, h_s[2]);
      __syncthreads();
      dense_tile(w3, b3, h_s[2], W, x_s, IN, W, true, h_s[3]);
      __syncthreads();
      if (tid < 3 * kRays) {
        const int r = tid / 3, o = tid % 3;
        float acc = 0.0f;
        for (int k = 0; k < W; ++k)
          acc = __fmaf_rn(h_s[3][r][k], __ldg(wo + 3 * k + o), acc);
        raw_s[r][o] = acc + __ldg(bo + o);
      }
      __syncthreads();
    }
    if (owner) {
      float ux = gx, uy = gy, uz = gz;
      if (act_s[tid]) {
        // ops/eikonal.rodrigues_rotate, term by term in its order.
        const float rx = raw_s[tid][0], ry = raw_s[tid][1],
                    rz = raw_s[tid][2];
        const float theta = safe_norm(rx, ry, rz);
        const float ex = rx / theta, ey = ry / theta, ez = rz / theta;
        const float an = safe_norm(gx, gy, gz);
        const float vx = gx / an, vy = gy / an, vz = gz / an;
        const float ct = cosf(theta), st = sinf(theta);
        const float cx = ey * vz - ez * vy, cy = ez * vx - ex * vz,
                    cz = ex * vy - ey * vx;
        const float ev = (ex * vx + ey * vy) + ez * vz;
        const float k = (1.0f - ct) * ev;
        ux = an * ((ct * vx + st * cx) + k * ex);
        uy = an * ((ct * vy + st * cy) + k * ey);
        uz = an * ((ct * vz + st * cz) + k * ez);
      }
      const float hn = a.step / n;
      const float qx = px + hn * dx, qy = py + hn * dy, qz = pz + hn * dz;
      dx = dx + a.step * ux;
      dy = dy + a.step * uy;
      dz = dz + a.step * uz;
      const float ex = px - qx, ey = py - qy, ez = pz - qz;
      t = t + sqrtf(ex * ex + ey * ey + ez * ez);
      px = qx; py = qy; pz = qz;
    }
    // The owners rewrite p_s and act_s next step: every thread must have
    // read this step's flags first.
    __syncthreads();
  }
}

}  // namespace

extern "C" int march_so3_launch(
    const float* origins, const float* dirs, const float* grid,
    const float* wpack, const float* window, float* traj, int batch,
    int num_samples, int max_deg, int width, int nx, int ny, int nz,
    float near, float step, float nmin_x, float nmin_y, float nmin_z,
    float nd_x, float nd_y, float nd_z, void* stream) {
  if (width > kThreads || 6 * max_deg > kMaxIn || max_deg > kMaxDeg)
    return static_cast<int>(cudaErrorInvalidValue);
  So3Args a;
  a.origins = origins;
  a.dirs = dirs;
  a.grid = reinterpret_cast<const float4*>(grid);
  a.wpack = wpack;
  a.window = window;
  a.traj = traj;
  a.batch = batch;
  a.num_samples = num_samples;
  a.max_deg = max_deg;
  a.in_dim = 6 * max_deg;
  a.width = width;
  a.nx = nx; a.ny = ny; a.nz = nz;
  a.near = near;
  a.step = step;
  a.nmin_x = nmin_x; a.nmin_y = nmin_y; a.nmin_z = nmin_z;
  a.nd_x = nd_x; a.nd_y = nd_y; a.nd_z = nd_z;
  // 1024 rays -> 128 blocks of 8 rays, about one per SM of the 132.
  const int blocks = (batch + kRays - 1) / kRays;
  march_so3_kernel<<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
