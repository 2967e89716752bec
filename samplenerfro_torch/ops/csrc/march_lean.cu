// K1: lean eikonal march, hand-written for Hopper (sm_90a); and K2 with
// the head off: the same march emitting the full trajectory.
//
// K1 replaces samplenerfro_tpu/ops/pallas/march_kernel.py:_march_kernel in
// lean-emit mode (emit_rows=7, in-kernel jittered subsample, no so3 head),
// reached there through march_tiled_pallas_lean. The full-emit variant
// (march_full_plain_launch) replaces the same kernel in full-emit mode
// with so3_params=None (march_tiled_pallas, march_kernel.py:763-790): rows
// of 11 floats (p, raw d, t, n, grad n), no subsample, stepping with the
// grid's own gradient. It is the one template below with kFull set, so its
// p, d and t are K1's bit for bit; its bound is the bytes it writes,
// B * S * 44.
//
// What it computes, per ray, for s = 0 .. S-1 (ops/eikonal.march:95-97):
//   (n, grad n) = trilinear(grid, p)          clamp-to-edge, fp32
//   emit dense[ray, s] = (p, d, t)             state BEFORE the update
//   if s == jitter[s / num_path]: sub[ray, s / num_path] = (p, d, t)
//   p' = p + (h / n) * d;  d' = d + h * grad n;  t' = t + |p - p'|
// starting from p = o + near * d0, d = d0, t = near. Directions are emitted
// raw; the wrapper normalizes them (march_kernel.py:709-722). There are no
// grid windows: the TPU kernel stages windows in VMEM and counts
// out-of-window clamps; here every lookup reads the grid in device memory.
//
// What bounds it on the card. Bytes: per 8192-ray chunk at S=768, Nc=64,
// the dense rows (176 MB) and the subsample (15 MB) written once, and the
// distinct voxels the chunk's paths touch read once: 0.111 ms at HBM rate.
// The arithmetic (~120 fp32 operations a step) is far below the fp32 peak.
// But a ray's 768 steps are a dependent chain: each step's gathers need the
// position the last step computed. So the floor under the byte bound is
// 768 x (one gather round trip + the step's own latency: three true
// divisions for the cell, the lerps, a division and a square root), which
// no spread over the card shortens; with the gathers loaded ahead (below)
// the card shows ~0.8 us a step at 1024 rays (chip_smoke.py; PERF.md).
//
// Design (march_common.cuh): 8 lanes a ray, one a trilinear corner, the
// corners combined by shuffles in the plain version's order, the state
// held identically by all 8. The gathers leave the chain: each step also
// loads the corners of the cell it guesses the ray will reach kAhead steps
// on (from the new state at this step's speed), and a step uses a value
// loaded ahead wherever its exact corner address equals the guessed one,
// else it loads. A block is 8 rays (64 threads), so a 1024-ray radiance
// batch spreads over 128 SMs and an 8192-ray chunk has 2048 warps. Each ray's rows go to shared memory for
// kStage steps and then out as 16-byte stores: a ray's rows of a stage are
// contiguous in [B, S, 7], so each 8-lane group writes whole 128-byte
// lines. The subsample rows wait in shared memory until the march ends.
// Every output comes from the same expressions in the same order as in a
// one-thread-a-ray march, so the layout does not change a bit of it.

#include <cstdint>

#include <cuda_runtime.h>

#include "march_common.cuh"

namespace {

using march::kLanes;

constexpr int kRays = 8;                  // rays a block
constexpr int kThreads = kRays * kLanes;  // 64
constexpr int kStage = 32;                // steps staged before a store
constexpr int kRow = 7;                   // floats a row: p, d, t
constexpr int kFullRow = 11;              // + n, grad n (full emit)
constexpr int kAhead = 6;                 // steps a gather is loaded ahead

struct MarchArgs {
  const float* origins;  // [B, 3]
  const float* dirs;     // [B, 3]
  march::Grid grid;
  const int* jitter;     // [Nc]; unused by the full emit
  float* dense;          // [B, S, 7], or [B, S, 11] for the full emit
  float* sub;            // [B, Nc, 7]; unused by the full emit
  int batch, num_samples, num_coarse, num_path;
  float near, step;
};

// n floats from shared `src` to device `dst` by the 8 lanes of a ray:
// 16-byte stores where both ends allow them, else 4-byte ones.
__device__ __forceinline__ void flush(const float* src, float* dst, int n,
                                      int lane) {
  const bool wide = ((reinterpret_cast<uintptr_t>(dst) |
                      reinterpret_cast<uintptr_t>(src)) & 15) == 0 &&
                    (n & 3) == 0;
  if (wide) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = lane; i < n / 4; i += kLanes) d4[i] = s4[i];
  } else {
    for (int i = lane; i < n; i += kLanes) dst[i] = src[i];
  }
}

// The march of one block. kFull: emit [B, S, 11] rows and no subsample
// (K2 with the head off); else K1's lean rows and subsample.
template <bool kFull>
__device__ __forceinline__ void march_block(const MarchArgs& a) {
  constexpr int kOut = kFull ? kFullRow : kRow;  // floats a dense row
  // [kRays][kStage][kOut] staged dense rows, then (lean) [kRays][Nc][7]
  // subsample.
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x % kLanes, local = threadIdx.x / kLanes;
  const int want = blockIdx.x * kRays + local;
  // A ray past the batch marches the last ray again and stores nothing,
  // so that every lane of the warp takes every shuffle.
  const bool valid = want < a.batch;
  const int ray = valid ? want : a.batch - 1;
  float* stage = smem + local * kStage * kOut;
  float* subs = smem + kRays * kStage * kOut + local * a.num_coarse * kRow;

  float dx = a.dirs[3 * ray], dy = a.dirs[3 * ray + 1],
        dz = a.dirs[3 * ray + 2];
  float px = a.origins[3 * ray] + a.near * dx;
  float py = a.origins[3 * ray + 1] + a.near * dy;
  float pz = a.origins[3 * ray + 2] + a.near * dz;
  float t = a.near;
  float* dense = a.dense + (long long)ray * a.num_samples * kOut;

  // Slot u holds the corner loaded ahead for the steps s with s % kAhead
  // == u: its address and value. Before the march the guesses assume
  // n = 1.
  const float4* ahead_a[kAhead];
  float4 ahead_v[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    const float f = (float)u * a.step;
    ahead_a[u] = march::guess8(a.grid, px + f * dx, py + f * dy, pz + f * dz,
                               lane);
    ahead_v[u] = march::load_now(ahead_a[u]);
  }

  int bin = 0, in_bin = 0, s0 = 0;
  int pick = kFull ? -1 : __ldg(a.jitter);
  for (int base = 0; base < a.num_samples; base += kAhead) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int s = base + u;
      if (s >= a.num_samples) break;
      const march::Corner c = march::corner8(a.grid, px, py, pz, lane);
      const float4 v = march::combine8(
          march::load_if(c.addr != ahead_a[u], c.addr, ahead_v[u]), c, lane);
      if (lane < kRow) {
        const float x = lane == 0 ? px : lane == 1 ? py : lane == 2 ? pz
                      : lane == 3 ? dx : lane == 4 ? dy : lane == 5 ? dz : t;
        stage[(s - s0) * kOut + lane] = x;
        if (!kFull && s == pick) subs[bin * kRow + lane] = x;
      }
      if (kFull && lane < 4)
        stage[(s - s0) * kOut + kRow + lane] =
            lane == 0 ? v.x : lane == 1 ? v.y : lane == 2 ? v.z : v.w;
      float qx, qy, qz;
      march::next_position(a.step, v.x, px, py, pz, dx, dy, dz, qx, qy, qz);
      march::finish_step(a.step, v.y, v.z, v.w, qx, qy, qz, px, py, pz, dx,
                         dy, dz, t);
      // Slot u is free: load ahead for step s + kAhead, guessed from the
      // new state at this step's speed.
      const float f = (float)(kAhead - 1) * a.step / v.x;
      ahead_a[u] = march::guess8(a.grid, px + f * dx, py + f * dy,
                                 pz + f * dz, lane);
      ahead_v[u] = march::load_now(ahead_a[u]);

      if (!kFull && ++in_bin == a.num_path && s + 1 < a.num_samples) {
        in_bin = 0;
        ++bin;
        pick = __ldg(a.jitter + bin);
      }
      if (s + 1 - s0 == kStage || s + 1 == a.num_samples) {
        __syncwarp();
        if (valid) flush(stage, dense + (long long)s0 * kOut,
                         (s + 1 - s0) * kOut, lane);
        __syncwarp();
        s0 = s + 1;
      }
    }
  }
  if (!kFull && valid)
    flush(subs, a.sub + (long long)ray * a.num_coarse * kRow,
          a.num_coarse * kRow, lane);
}

__global__ void __launch_bounds__(kThreads)
march_lean_kernel(const MarchArgs a) {
  march_block<false>(a);
}

__global__ void __launch_bounds__(kThreads)
march_full_plain_kernel(const MarchArgs a) {
  march_block<true>(a);
}

march::Grid make_grid(const float* grid, int nx, int ny, int nz,
                      float nmin_x, float nmin_y, float nmin_z, float nd_x,
                      float nd_y, float nd_z) {
  return {reinterpret_cast<const float4*>(grid), nx, ny, nz,
          nmin_x, nmin_y, nmin_z, nd_x, nd_y, nd_z,
          1.0f / nd_x, 1.0f / nd_y, 1.0f / nd_z};
}

}  // namespace

// The launch geometry is march_kernel.lean_launch_geometry's; the caller
// passes its rays a block, threads and shared bytes, and they are checked
// here again.
extern "C" int march_lean_launch(
    const float* origins, const float* dirs, const float* grid,
    const int* jitter, float* dense, float* sub, int batch, int num_samples,
    int num_coarse, int nx, int ny, int nz, float near, float step,
    float nmin_x, float nmin_y, float nmin_z, float nd_x, float nd_y,
    float nd_z, int rays_per_block, int threads, int smem_bytes,
    void* stream) {
  const long long want_smem =
      4LL * kRays * kRow * ((long long)kStage + num_coarse);
  if (batch < 1 || num_coarse < 1 || num_samples % num_coarse ||
      rays_per_block != kRays || threads != kThreads ||
      smem_bytes != want_smem)
    return static_cast<int>(cudaErrorInvalidValue);
  static int smem_set = 0;
  if (smem_bytes > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        march_lean_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem_bytes;
  }
  MarchArgs a;
  a.origins = origins;
  a.dirs = dirs;
  a.grid = make_grid(grid, nx, ny, nz, nmin_x, nmin_y, nmin_z, nd_x, nd_y,
                     nd_z);
  a.jitter = jitter;
  a.dense = dense;
  a.sub = sub;
  a.batch = batch;
  a.num_samples = num_samples;
  a.num_coarse = num_coarse;
  a.num_path = num_samples / num_coarse;
  a.near = near;
  a.step = step;
  const int blocks = (batch + kRays - 1) / kRays;
  march_lean_kernel<<<blocks, kThreads, smem_bytes,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K2 with the head off: [B, S, 11] rows into `traj`. The launch geometry
// is march_kernel.full_plain_launch_geometry's (K1's blocks, 11-float rows
// and no subsample: 11,264 shared bytes a block), checked here again.
extern "C" int march_full_plain_launch(
    const float* origins, const float* dirs, const float* grid, float* traj,
    int batch, int num_samples, int nx, int ny, int nz, float near,
    float step, float nmin_x, float nmin_y, float nmin_z, float nd_x,
    float nd_y, float nd_z, int rays_per_block, int threads,
    int smem_bytes, void* stream) {
  if (batch < 1 || num_samples < 1 || rays_per_block != kRays ||
      threads != kThreads || smem_bytes != 4 * kRays * kStage * kFullRow)
    return static_cast<int>(cudaErrorInvalidValue);
  MarchArgs a;
  a.origins = origins;
  a.dirs = dirs;
  a.grid = make_grid(grid, nx, ny, nz, nmin_x, nmin_y, nmin_z, nd_x, nd_y,
                     nd_z);
  a.jitter = nullptr;
  a.dense = traj;
  a.sub = nullptr;
  a.batch = batch;
  a.num_samples = num_samples;
  a.num_coarse = 0;
  a.num_path = 0;
  a.near = near;
  a.step = step;
  const int blocks = (batch + kRays - 1) / kRays;
  march_full_plain_kernel<<<blocks, kThreads, smem_bytes,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
