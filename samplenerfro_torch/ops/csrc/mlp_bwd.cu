// K5: the fused NerfMLP parameter backward, hand-written for Hopper
// (sm_90a).
//
// Replaces samplenerfro_tpu/ops/pallas/mlp_kernel.py:_bwd_kernel (line
// 246), the backward of fused_nerf_mlp: the radiance stage's MLP weight
// gradients under --mlp_kernel=pallas|pallas_pe.
//
// What it computes: the fp32 gradient of every weight and bias of the
// NerfMLP from the [n, num_rgb + num_sigma] cotangent of K4's output, and
// no input cotangent (the radiance stage's inputs come from the frozen
// path sampler). Per row tile, as _bwd_kernel (268-317): recompute the
// forward (mlp_common.cuh:forward_tile), then walk back through the rgb
// head, the condition layer, the sigma and bottleneck heads and the trunk;
// ReLU masks are taken on the stored activations (act > 0), each
// pre-activation cotangent is rounded to the compute type before its
// products, each bias gradient is the fp32 sum of the unrounded cotangent,
// and dW = (layer input)^T (rounded cotangent) sums over the rows in fp32.
// Rows past n carry a zero cotangent and add nothing.
//
// Two launches, one wrapper call:
//  1. mlp_bwd_kernel: a fixed grid of G blocks (one per SM at most); block
//     b takes the tiles b, b + G, ... in order. The tile's inputs, its
//     cotangent and the two working [64, 256] buffers are in shared memory
//     (the backward reuses the forward's buffers: dh in fp32 and its
//     rounded copy). The forward's stored activations, 9 x [64, 256] plus
//     [64, 128] a tile (590 KB fp32, more than shared memory holds), go to
//     the block's own slab of a global scratch buffer and are read back
//     from L1/L2. Each block adds its tiles' dW/db into its own [P] slice
//     of a [G, P] fp32 partial buffer (P = 595,715 at ship width, 2.4 MB;
//     313 MB for 132 blocks): every entry is owned by one thread and
//     updated in a fixed order. No atomics.
//  2. mlp_bwd_reduce: sums the G partials of each parameter in block
//     order. Two runs therefore agree bit for bit.
//
// What bounds it on the card: operations, about three times K4's (the
// recompute, the products to dh, the dW outer products): 0.70 TFLOP for
// the bf16 train batch's fine call (196,608 rows), 0.71 ms on bf16 tensor
// cores. This version runs every product on CUDA cores (the same
// register-tiled product as K4) and reads and writes each block's 2.4 MB
// partial once a tile (4.8 MB for 64 rows), which is its known weakness
// after the CUDA-core arithmetic (gemm_add overlaps those reads).

#include "mlp_common.cuh"

namespace {

using fused_mlp::kRows;
using fused_mlp::kThreads;
using fused_mlp::kTM;
using fused_mlp::kTN;
using fused_mlp::Seg;
using fused_mlp::Spec;
using fused_mlp::gemm;
using fused_mlp::load;
using fused_mlp::round_to;

// dst[c] += sum over the tile's rows of g[r * ld + c], rows in order.
__device__ void colsum(const float* g, int ld, int cols, float* dst) {
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    float acc = 0.0f;
    for (int r = 0; r < kRows; ++r) acc += g[r * ld + c];
    dst[c] += acc;
  }
}

// p[r * ld + c] += sum_j X(r, j) Y(j, c) for r < rows, c < cols: gemm's
// product, added into a block's partial buffer. Each thread reads all its
// kTM x kTN partial entries before it writes any, so their device-memory
// latencies overlap (gemm's per-element epilogue would serialise them:
// the compiler cannot move a load above a store that may alias it).
template <typename T>
__device__ void gemm_add(int rows, int cols, const Seg<T>& s, float* p,
                         int ld) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rgroups = (rows + kTM - 1) / kTM;
  const int cgroups = (cols + 32 * kTN - 1) / (32 * kTN);
  for (int u = warp; u < rgroups * cgroups; u += kThreads / 32) {
    const int r0 = (u % rgroups) * kTM;
    const int c0 = (u / rgroups) * 32 * kTN + lane;
    float acc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
#pragma unroll
      for (int t = 0; t < kTN; ++t) acc[i][t] = 0.0f;
    }
    fused_mlp::accumulate(acc, s, r0, rows, c0, cols);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
#pragma unroll
      for (int t = 0; t < kTN; ++t) {
        const int r = r0 + i, c = c0 + 32 * t;
        if (r < rows && c < cols) {
          acc[i][t] += p[static_cast<long long>(r) * ld + c];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
#pragma unroll
      for (int t = 0; t < kTN; ++t) {
        const int r = r0 + i, c = c0 + 32 * t;
        if (r < rows && c < cols) {
          p[static_cast<long long>(r) * ld + c] = acc[i][t];
        }
      }
    }
  }
}

template <typename T>
__device__ size_t region_bytes(int maxw) {
  const size_t fwd = 2 * sizeof(T) * kRows * maxw;
  const size_t bwd = (sizeof(float) + sizeof(T)) * kRows * maxw;
  return fwd > bwd ? fwd : bwd;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    mlp_bwd_kernel(Spec s, const float* x, const float* c, const float* dout,
                   const T* wkn, const T* wnk, const float* bias, T* scratch,
                   float* partial, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = s.width, F = s.feat, C = s.cond, D = s.depth;
  const int CW = s.cond_width, R = s.num_rgb, S = s.num_sigma, O = R + S;
  const int maxw = W > CW ? W : CW;
  // The forward's two activation buffers and the backward's dh (fp32) and
  // its rounded copy share one region.
  T* buf0 = reinterpret_cast<T*>(smem);
  T* buf1 = buf0 + kRows * maxw;
  float* g32 = reinterpret_cast<float*>(smem);
  T* g16 = reinterpret_cast<T*>(smem + sizeof(float) * kRows * maxw);
  float* douts = reinterpret_cast<float*>(smem + region_bytes<T>(maxw));
  T* d16 = reinterpret_cast<T*>(douts + kRows * O);
  T* x0s = d16 + kRows * O;
  T* conds = x0s + kRows * F;

  const long long slab = static_cast<long long>(D + 1) * kRows * W +
                         static_cast<long long>(kRows) * CW;
  T* save = scratch + blockIdx.x * slab;
  float* part = partial + blockIdx.x * (s.num_weights + s.num_biases);
  float* pbias = part + s.num_weights;
  const T* hv = save + static_cast<long long>(D - 1) * kRows * W;
  const T* bnv = save + static_cast<long long>(D) * kRows * W;
  const T* acv = save + static_cast<long long>(D + 1) * kRows * W;
  const int lsig = D, lbn = D + 1, lc = D + 2, lrgb = D + 3;
  const Seg<T> none = {nullptr, 0, 0, nullptr, 0, 0};
  const int tiles = (n + kRows - 1) / kRows;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * kRows;
    fused_mlp::load_tile(s, x, c, row0, n, x0s, conds);
    for (int e = threadIdx.x; e < kRows * O; e += blockDim.x) {
      const long long row = row0 + e / O;
      const float v = row < n ? dout[row * O + e % O] : 0.0f;
      douts[e] = v;
      d16[e] = round_to<T>(v);
    }
    __syncthreads();
    fused_mlp::forward_tile<T>(s, wkn, bias, x0s, conds, buf0, buf1, save,
                               nullptr, row0, n);

    // rgb head: dW += a_c^T drgb16, db += sum drgb;
    // da_c = (drgb16 Wrgb^T) * (a_c > 0).
    gemm_add(CW, R, Seg<T>{acv, 1, CW, d16, O, kRows}, part + s.w_off[lrgb],
             R);
    colsum(douts, O, R, pbias + s.b_off[lrgb]);
    gemm(kRows, CW, Seg<T>{d16, O, 1, wnk + s.w_off[lrgb], CW, R}, none,
         [&](int r, int k, float v) {
           v *= load(acv + r * CW + k) > 0.0f ? 1.0f : 0.0f;
           g32[r * CW + k] = v;
           g16[r * CW + k] = round_to<T>(v);
         });
    __syncthreads();

    // Condition layer: db += sum da_c; dW += [bottleneck, cond]^T da_c16.
    colsum(g32, CW, CW, pbias + s.b_off[lc]);
    gemm_add(W, CW, Seg<T>{bnv, 1, W, g16, CW, kRows}, part + s.w_off[lc],
             CW);
    gemm_add(C, CW, Seg<T>{conds, 1, C, g16, CW, kRows},
             part + s.w_off[lc] + static_cast<long long>(W) * CW, CW);
    __syncthreads();
    // The bottleneck's cotangent: (da_c16 Wc^T) over its first W inputs.
    gemm(kRows, W, Seg<T>{g16, CW, 1, wnk + s.w_off[lc], W + C, CW}, none,
         [&](int r, int k, float v) { g32[r * W + k] = v; });
    __syncthreads();
    for (int e = threadIdx.x; e < kRows * W; e += blockDim.x) {
      g16[e] = round_to<T>(g32[e]);
    }
    __syncthreads();

    // Sigma and bottleneck heads on the trunk output h.
    gemm_add(W, S, Seg<T>{hv, 1, W, d16 + R, O, kRows}, part + s.w_off[lsig],
             S);
    colsum(douts + R, O, S, pbias + s.b_off[lsig]);
    gemm_add(W, W, Seg<T>{hv, 1, W, g16, W, kRows}, part + s.w_off[lbn], W);
    colsum(g32, W, W, pbias + s.b_off[lbn]);
    __syncthreads();
    // dh = dbn16 Wbn^T + dsigma16 Wsigma^T.
    gemm(kRows, W, Seg<T>{g16, W, 1, wnk + s.w_off[lbn], W, W},
         Seg<T>{d16 + R, O, 1, wnk + s.w_off[lsig], W, S},
         [&](int r, int k, float v) { g32[r * W + k] = v; });
    __syncthreads();

    // Trunk, last layer first.
    for (int i = D - 1; i >= 0; --i) {
      const T* act = save + static_cast<long long>(i) * kRows * W;
      for (int e = threadIdx.x; e < kRows * W; e += blockDim.x) {
        const float v = g32[e] * (load(act + e) > 0.0f ? 1.0f : 0.0f);
        g32[e] = v;
        g16[e] = round_to<T>(v);
      }
      __syncthreads();
      colsum(g32, W, W, pbias + s.b_off[i]);
      float* pw = part + s.w_off[i];
      if (i == 0) {
        gemm_add(F, W, Seg<T>{x0s, 1, F, g16, W, kRows}, pw, W);
      } else {
        const T* prev = save + static_cast<long long>(i - 1) * kRows * W;
        gemm_add(W, W, Seg<T>{prev, 1, W, g16, W, kRows}, pw, W);
        if (fused_mlp::skip_after(s, i - 1)) {
          gemm_add(F, W, Seg<T>{x0s, 1, F, g16, W, kRows},
                   pw + static_cast<long long>(W) * W, W);
        }
      }
      __syncthreads();
      if (i > 0) {
        // dh over the previous activation's columns (the skip input's
        // columns carry no gradient anywhere).
        gemm(kRows, W, Seg<T>{g16, W, 1, wnk + s.w_off[i], s.k[i], W}, none,
             [&](int r, int k, float v) { g32[r * W + k] = v; });
        __syncthreads();
      }
    }
  }
}

__global__ void mlp_bwd_reduce(const float* partial, int blocks,
                               long long count, float* grads) {
  const long long p = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (p >= count) return;
  float acc = 0.0f;
  for (int g = 0; g < blocks; ++g) acc += partial[g * count + p];
  grads[p] = acc;
}

template <typename T>
int launch(const Spec& s, const float* x, const float* c, const float* dout,
           const void* wkn, const void* wnk, const float* bias,
           void* scratch, float* partial, float* grads, int n, int blocks,
           cudaStream_t stream) {
  const int maxw = s.width > s.cond_width ? s.width : s.cond_width;
  const int O = s.num_rgb + s.num_sigma;
  const size_t fwd = 2 * sizeof(T) * kRows * maxw;
  const size_t bwd = (sizeof(float) + sizeof(T)) * kRows * maxw;
  const size_t smem = (fwd > bwd ? fwd : bwd) +
                      (sizeof(float) + sizeof(T)) * kRows * O +
                      sizeof(T) * kRows * (s.feat + s.cond);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mlp_bwd_kernel<T><<<blocks, kThreads, smem, stream>>>(
      s, x, c, dout, static_cast<const T*>(wkn), static_cast<const T*>(wnk),
      bias, static_cast<T*>(scratch), partial, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long count = s.num_weights + s.num_biases;
  mlp_bwd_reduce<<<static_cast<unsigned>((count + 255) / 256), 256, 0,
                   stream>>>(partial, blocks, count, grads);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, c, wkn, bias: as mlp_fwd_launch; dout: [n, num_rgb + num_sigma] fp32
// cotangent of K4's output; wnk: the output-major weight pack; scratch:
// blocks x the activation slab in the compute type; partial:
// [blocks, num_weights + num_biases] fp32, zeroed; grads: the same count,
// weight gradients in the input-major pack's order, then the biases'.
// Returns a cudaError_t.
extern "C" int mlp_bwd_launch(const float* x, const float* c,
                              const float* dout, const void* wkn,
                              const void* wnk, const float* bias,
                              void* scratch, float* partial, float* grads,
                              int n, int blocks, int bf16, int depth,
                              int width, int skip, int feat, int cond,
                              int cond_width, int num_rgb, int num_sigma,
                              int pe, long long num_weights, void* stream) {
  Spec s;
  if (!fused_mlp::make_spec(&s, depth, width, skip, feat, cond, cond_width,
                            num_rgb, num_sigma, pe) ||
      s.num_weights != num_weights || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(s, x, c, dout, wkn, wnk, bias, scratch,
                                      partial, grads, n, blocks, st)
              : launch<float>(s, x, c, dout, wkn, wnk, bias, scratch, partial,
                              grads, n, blocks, st);
}
