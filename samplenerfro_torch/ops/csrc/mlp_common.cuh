// Shared by K4 (mlp_fwd.cu) and K5 (mlp_bwd.cu): the fused NerfMLP's
// geometry, the per-tile input featurization, a register-tiled product on
// CUDA cores, and the forward of one row tile at the rounding points of
// samplenerfro_tpu/ops/pallas/mlp_kernel.py:_forward_tile (195-216).
//
// T is the compute type, float or __nv_bfloat16. Weights and stored
// activations are T; every product accumulates in fp32 with fmaf, every
// bias is fp32 and added after the product, ReLU runs in fp32 and its
// result is then rounded to T (round to nearest even). A bf16 product is
// exact in fp32, so in bf16 the kernels differ from their plain versions
// (bf16 operands multiplied in fp32) only in the order of the sums.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fused_mlp {

constexpr int kRows = 64;      // rows of a tile
constexpr int kThreads = 256;  // 8 warps a block
constexpr int kTM = 8;         // rows of a warp's register tile
constexpr int kTN = 8;         // columns of a lane's register tile, 32 apart
constexpr int kMaxLayers = 24;
constexpr float kHalfPi = 1.57079632679489661923f;

// The layers in nn.Linear order: trunk 0..depth-1, sigma head depth,
// bottleneck depth+1, condition layer depth+2, rgb head depth+3. Layer l
// maps k[l] inputs to n[l] outputs; its weights sit at w_off[l] of a pack,
// [k][n] in the input-major pack (wkn) and [n][k] in the output-major one
// (wnk), its bias at b_off[l] of the fp32 bias pack.
struct Spec {
  int depth, width, skip, feat, cond, cond_width, num_rgb, num_sigma, pe;
  int k[kMaxLayers], n[kMaxLayers];
  long long w_off[kMaxLayers];
  int b_off[kMaxLayers];
  long long num_weights;
  int num_biases;
};

// Whether trunk layer i's output gets the input features appended.
__host__ __device__ inline bool skip_after(const Spec& s, int i) {
  return i > 0 && i % s.skip == 0;
}

// Fills a Spec; false for a geometry the kernels do not take (the
// wrapper checks the same before it launches).
inline bool make_spec(Spec* s, int depth, int width, int skip, int feat,
                      int cond, int cond_width, int num_rgb, int num_sigma,
                      int pe) {
  if (depth < 2 || depth + 4 > kMaxLayers || skip < 1 || width < 1 ||
      width > 256 || cond_width < 1 || cond_width > 256 || feat < 1 ||
      feat > 128 || cond < 1 || cond > 128 || num_rgb < 1 ||
      num_sigma < 1 || num_rgb + num_sigma > 8)
    return false;
  s->depth = depth;
  s->width = width;
  s->skip = skip;
  s->feat = feat;
  s->cond = cond;
  s->cond_width = cond_width;
  s->num_rgb = num_rgb;
  s->num_sigma = num_sigma;
  s->pe = pe;
  if (skip_after(*s, depth - 1)) return false;  // the heads see width inputs
  for (int i = 0; i < depth; ++i) {
    s->k[i] = i == 0 ? feat : (skip_after(*s, i - 1) ? width + feat : width);
    s->n[i] = width;
  }
  s->k[depth] = width;             s->n[depth] = num_sigma;
  s->k[depth + 1] = width;         s->n[depth + 1] = width;
  s->k[depth + 2] = width + cond;  s->n[depth + 2] = cond_width;
  s->k[depth + 3] = cond_width;    s->n[depth + 3] = num_rgb;
  long long w = 0;
  int b = 0;
  for (int l = 0; l < depth + 4; ++l) {
    s->w_off[l] = w;
    s->b_off[l] = b;
    w += static_cast<long long>(s->k[l]) * s->n[l];
    b += s->n[l];
  }
  s->num_weights = w;
  s->num_biases = b;
  return true;
}

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ T round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 round_to<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One contraction segment of a product: X(r, j) = x[r * xr + j * xj],
// Y(j, c) = y[j * ly + c], for j < len.
template <typename T>
struct Seg {
  const T* x;
  int xr, xj;
  const T* y;
  int ly, len;
};

template <typename T>
__device__ __forceinline__ void accumulate(float (&acc)[kTM][kTN],
                                           const Seg<T>& s, int r0, int rows,
                                           int c0, int cols) {
  for (int j = 0; j < s.len; ++j) {
    float xv[kTM], yv[kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int r = r0 + i;
      xv[i] = r < rows ? load(s.x + r * s.xr + j * s.xj) : 0.0f;
    }
#pragma unroll
    for (int t = 0; t < kTN; ++t) {
      const int c = c0 + 32 * t;
      yv[t] = c < cols ? load(s.y + j * s.ly + c) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
#pragma unroll
      for (int t = 0; t < kTN; ++t) {
        acc[i][t] = __fmaf_rn(xv[i], yv[t], acc[i][t]);
      }
    }
  }
}

// epi(r, c, sum over both segments of sum_j X(r, j) Y(j, c)) for every
// r < rows, c < cols. A warp owns kTM rows and 32 * kTN columns at a time:
// row r0 + i, column c0 + 32 t with lanes on neighbouring columns, so the
// Y loads of a warp coalesce and its X loads are broadcasts. Each output
// is summed by one thread in a fixed order.
template <typename T, typename Epi>
__device__ void gemm(int rows, int cols, const Seg<T>& s0, const Seg<T>& s1,
                     Epi epi) {
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
    accumulate(acc, s0, r0, rows, c0, cols);
    accumulate(acc, s1, r0, rows, c0, cols);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
#pragma unroll
      for (int t = 0; t < kTN; ++t) {
        const int r = r0 + i, c = c0 + 32 * t;
        if (r < rows && c < cols) epi(r, c, acc[i][t]);
      }
    }
  }
}

// Column j of the non-legacy positional encoding of a 3-vector p at
// degrees 0..deg-1 (ops/math.pe_cols): [p, sin(xb), sin(xb + pi/2)] with
// xb = [p * 2^0, p * 2^1, ...], degree-major and xyz-minor. The precise
// sinf (no fast math); cos is sin of xb + pi/2 rounded in fp32, as the
// plain version computes it.
__device__ __forceinline__ float pe_col(const float* p, int deg, int j) {
  if (j < 3) return p[j];
  int k = j - 3;
  const bool shifted = k >= 3 * deg;
  if (shifted) k -= 3 * deg;
  const float xb = p[k % 3] * static_cast<float>(1 << (k / 3));
  return shifted ? sinf(xb + kHalfPi) : sinf(xb);
}

// The tile's inputs in T: features and condition as given, or (pe) the
// encodings of raw [n, 3] points and directions. Rows past n are zero.
template <typename T>
__device__ void load_tile(const Spec& s, const float* x, const float* c,
                          int row0, int n, T* x0s, T* conds) {
  const int pts_deg = (s.feat - 3) / 6, dirs_deg = (s.cond - 3) / 6;
  for (int e = threadIdx.x; e < kRows * s.feat; e += blockDim.x) {
    const int r = e / s.feat, j = e % s.feat;
    const long long row = row0 + r;
    float v = 0.0f;
    if (row < n) {
      v = s.pe ? pe_col(x + 3 * row, pts_deg, j) : x[row * s.feat + j];
    }
    x0s[e] = round_to<T>(v);
  }
  for (int e = threadIdx.x; e < kRows * s.cond; e += blockDim.x) {
    const int r = e / s.cond, j = e % s.cond;
    const long long row = row0 + r;
    float v = 0.0f;
    if (row < n) {
      v = s.pe ? pe_col(c + 3 * row, dirs_deg, j) : c[row * s.cond + j];
    }
    conds[e] = round_to<T>(v);
  }
}

// The tile through the whole MLP (inputs already in x0s/conds).
//   buf0, buf1: [kRows][max(width, cond_width)] ping-pong activations.
//   save (K5, or null): the stored activations, trunk layer i at
//     i * kRows * width, the bottleneck at depth * kRows * width, the
//     condition layer ([kRows][cond_width]) at (depth + 1) * kRows * width.
//   out (K4, or null): [n][num_rgb + num_sigma] fp32, raw rgb then sigma.
// Ends with a barrier: buf0/buf1 are free again on return.
template <typename T>
__device__ void forward_tile(const Spec& s, const T* wkn, const float* bias,
                             const T* x0s, const T* conds, T* buf0, T* buf1,
                             T* save, float* out, int row0, int n) {
  const int W = s.width, F = s.feat, C = s.cond, D = s.depth;
  const int CW = s.cond_width, R = s.num_rgb, S = s.num_sigma, O = R + S;
  const Seg<T> none = {nullptr, 0, 0, nullptr, 0, 0};
  T* bufs[2] = {buf0, buf1};
  for (int i = 0; i < D; ++i) {
    const T* w = wkn + s.w_off[i];
    const float* b = bias + s.b_off[i];
    T* o = bufs[i & 1];
    T* keep = save ? save + static_cast<long long>(i) * kRows * W : nullptr;
    Seg<T> s0 = {x0s, F, 1, w, W, F}, s1 = none;
    if (i > 0) {
      s0 = Seg<T>{bufs[(i - 1) & 1], W, 1, w, W, W};
      if (skip_after(s, i - 1)) {
        s1 = Seg<T>{x0s, F, 1, w + static_cast<long long>(W) * W, W, F};
      }
    }
    gemm(kRows, W, s0, s1, [&](int r, int c, float acc) {
      const T a = round_to<T>(fmaxf(acc + b[c], 0.0f));
      o[r * W + c] = a;
      if (keep) keep[r * W + c] = a;
    });
    __syncthreads();
  }

  // Heads: the sigma column stays fp32, the bottleneck (no activation) is
  // rounded to T before it meets the condition.
  const T* h = bufs[(D - 1) & 1];
  T* bn = bufs[D & 1];
  {
    const T* w = wkn + s.w_off[D + 1];
    const float* b = bias + s.b_off[D + 1];
    T* keep = save ? save + static_cast<long long>(D) * kRows * W : nullptr;
    gemm(kRows, W, Seg<T>{h, W, 1, w, W, W}, none,
         [&](int r, int c, float acc) {
           const T v = round_to<T>(acc + b[c]);
           bn[r * W + c] = v;
           if (keep) keep[r * W + c] = v;
         });
  }
  if (out) {
    const T* w = wkn + s.w_off[D];
    const float* b = bias + s.b_off[D];
    for (int e = threadIdx.x; e < kRows * S; e += blockDim.x) {
      const int r = e / S, c = e % S;
      if (row0 + r >= n) continue;
      float acc = 0.0f;
      for (int k = 0; k < W; ++k) {
        acc = __fmaf_rn(load(h + r * W + k), load(w + k * S + c), acc);
      }
      out[static_cast<long long>(row0 + r) * O + R + c] = acc + b[c];
    }
  }
  __syncthreads();

  // Condition layer on [bottleneck, condition], into h's buffer.
  T* ac = bufs[(D - 1) & 1];
  {
    const T* w = wkn + s.w_off[D + 2];
    const float* b = bias + s.b_off[D + 2];
    T* keep =
        save ? save + static_cast<long long>(D + 1) * kRows * W : nullptr;
    gemm(kRows, CW, Seg<T>{bn, W, 1, w, CW, W},
         Seg<T>{conds, C, 1, w + static_cast<long long>(W) * CW, CW, C},
         [&](int r, int c, float acc) {
           const T a = round_to<T>(fmaxf(acc + b[c], 0.0f));
           ac[r * CW + c] = a;
           if (keep) keep[r * CW + c] = a;
         });
  }
  __syncthreads();

  if (out) {
    const T* w = wkn + s.w_off[D + 3];
    const float* b = bias + s.b_off[D + 3];
    for (int e = threadIdx.x; e < kRows * R; e += blockDim.x) {
      const int r = e / R, c = e % R;
      if (row0 + r >= n) continue;
      float acc = 0.0f;
      for (int k = 0; k < CW; ++k) {
        acc = __fmaf_rn(load(ac + r * CW + k), load(w + k * R + c), acc);
      }
      out[static_cast<long long>(row0 + r) * O + c] = acc + b[c];
    }
  }
  __syncthreads();
}

}  // namespace fused_mlp
