// Shared by K4 (mlp_fwd.cu) and K5 (mlp_bwd.cu): the fused NerfMLP's
// geometry, the per-tile input featurization, the two product engines and
// the forward of one row tile at the rounding points of
// samplenerfro_tpu/ops/pallas/mlp_kernel.py:_forward_tile (195-216).
//
// T is the compute type, float or __nv_bfloat16. Weights and stored
// activations are T; every product sums in fp32, every bias is fp32 and
// added after the product, ReLU runs in fp32 and its result is then
// rounded to T (round to nearest even). A bf16 product is exact in fp32,
// so in bf16 the kernels differ from their plain versions (bf16 operands
// multiplied in fp32) only in the order of the sums and, on tensor cores,
// in how each k16 step's sum is rounded.
//
// The engines. A product is out[rows][N] = sum_j A(r, j) B(j, c) with A in
// shared memory and B streamed from device memory in k-slabs (kSlab rows
// x N columns) through a ring of kStages shared-memory buffers filled by
// cp.async: slab s + 2 is in flight while slab s is multiplied, and one
// fetch feeds all 8 warps of the block. An engine's N is 128 or 256; a
// wider layer (any multiple of 128 up to 1024) runs in column panels of
// 256 and 128 (panels), each panel its own product, every output still
// summed over the whole k in order. 8 warps split the output 2 (rows) x 4
// (columns). Every shared-memory row is padded by 16 bytes, so that
// consecutive rows start on different banks.
//  - Mma (bf16 on tensor cores): 32 MT rows; a warp owns 16 MT rows x N/4
//    columns as m16n8 fp32 accumulators; operands come through ldmatrix
//    (.trans for a [k][n] operand); each mma.sync m16n8k16 step starts from
//    zero and is added to the accumulators in fp32 (add_mma).
//  - Simt (fp32 on CUDA cores, of fp32 or bf16 operands): 8 RI rows; a
//    lane owns RI rows x N/32 columns, reads A 4 k at a time along its rows
//    and B 4 columns at a time (16 or 8 bytes), so each operand read feeds
//    RI x 4 or more fmaf. Each output is summed by one thread in k order,
//    the order of the plain version's products.
// A Policy picks the engine of each kernel's forward and backward products
// (K4: CUDA cores; K5: the forward on CUDA cores, its cotangents and
// weight gradients on tensor cores in bf16) and the rows of a tile: 128
// with tensor cores and 64 without, a quarter of that (wide) when a tile's
// activations at that width would not fit in shared memory. K5's weight
// gradients (A^T dZ, contracting over the rows of a super-tile) read A
// transposed, on the full-size engine whatever the tile.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "mlp_ptx.cuh"

// Trial switch for debug/mlp_rounding.py, 0 in use: 1 keeps each tensor-
// core product's running sum inside the tensor core (add_mma).
#ifndef FUSED_MLP_MMA_RUNNING_SUM
#define FUSED_MLP_MMA_RUNNING_SUM 0
#endif

namespace fused_mlp {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps a block
constexpr int kStages = 3;     // ring buffers of k-slabs
constexpr int kMaxLayers = 24;
constexpr int kInPad = 32;     // feature and condition widths padded to this
constexpr int kOutCols = 8;    // the cotangent's columns, padded
constexpr float kHalfPi = 1.57079632679489661923f;

// Elements of T in the 16 bytes that pad every shared-memory row.
template <typename T>
__host__ __device__ constexpr int pad() {
  return 16 / static_cast<int>(sizeof(T));
}

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// The layers in nn.Linear order: trunk 0..depth-1, sigma head depth,
// bottleneck depth+1, condition layer depth+2, rgb head depth+3. Layer l
// maps k[l] inputs to n[l] outputs; its weights sit at w_off[l] of the
// input-major pack (wkn, [k][n]) and at t_off[l] of the output-major pack
// (wnk, [n][kp], each row padded to kp[l] = k[l] rounded up to 16 with
// zeros so that every row starts on 16 bytes), its bias at b_off[l] of the
// fp32 bias pack. fp and cp are the feature and condition widths padded to
// kInPad.
struct Spec {
  int depth, width, skip, feat, cond, cond_width, num_rgb, num_sigma, pe;
  int fp, cp;
  bool wide;  // the tiles run at a quarter of the rows (see Policy)
  int k[kMaxLayers], n[kMaxLayers], kp[kMaxLayers];
  long long w_off[kMaxLayers], t_off[kMaxLayers];
  int b_off[kMaxLayers];
  long long num_weights, num_wnk;
  int num_biases;
};

// Whether trunk layer i's output gets the input features appended.
__host__ __device__ inline bool skip_after(const Spec& s, int i) {
  return i > 0 && i % s.skip == 0;
}

constexpr int kMaxWidth = 1024;  // widest layer the kernels take
constexpr size_t kMaxSmem = 232448;  // shared memory a block may use
constexpr int kMaxInputs = 128;  // feature and condition columns, each

// Fills a Spec; false for a geometry the kernels do not take (the
// wrapper checks the same before it launches).
inline bool make_spec(Spec* s, int depth, int width, int skip, int feat,
                      int cond, int cond_width, int num_rgb, int num_sigma,
                      int pe) {
  const bool width_ok = width % 128 == 0 && cond_width % 128 == 0 &&
                        width >= 128 && cond_width >= 128 &&
                        width <= kMaxWidth && cond_width <= kMaxWidth;
  if (depth < 2 || depth + 4 > kMaxLayers || skip < 1 || !width_ok ||
      feat < 1 || cond < 1 || feat > kMaxInputs || cond > kMaxInputs ||
      num_rgb < 1 || num_sigma < 1 || num_rgb + num_sigma > kOutCols)
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
  s->fp = round_up(feat, kInPad);
  s->cp = round_up(cond, kInPad);
  s->wide = width > 256 || cond_width > 256 || s->fp + s->cp > 128;
  if (skip_after(*s, depth - 1)) return false;  // the heads see width inputs
  for (int i = 0; i < depth; ++i) {
    s->k[i] = i == 0 ? feat : (skip_after(*s, i - 1) ? width + feat : width);
    s->n[i] = width;
  }
  s->k[depth] = width;             s->n[depth] = num_sigma;
  s->k[depth + 1] = width;         s->n[depth + 1] = width;
  s->k[depth + 2] = width + cond;  s->n[depth + 2] = cond_width;
  s->k[depth + 3] = cond_width;    s->n[depth + 3] = num_rgb;
  long long w = 0, t = 0;
  int b = 0;
  for (int l = 0; l < depth + 4; ++l) {
    s->kp[l] = round_up(s->k[l], 16);
    s->w_off[l] = w;
    s->t_off[l] = t;
    s->b_off[l] = b;
    w += static_cast<long long>(s->k[l]) * s->n[l];
    t += static_cast<long long>(s->kp[l]) * s->n[l];
    b += s->n[l];
  }
  s->num_weights = w;
  s->num_wnk = t;
  s->num_biases = b;
  return true;
}

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const bf16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ T round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 round_to<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// p[0], p[1] = v0, v1 rounded to T.
__device__ __forceinline__ void store_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store_pair(bf16* p, float v0, float v1) {
  __nv_bfloat162 v;
  v.x = __float2bfloat16_rn(v0);
  v.y = __float2bfloat16_rn(v1);
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}

__device__ __forceinline__ float lane_sum(float v, int from) {
  for (int m = from; m < 32; m <<= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// ---------------------------------------------------------------- engines

// d += one k16 step's product, summed by the tensor core from zero and
// added in fp32 (round to nearest): the tensor core aligns its addends to
// the largest and drops the bits below, so a running sum kept inside it
// would lose more than fp32 sums of the same products do.
__device__ __forceinline__ void add_mma(float (&d)[4], const unsigned (&a)[4],
                                        unsigned b0, unsigned b1) {
#if FUSED_MLP_MMA_RUNNING_SUM
  mma_bf16(d, a, b0, b1);
#else
  float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_bf16(t, a, b0, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
#endif
}

// bf16 on tensor cores: 32 MT output rows (2 warps of 16 MT), N columns (4
// warps of N/4).
template <int N, int MT = 4>
struct Mma {
  static constexpr int kRows = 32 * MT;  // output rows of the block
  static constexpr int kK = 16;          // k of one step
  static constexpr int kNT = N / 32;     // n8 tiles of a warp
  static constexpr int kSlots = 2 * kNT;
  float acc[MT][kNT][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
  }

  __device__ __forceinline__ void mul(const unsigned (&af)[MT][4],
                                      const bf16* b, int ldb) {
    const int lane = threadIdx.x & 31, wn = (threadIdx.x >> 5) & 3;
    const bf16* bp = b + ((lane & 7) + ((lane >> 3) & 1) * 8) * ldb +
                     wn * (N / 4) + (lane >> 4) * 8;
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np) {
      unsigned bf[4];
      ldsm_x4_t(bf, bp + np * 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        add_mma(acc[mt][2 * np], af[mt], bf[0], bf[1]);
        add_mma(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
      }
    }
  }

  // One k16 step: A [m][k] at a (its k column), B [k][n] at b (its k row).
  __device__ __forceinline__ void step(const bf16* a, int lda, const bf16* b,
                                       int ldb) {
    const int lane = threadIdx.x & 31, wm = threadIdx.x >> 7;
    unsigned af[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      ldsm_x4(af[mt], a + (wm * 16 * MT + mt * 16 + (lane & 15)) * lda +
                          (lane >> 4) * 8);
    }
    mul(af, b, ldb);
  }

  // As step with A stored transposed, [k][m].
  __device__ __forceinline__ void step_t(const bf16* a, int lda,
                                         const bf16* b, int ldb) {
    const int lane = threadIdx.x & 31, wm = threadIdx.x >> 7;
    unsigned af[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      ldsm_x4_t(af[mt], a + ((lane & 7) + ((lane >> 4) << 3)) * lda +
                            wm * 16 * MT + mt * 16 + ((lane >> 3) & 1) * 8);
    }
    mul(af, b, ldb);
  }

  // f(slot, row, column, v(row, column), v(row, column + 1)) for every
  // pair of outputs this thread holds; slot numbers the thread's columns.
  template <bool kTransposed, typename F>
  __device__ __forceinline__ void each(F f) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          f(2 * nt, wm * 16 * MT + mt * 16 + g + 8 * h,
            wn * (N / 4) + nt * 8 + 2 * t, acc[mt][nt][2 * h],
            acc[mt][nt][2 * h + 1]);
  }

  // cs[slot] summed over the warp's rows, into colbuf[wm][column].
  __device__ __forceinline__ static void colsums(float (&cs)[kSlots],
                                                 float* colbuf) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = warp >> 2, wn = warp & 3, t = lane & 3;
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const float v = lane_sum(cs[q], 4);
      if (lane < 4) {
        colbuf[wm * 256 + wn * (N / 4) + (q >> 1) * 8 + 2 * t + (q & 1)] = v;
      }
    }
  }
};

// Four consecutive values as fp32: one 16-byte load of float, one 8-byte
// load of bf16 (a bf16 is the high half of its fp32).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// fp32 sums on CUDA cores of S operands (float, or bf16 widened exactly):
// 8 RI output rows (2 warps of 4 RI), N columns (4 warps of N/4); lane
// (rg, cg) = (lane / 8, lane % 8) owns rows rg + 4i, i < RI (rg * 8 + i
// with A transposed, which takes RI = 8) and columns cg * 4 + 32 j + 0..3
// of its warp's span.
template <int N, typename S, int RI = 8>
struct Simt {
  static constexpr int kRows = 8 * RI;
  static constexpr int kK = 4;
  static constexpr int kTN = N / 32;
  static constexpr int kSlots = kTN;
  float acc[RI][kTN];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;
  }

  __device__ __forceinline__ void mul(const float (&av)[RI][4], const S* b,
                                      int ldb) {
    const int lane = threadIdx.x & 31, wn = (threadIdx.x >> 5) & 3;
    const S* bp = b + wn * (N / 4) + (lane & 7) * 4;
    float bv[4][kTN];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < kTN / 4; ++j) {
        const float4 v = load4(bp + kk * ldb + 32 * j);
        bv[kk][4 * j] = v.x;
        bv[kk][4 * j + 1] = v.y;
        bv[kk][4 * j + 2] = v.z;
        bv[kk][4 * j + 3] = v.w;
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j)
          acc[i][j] = __fmaf_rn(av[i][kk], bv[kk][j], acc[i][j]);
  }

  // Four k: A [m][k] at a (its first k column), B [k][n] at b.
  __device__ __forceinline__ void step(const S* a, int lda, const S* b,
                                       int ldb) {
    const int lane = threadIdx.x & 31, wm = threadIdx.x >> 7;
    const S* ap = a + (wm * 4 * RI + (lane >> 3)) * lda;
    float av[RI][4];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const float4 v = load4(ap + 4 * i * lda);
      av[i][0] = v.x;
      av[i][1] = v.y;
      av[i][2] = v.z;
      av[i][3] = v.w;
    }
    mul(av, b, ldb);
  }

  // As step with A stored transposed, [k][m].
  __device__ __forceinline__ void step_t(const S* a, int lda, const S* b,
                                         int ldb) {
    static_assert(RI == 8, "A transposed takes 8 rows a lane");
    const int lane = threadIdx.x & 31, wm = threadIdx.x >> 7;
    const S* ap = a + wm * 32 + (lane >> 3) * 8;
    float av[8][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 lo = load4(ap + kk * lda);
      const float4 hi = load4(ap + kk * lda + 4);
      av[0][kk] = lo.x;
      av[1][kk] = lo.y;
      av[2][kk] = lo.z;
      av[3][kk] = lo.w;
      av[4][kk] = hi.x;
      av[5][kk] = hi.y;
      av[6][kk] = hi.z;
      av[7][kk] = hi.w;
    }
    mul(av, b, ldb);
  }

  template <bool kTransposed, typename F>
  __device__ __forceinline__ void each(F f) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = warp >> 2, wn = warp & 3, rg = lane >> 3, cg = lane & 7;
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < kTN; j += 2)
        f(j, wm * 4 * RI + (kTransposed ? rg * 8 + i : rg + 4 * i),
          wn * (N / 4) + (j >> 2) * 32 + cg * 4 + (j & 3), acc[i][j],
          acc[i][j + 1]);
  }

  __device__ __forceinline__ static void colsums(float (&cs)[kSlots],
                                                 float* colbuf) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = warp >> 2, wn = warp & 3, cg = lane & 7;
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const float v = lane_sum(cs[q], 8);
      if (lane < 8) {
        colbuf[wm * 256 + wn * (N / 4) + (q >> 2) * 32 + cg * 4 + (q & 3)] =
            v;
      }
    }
  }
};

// How a kernel runs its products on T operands, on tensor cores (bf16
// only) or in fp32 on CUDA cores: Fwd for the forward's layers, Bwd for
// K5's cotangents, Grad for its weight gradients; the rows of a tile (a
// CUDA-core product of 64 rows runs once per 64 rows of a 128-row tile),
// a quarter of them when kWide, and the k-rows of a weight slab.
template <typename T, bool kTensorFwd, bool kTensorBwd = kTensorFwd,
          bool kWide = false>
struct Policy {
  static_assert(std::is_same<T, bf16>::value || !(kTensorFwd || kTensorBwd),
                "tensor-core products take bf16");
  using Elem = T;
  static constexpr int kRows =
      (kTensorFwd || kTensorBwd ? 128 : 64) / (kWide ? 4 : 1);
  static constexpr int kSlab = sizeof(T) == 4 ? 16 : 32;
  static constexpr int kSimtRI = (kRows < 64 ? kRows : 64) / 8;
  static constexpr int kMmaMT = kRows < 32 ? 1 : kRows / 32;
  template <int N>
  using Fwd = std::conditional_t<kTensorFwd, Mma<N, kMmaMT>,
                                 Simt<N, T, kSimtRI>>;
  template <int N>
  using Bwd = std::conditional_t<kTensorBwd, Mma<N, kMmaMT>,
                                 Simt<N, T, kSimtRI>>;
  template <int N>
  using Grad = std::conditional_t<kTensorBwd, Mma<N>, Simt<N, T>>;
};

// The column panels of an n-wide layer (n a multiple of 128): f(c0,
// std::integral_constant<int, N>) for panels of N = 256 columns from c0 =
// 0, and one of 128 when n is an odd multiple of 128.
template <typename F>
__device__ __forceinline__ void panels(int n, F f) {
  for (int c0 = 0; c0 < n; c0 += 256) {
    if (n - c0 >= 256) {
      f(c0, std::integral_constant<int, 256>{});
    } else {
      f(c0, std::integral_constant<int, 128>{});
    }
  }
}

// The widest panel of an n-wide layer.
__host__ __device__ inline int panel_width(int n) { return n < 256 ? n : 256; }

// The k-slab pipeline: load(slab, stage) issues the cp.async copies of a
// slab, step(slab, stage) multiplies one. kStages - 1 slabs are in flight
// ahead of the one multiplied. Ends with the ring free and every thread
// past a barrier.
template <typename Load, typename Step>
__device__ __forceinline__ void pipeline(int count, Load load, Step step) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < count) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < count; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = s + kStages - 1;
    if (next < count) load(next, next % kStages);
    cp_async_commit();
    step(s, s % kStages);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// One operand segment in shared memory: A(r, j) = a[r * ld + j], j < k;
// columns up to k rounded to the slab are readable and zero past k.
template <typename T>
struct ASeg {
  const T* a;
  int ld, k;
};

// e.acc += [A0 | A1] x B, B's rows [0, s0.k + s1.k) being rows of a
// [*][ldw] matrix at w in device memory (A1's rows follow A0's), its
// columns [0, N).
template <typename P, int N, typename Eng, typename T = typename P::Elem>
__device__ __forceinline__ void weight_product(Eng& e, const ASeg<T>& s0,
                                               const ASeg<T>& s1, const T* w,
                                               int ldw, T* ring) {
  constexpr int KS = P::kSlab, E = pad<T>(), LDR = N + E, CPR = N / E;
  const int n0 = (s0.k + KS - 1) / KS, n1 = (s1.k + KS - 1) / KS;
  pipeline(
      n0 + n1,
      [&](int sl, int st) {
        T* stage = ring + st * KS * LDR;
        for (int x = threadIdx.x; x < KS * CPR; x += kThreads) {
          const int i = x / CPR, q = x % CPR;
          int row;
          bool ok;
          if (sl < n0) {
            row = sl * KS + i;
            ok = row < s0.k;
          } else {
            const int j = (sl - n0) * KS + i;
            row = s0.k + j;
            ok = j < s1.k;
          }
          cp_async16(stage + i * LDR + q * E,
                     ok ? w + static_cast<long long>(row) * ldw + q * E : w,
                     ok ? 16 : 0);
        }
      },
      [&](int sl, int st) {
        const bool first = sl < n0;
        const ASeg<T>& sg = first ? s0 : s1;
        const T* a = sg.a + (first ? sl : sl - n0) * KS;
        const T* stage = ring + st * KS * LDR;
#pragma unroll
        for (int kk = 0; kk < KS; kk += Eng::kK) {
          e.step(a + kk, sg.ld, stage + kk * LDR, LDR);
        }
      });
}

// ------------------------------------------------------------ the forward

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

// A tile's shared-memory buffers: two activation buffers that alternate
// between a layer's input and output ([rows][ld_act]), the inputs
// ([rows][ld_x0], [rows][ld_c], zero past feat and cond) and the ring.
template <typename T>
struct TileBufs {
  T* act[2];
  T* x0;
  T* cond;
  T* ring;
  int ld_act, ld_x0, ld_c;
};

// Shared memory of the forward's buffers, in bytes, and their placement
// from base.
template <typename Pol, typename T = typename Pol::Elem>
__host__ __device__ inline size_t tile_bytes(const Spec& s) {
  constexpr int R = Pol::kRows, P = pad<T>(), KS = Pol::kSlab;
  const int maxw = s.width > s.cond_width ? s.width : s.cond_width;
  return sizeof(T) * (static_cast<size_t>(2) * R * (maxw + P) +
                      static_cast<size_t>(R) * (s.fp + P + s.cp + P) +
                      static_cast<size_t>(kStages) * KS *
                          (panel_width(maxw) + P));
}

template <typename Pol, typename T = typename Pol::Elem>
__device__ inline TileBufs<T> tile_bufs(const Spec& s, unsigned char* base) {
  constexpr int R = Pol::kRows, P = pad<T>();
  const int maxw = s.width > s.cond_width ? s.width : s.cond_width;
  TileBufs<T> t;
  t.ld_act = maxw + P;
  t.ld_x0 = s.fp + P;
  t.ld_c = s.cp + P;
  t.act[0] = reinterpret_cast<T*>(base);
  t.act[1] = t.act[0] + R * t.ld_act;
  t.x0 = t.act[1] + R * t.ld_act;
  t.cond = t.x0 + R * t.ld_x0;
  t.ring = t.cond + R * t.ld_c;
  return t;
}

// The tile's inputs in T: features and condition as given, or (pe) the
// encodings of raw [n, 3] points and directions. Rows at or past end, and
// columns past feat / cond up to fp / cp, are zero.
template <typename P, typename T = typename P::Elem>
__device__ void load_tile(const Spec& s, const float* x, const float* c,
                          long long row0, long long end,
                          const TileBufs<T>& t) {
  constexpr int R = P::kRows;
  const int pts_deg = (s.feat - 3) / 6, dirs_deg = (s.cond - 3) / 6;
  for (int e = threadIdx.x; e < R * s.fp; e += kThreads) {
    const int r = e / s.fp, j = e % s.fp;
    const long long row = row0 + r;
    float v = 0.0f;
    if (row < end && j < s.feat) {
      v = s.pe ? pe_col(x + 3 * row, pts_deg, j) : x[row * s.feat + j];
    }
    t.x0[r * t.ld_x0 + j] = round_to<T>(v);
  }
  for (int e = threadIdx.x; e < R * s.cp; e += kThreads) {
    const int r = e / s.cp, j = e % s.cp;
    const long long row = row0 + r;
    float v = 0.0f;
    if (row < end && j < s.cond) {
      v = s.pe ? pe_col(c + 3 * row, dirs_deg, j) : c[row * s.cond + j];
    }
    t.cond[r * t.ld_c + j] = round_to<T>(v);
  }
}

// One layer of the forward: o = round(act(sum + bias)), act ReLU or none;
// w is the layer's input-major [k][n] block.
template <typename P, typename T = typename P::Elem>
__device__ __forceinline__ void dense(const ASeg<T>& s0, const ASeg<T>& s1,
                                      const T* w, int n, const float* b,
                                      bool relu, T* o, int ldo, T* ring) {
  panels(n, [&](int c0, auto width) {
    constexpr int N = decltype(width)::value;
    using E = typename P::template Fwd<N>;
    for (int h = 0; h < P::kRows / E::kRows; ++h) {
      const int r0 = h * E::kRows;
      E e;
      e.zero();
      weight_product<P, N>(e, ASeg<T>{s0.a + r0 * s0.ld, s0.ld, s0.k},
                           ASeg<T>{s1.a + r0 * s1.ld, s1.ld, s1.k}, w + c0,
                           n, ring);
      e.template each<false>([&](int, int r, int c, float v0, float v1) {
        c += c0;
        v0 += b[c];
        v1 += b[c + 1];
        if (relu) {
          v0 = fmaxf(v0, 0.0f);
          v1 = fmaxf(v1, 0.0f);
        }
        store_pair(o + (r0 + r) * ldo + c, v0, v1);
      });
    }
  });
  __syncthreads();
}

// The tile through the whole MLP (inputs already in t.x0 / t.cond).
//   save(id, buf, width) (K5) is called once each stored activation is
//     complete in shared memory: id i < depth for trunk layer i, depth for
//     the bottleneck, depth + 1 for the condition layer.
//   out (K4, or null): [n][num_rgb + num_sigma] fp32, raw rgb then sigma,
//     rows row0 + r < end.
// On return the condition layer's activation is in t.act[(depth - 1) & 1]
// and everything else of the forward is free.
template <typename P, typename Save, typename T = typename P::Elem>
__device__ void forward_tile(const Spec& s, const T* wkn, const float* bias,
                             const TileBufs<T>& t, float* out, long long row0,
                             long long end, Save save) {
  constexpr int RT = P::kRows;
  const int W = s.width, D = s.depth, CW = s.cond_width;
  const int R = s.num_rgb, S = s.num_sigma, O = R + S;
  const ASeg<T> none = {nullptr, 0, 0};
  const ASeg<T> x0 = {t.x0, t.ld_x0, s.feat};
  for (int i = 0; i < D; ++i) {
    const ASeg<T> s0 = i == 0 ? x0 : ASeg<T>{t.act[(i - 1) & 1], t.ld_act, W};
    const ASeg<T> s1 = i > 0 && skip_after(s, i - 1) ? x0 : none;
    dense<P>(s0, s1, wkn + s.w_off[i], W, bias + s.b_off[i], true,
          t.act[i & 1], t.ld_act, t.ring);
    save(i, t.act[i & 1], W);
  }

  // Heads: the sigma column stays fp32, the bottleneck (no activation) is
  // rounded to T before it meets the condition.
  const T* h = t.act[(D - 1) & 1];
  T* bn = t.act[D & 1];
  dense<P>(ASeg<T>{h, t.ld_act, W}, none, wkn + s.w_off[D + 1], W,
        bias + s.b_off[D + 1], false, bn, t.ld_act, t.ring);
  save(D, bn, W);
  if (out) {
    const T* w = wkn + s.w_off[D];
    const float* b = bias + s.b_off[D];
    for (int e = threadIdx.x; e < RT * S; e += kThreads) {
      const int r = e / S, c = e % S;
      if (row0 + r >= end) continue;
      float acc = 0.0f;
      for (int k = 0; k < W; ++k) {
        acc = __fmaf_rn(load(h + r * t.ld_act + k), load(w + k * S + c), acc);
      }
      out[(row0 + r) * O + R + c] = acc + b[c];
    }
    __syncthreads();
  }

  // Condition layer on [bottleneck, condition], into h's buffer.
  T* ac = t.act[(D - 1) & 1];
  dense<P>(ASeg<T>{bn, t.ld_act, W}, ASeg<T>{t.cond, t.ld_c, s.cond},
        wkn + s.w_off[D + 2], CW, bias + s.b_off[D + 2], true, ac, t.ld_act,
        t.ring);
  save(D + 1, ac, CW);

  if (out) {
    const T* w = wkn + s.w_off[D + 3];
    const float* b = bias + s.b_off[D + 3];
    for (int e = threadIdx.x; e < RT * R; e += kThreads) {
      const int r = e / R, c = e % R;
      if (row0 + r >= end) continue;
      float acc = 0.0f;
      for (int k = 0; k < CW; ++k) {
        acc = __fmaf_rn(load(ac + r * t.ld_act + k), load(w + k * R + c),
                        acc);
      }
      out[(row0 + r) * O + c] = acc + b[c];
    }
  }
}

}  // namespace fused_mlp
