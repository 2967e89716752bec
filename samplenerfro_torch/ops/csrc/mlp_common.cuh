// Shared by K4 (mlp_fwd.cu) and K5 (mlp_bwd.cu): the fused NerfMLP's
// geometry, the per-tile input featurization, the product engines and the
// forward of one row tile at the rounding points of
// samplenerfro_tpu/ops/pallas/mlp_kernel.py:_forward_tile (195-216).
//
// T is the compute type, float or __nv_bfloat16. Weights and stored
// activations are T; every product sums in fp32, every bias is fp32 and
// added after the product, ReLU runs in fp32 and its result is then
// rounded to T (round to nearest even). A bf16 product is exact in fp32,
// so in bf16 the kernels differ from their plain versions (bf16 operands
// multiplied in fp32) only in the order of the sums and in how the tensor
// core rounds them.
//
// The engines. A product is out[rows][N] = sum_j A(r, j) B(j, c) with A in
// shared memory. Every shared-memory row of A is padded by 16 bytes, so
// that consecutive rows start on different banks.
//  - The warpgroup engine (bf16 tiles of 128 rows that are not wide: the
//    forward's layers, K5's cotangents and weight gradients): each of two
//    warpgroups takes 64 rows and a panel of kSlabN columns with wgmma
//    m64n128k16, A from registers (ldmatrix), the fp32 sum kept in the
//    accumulator over the whole k. The layers' and cotangents' weights
//    come as slabs of the slab pack (kSlabK k-rows, K-major, in wgmma's
//    128-byte swizzle), copied by the copy engine (TMA) into a ring that
//    a producer warpgroup keeps full under mbarriers (Feed); the weight
//    gradients read their operands from K5's scratch through cp.async
//    (mlp_bwd.cu: wg_grad_product).
//  - Mma (bf16 wide tiles, and the weight gradients beside them): mma.sync
//    m16n8k16 on a 32 MT-row output (2 x 4 warps), each k16 step summed
//    from zero and added in fp32 (add_mma); B streamed from device memory
//    in k-slabs (kSlab rows x N columns) through a ring of kStages buffers
//    filled by cp.async, in column panels of 256 and 128.
//  - Simt (fp32 on CUDA cores): 8 RI rows; a lane owns RI rows x N/32
//    columns, reads A 4 k at a time along its rows and B 4 columns at a
//    time, so each operand read feeds RI x 4 or more fmaf. Each output is
//    summed by one thread in k order, the order of the plain version's
//    products. Same ring and panels as Mma.
// A Policy picks the engine and the rows of a tile: 128 in bf16, 64 in
// fp32, a quarter of that (wide) when a tile's activations at that width
// would not fit in shared memory. In bf16 the forward's outputs whose sum
// lands near a bf16 rounding midpoint are recomputed in the plain
// version's k order (near_midpoint, plain_fixups). K4's forward and K5's
// recompute run the same Policy through the same forward_tile, so K5
// differentiates K4's activations bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "mlp_ptx.cuh"

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

// The warpgroup engine's weight slabs: kSlabK k-rows (128 bytes of bf16)
// of kSlabN output columns, K-major and in the 128-byte swizzle
// (desc_sw128): element (c, k) at c * kSlabK + ((k / 8) ^ (c % 8)) * 8 +
// k % 8. The slab pack (mlp_kernel.slab_pack) holds a tile's slabs in the
// order the kernels take them, so the feed copies slab i of the pack into
// the ring as one piece: per layer of the forward (trunk, bottleneck,
// condition layer) its panels of kSlabN outputs, per panel its k-slabs
// over the layer's inputs (zero past them); then, for K5, the cotangent
// products' slabs (the condition layer's, the bottleneck's, the trunk's
// last to second), whose outputs are the first width inputs of the layer
// and whose k its outputs.
constexpr int kSlabK = 64, kSlabN = 128;
constexpr int kSlabBytes = kSlabK * kSlabN * 2;
constexpr int kMaxFeedStages = 4;
constexpr int kConsumerWarps = kThreads / 32;

// The slabs of one product of k inputs and n outputs.
__host__ __device__ inline int product_slabs(int k, int n) {
  return (k + kSlabK - 1) / kSlabK * (n / kSlabN);
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
  int fwd_slabs, cot_slabs;  // the slab pack's (see kSlabN)
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
  s->fwd_slabs = product_slabs(s->k[depth + 1], width) +
                 product_slabs(s->k[depth + 2], cond_width);
  s->cot_slabs = product_slabs(cond_width, width) +
                 product_slabs(width, width);
  for (int i = 0; i < depth; ++i) {
    s->fwd_slabs += product_slabs(s->k[i], width);
    if (i > 0) s->cot_slabs += product_slabs(width, width);
  }
  return true;
}

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const bf16* p) {
  return __bfloat162float(*p);
}
// The same from device memory through the read-only cache.
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg(const bf16* p) {
  return __bfloat162float(__ldg(p));
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
// loses more than fp32 sums of the same products do (debug/mlp_rounding,
// PERF.md). The mma.sync engine sums so, which keeps the wide geometries'
// bf16 forward inside K4's tolerance; wgmma keeps its running sum.
__device__ __forceinline__ void add_mma(float (&d)[4], const unsigned (&a)[4],
                                        unsigned b0, unsigned b1) {
  float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_bf16(t, a, b0, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

// bf16 on tensor cores (mma.sync): 32 MT output rows (2 warps of 16 MT), N
// columns (4 warps of N/4).
template <int N, int MT = 4>
struct Mma {
  static constexpr int kRows = 32 * MT;  // output rows of the block
  static constexpr int kK = 16;          // k of one step
  static constexpr int kNT = N / 32;     // n8 tiles of a warp
  static constexpr int kSlots = 2 * kNT;
  static constexpr int kPairs = MT * kNT * 2;  // output pairs of a thread
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

  // The row and column of the q-th pair each() passes this thread.
  __device__ __forceinline__ static void pair_pos(int q, int& r, int& c) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
    const int nt = (q >> 1) % kNT, mt = (q >> 1) / kNT;
    r = wm * 16 * MT + mt * 16 + g + 8 * (q & 1);
    c = wn * (N / 4) + nt * 8 + 2 * t;
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

// fp32 sums on CUDA cores of S = float operands:
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

// How a kernel runs its products on T operands: every bf16 product on
// tensor cores, fp32 ones on CUDA cores. kWarpgroup (bf16 tiles that are
// not wide): the forward's layers and K5's cotangents are warpgroup
// products (wgmma, wg_product) on weight slabs the copy engine feeds
// (Feed); otherwise Fwd is the engine of the forward's layers and of K5's
// cotangents. Grad is the engine of K5's weight gradients. kRows: the
// rows of a tile (a CUDA-core product of 64 rows runs once per 64 rows of
// a larger tile), a quarter of them when kWide; kSlab: the k-rows of a
// cp.async weight slab.
template <typename T, bool kWide = false>
struct Policy {
  using Elem = T;
  static constexpr bool kTensor = std::is_same<T, bf16>::value;
  static constexpr bool kWarpgroup = kTensor && !kWide;
  static constexpr int kRows = (kTensor ? 128 : 64) / (kWide ? 4 : 1);
  static constexpr int kSlab = sizeof(T) == 4 ? 16 : 32;
  static constexpr int kSimtRI = (kRows < 64 ? kRows : 64) / 8;
  static constexpr int kMmaMT = kRows < 32 ? 1 : kRows / 32;
  template <int N>
  using Fwd =
      std::conditional_t<kTensor, Mma<N, kMmaMT>, Simt<N, T, kSimtRI>>;
  template <int N>
  using Grad = std::conditional_t<kTensor, Mma<N>, Simt<N, T>>;
};

// One operand segment in shared memory: A(r, j) = a[r * ld + j], j < k;
// columns up to k rounded to the slab are readable and zero past k.
template <typename T>
struct ASeg {
  const T* a;
  int ld, k;
};

// ------------------------------------------------- the warpgroup engine

// The feed: a ring of `stages` slab buffers in shared memory, each with a
// full mbarrier (the copy engine's bytes) and an empty one (every consumer
// thread arrives once its warpgroup's products have read the slab). A
// producer warp beside the kThreads consumer threads issues the copies
// (feed_produce), so no consumer branches around its wgmma; the block
// takes `total` slabs, slab i being pack slab i % per_tile. Every consumer
// thread steps through the ring alike.
struct Feed {
  unsigned char* ring;
  unsigned long long* full;
  unsigned long long* empty;
  const unsigned char* src;
  int stages, per_tile;
  long long total;
  int stage;        // the ring buffer of the next slab taken
  unsigned phase;   // the parity of its fill
};

// Threads of a block: the consumers, and with a feed the producer's
// warpgroup (one thread of it issues the copies; the warpgroup hands its
// registers to the consumers, see feed_split).
template <typename P>
__host__ __device__ constexpr int block_threads() {
  return P::kWarpgroup ? kThreads + 128 : kThreads;
}

// The consumers' barrier (named barrier 1: the producer warp never joins).
__device__ __forceinline__ void tile_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// Sets the feed up (every thread of the block, before any other use).
__device__ __forceinline__ void feed_init(Feed& f, unsigned char* ring,
                                          unsigned long long* bars,
                                          int stages, const void* src,
                                          int per_tile, long long total) {
  f.ring = ring;
  f.full = bars;
  f.empty = bars + stages;
  f.src = static_cast<const unsigned char*>(src);
  f.stages = stages;
  f.per_tile = per_tile;
  f.total = total;
  f.stage = 0;
  f.phase = 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&f.full[i], 1);
      mbar_init(&f.empty[i], kThreads);
    }
    fence_mbar_init();
  }
  __syncthreads();
}

// The producer warp's work: every slab the block takes, in order, each
// into the buffer of the slab `stages` before it once the consumers have
// released that one.
__device__ __forceinline__ void feed_produce(const Feed& f) {
  if (threadIdx.x != kThreads) return;
  int st = 0, slab = 0;
  unsigned phase = 0;
  for (long long i = 0; i < f.total; ++i) {
    if (i >= f.stages) mbar_wait(&f.empty[st], phase ^ 1u);
    mbar_expect_tx(&f.full[st], kSlabBytes);
    bulk_copy(f.ring + st * kSlabBytes,
              f.src + static_cast<size_t>(slab) * kSlabBytes, kSlabBytes,
              &f.full[st]);
    if (++slab == f.per_tile) slab = 0;
    if (++st == f.stages) {
      st = 0;
      phase ^= 1u;
    }
  }
}

// After feed_init: the producer's warpgroup lowers its registers to 40 and
// issues the feed, the consumers raise theirs to 232 (2 x 128 x 232 + 128
// x 40 of the SM's 65,536). Returns whether this thread is a consumer.
__device__ __forceinline__ bool feed_split(const Feed& f) {
  if (threadIdx.x >= kThreads) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    feed_produce(f);
    return false;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  return true;
}

// The next slab, once it is in shared memory.
__device__ __forceinline__ const unsigned char* feed_take(const Feed& f) {
  mbar_wait(&f.full[f.stage], f.phase);
  return f.ring + f.stage * kSlabBytes;
}

// This thread is done with the slab feed_take gave it.
__device__ __forceinline__ void feed_release(Feed& f) {
  mbar_arrive(&f.empty[f.stage]);
  if (++f.stage == f.stages) {
    f.stage = 0;
    f.phase ^= 1u;
  }
}

// The first row of this warp's 16 in a 128-row tile: warpgroup w / 4
// takes rows 64 (w / 4) .., its warp w % 4 the 16 from 16 (w % 4).
__device__ __forceinline__ int wg_row0() { return 16 * (threadIdx.x >> 5); }

// d += [A0 | A1] B for the warpgroup's 64 rows and one panel of kSlabN
// columns: A0's k0 and A1's k1 columns (each read to k rounded up to 16,
// zero past k) in shared memory, row-major, B the next slabs of the feed
// (ceil((k0 + k1) / kSlabK) of them, k0 a multiple of kSlabK when there
// is an A1). Each k16 step's A fragment comes through ldmatrix; the steps
// run in k order, A0's then A1's, the sum kept in d.
__device__ __forceinline__ void wg_product(Feed& f, float (&d)[64],
                                           const ASeg<bf16>& s0,
                                           const ASeg<bf16>& s1) {
  const int n0 = (s0.k + 15) / 16, steps = n0 + (s1.k + 15) / 16;
  const int lane = threadIdx.x & 31;
  const int r = wg_row0() + (lane & 15), half = (lane >> 4) * 8;
  for (int g0 = 0; g0 < steps; g0 += 4) {
    const unsigned char* stage = feed_take(f);
    const int count = steps - g0 < 4 ? steps - g0 : 4;
    // Steps past the product's k (a slab's tail, zero in B) multiply
    // zeros, so that every slab issues its four steps unconditionally.
    unsigned a[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int g = g0 + (j < count ? j : 0);
      const bool first = g < n0;
      const bf16* base = first ? s0.a : s1.a;
      const int ld = first ? s0.ld : s1.ld;
      ldsm_x4(a[j], base + r * ld + 16 * (first ? g : g - n0) + half);
      const unsigned keep = j < count ? ~0u : 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e) a[j][e] &= keep;
    }
    wg_pin(d);
    wg_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wgmma_n128(d, a[j], desc_sw128(stage + 32 * j));
    }
    wg_commit();
    wg_wait<0>();
    wg_pin(d);
    feed_release(f);
  }
}

// f(pair, row, column, v(row, column), v(row, column + 1)) for the 32
// pairs of d this thread holds: pair 2 i + h is n8 tile i's in row half h
// (row in the tile, column 8 i + 2 (lane % 4) in the panel).
template <typename F>
__device__ __forceinline__ void wg_each(const float (&d)[64], F f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = wg_row0();
#pragma unroll
  for (int i = 0; i < kSlabN / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      f(2 * i + h, row0 + g + 8 * h, 8 * i + 2 * t, d[4 * i + 2 * h],
        d[4 * i + 2 * h + 1]);
}

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
    tile_sync();
    const int next = s + kStages - 1;
    if (next < count) load(next, next % kStages);
    cp_async_commit();
    step(s, s % kStages);
  }
  cp_async_wait<0>();
  tile_sync();
}

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
// ([rows][ld_x0], [rows][ld_c], zero past feat and cond) and the ring of
// weight slabs: cp.async's, or with the warpgroup engine the feed's
// (stages slabs, 1024-byte aligned, and its 2 x stages mbarriers).
template <typename T>
struct TileBufs {
  T* act[2];
  T* x0;
  T* cond;
  T* ring;
  unsigned long long* bars;
  int ld_act, ld_x0, ld_c;
};

// The feed ring's bytes with its mbarriers and its alignment.
__host__ __device__ inline size_t feed_bytes(int stages) {
  return 1024 + static_cast<size_t>(stages) * kSlabBytes + 128;
}

// Shared memory of the forward's buffers, in bytes, and their placement
// from base; stages: the feed's slabs (warpgroup engine only).
template <typename Pol, typename T = typename Pol::Elem>
__host__ __device__ inline size_t tile_bytes(const Spec& s, int stages = 0) {
  constexpr int R = Pol::kRows, P = pad<T>(), KS = Pol::kSlab;
  const int maxw = s.width > s.cond_width ? s.width : s.cond_width;
  const size_t bufs = sizeof(T) * (static_cast<size_t>(2) * R * (maxw + P) +
                                   static_cast<size_t>(R) *
                                       (s.fp + P + s.cp + P));
  if (Pol::kWarpgroup) return feed_bytes(stages) + bufs;
  return bufs + sizeof(T) * static_cast<size_t>(kStages) * KS *
                    (panel_width(maxw) + P);
}

template <typename Pol, typename T = typename Pol::Elem>
__device__ inline TileBufs<T> tile_bufs(const Spec& s, unsigned char* base,
                                        int stages = 0) {
  constexpr int R = Pol::kRows, P = pad<T>();
  const int maxw = s.width > s.cond_width ? s.width : s.cond_width;
  TileBufs<T> t;
  t.ld_act = maxw + P;
  t.ld_x0 = s.fp + P;
  t.ld_c = s.cp + P;
  t.bars = nullptr;
  if (Pol::kWarpgroup) {
    unsigned char* ring = base + ((1024 - smem_addr(base) % 1024) % 1024);
    t.ring = reinterpret_cast<T*>(ring);
    t.bars = reinterpret_cast<unsigned long long*>(
        ring + static_cast<size_t>(stages) * kSlabBytes);
    t.act[0] = reinterpret_cast<T*>(base + feed_bytes(stages));
  } else {
    t.act[0] = reinterpret_cast<T*>(base);
  }
  t.act[1] = t.act[0] + R * t.ld_act;
  t.x0 = t.act[1] + R * t.ld_act;
  t.cond = t.x0 + R * t.ld_x0;
  if (!Pol::kWarpgroup) t.ring = t.cond + R * t.ld_c;
  return t;
}

// dst[r][j] = round(input column j of row row0 + r) for R rows and wp
// columns: [n, k] values as given (deg < 0) or the encodings of raw
// [n, 3] vectors at deg degrees; zero past k and at rows past end. Each
// thread's loads go out 8 at a time, before their stores.
template <int R, typename T>
__device__ __forceinline__ void load_cols(const float* src, int k, int wp,
                                          int deg, long long row0,
                                          long long end, T* dst, int ld) {
  constexpr int U = 8;
  for (int e0 = threadIdx.x; e0 < R * wp; e0 += U * kThreads) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * kThreads, r = e / wp, j = e % wp;
      const long long row = row0 + r;
      v[u] = 0.0f;
      if (e < R * wp && row < end && j < k) {
        v[u] = deg >= 0 ? pe_col(src + 3 * row, deg, j)
                        : ldg(src + row * k + j);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * kThreads;
      if (e < R * wp) dst[(e / wp) * ld + e % wp] = round_to<T>(v[u]);
    }
  }
}

// The tile's inputs in T: features and condition as given, or (pe) the
// encodings of raw [n, 3] points and directions. Rows at or past end, and
// columns past feat / cond up to fp / cp, are zero.
template <typename P, typename T = typename P::Elem>
__device__ void load_tile(const Spec& s, const float* x, const float* c,
                          long long row0, long long end,
                          const TileBufs<T>& t) {
  constexpr int R = P::kRows;
  load_cols<R>(x, s.feat, s.fp, s.pe ? (s.feat - 3) / 6 : -1, row0, end,
               t.x0, t.ld_x0);
  load_cols<R>(c, s.cond, s.cp, s.pe ? (s.cond - 3) / 6 : -1, row0, end,
               t.cond, t.ld_c);
}

// The tensor core sums a layer's products in another order than the plain
// version's k-order fp32 chain, and a sum that lands near a bf16 rounding
// midpoint (or near 0, a ReLU mask) may round to the other neighbour: a
// flip that every later layer carries. So in bf16 the forward flags such
// outputs (within kNearUlps fp32 ulps of a midpoint, about 1 in 2,000, or
// |pre-activation| < kNearZero) and recomputes each in the plain version's
// order on CUDA cores; the rest round alike whatever the order. K5's
// recompute runs the same code, so K4's activations stay its own bit for
// bit. 16 ulps: K4's mean error at the ship's train call 1e-6 (1.1e-5
// without), its wide geometries' well inside K4's tolerance (debug/
// mlp_rounding, PERF.md).
constexpr unsigned kNearUlps = 16;
constexpr float kNearZero = 1.0f / (1 << 18);

__device__ __forceinline__ bool near_midpoint(float u, float y) {
  // frac(y) in [0x8000 - kNearUlps, 0x8000 + kNearUlps], or |u| small.
  return ((__float_as_uint(y) + (kNearUlps - 0x8000u)) & 0xffffu) <=
             2 * kNearUlps ||
         (__float_as_uint(u) & 0x7fffffffu) < __float_as_uint(kNearZero);
}

// acc + sum_j a[j] w[j] over `chunks` chunks of 8 bf16 in order (a in
// shared memory, w in device memory, both 16-byte aligned), 4 chunks of
// each loaded at a time.
__device__ __forceinline__ float dot_chunks(float acc, const bf16* a,
                                            const bf16* w, int chunks) {
  const uint4* av = reinterpret_cast<const uint4*>(a);
  const uint4* wv = reinterpret_cast<const uint4*>(w);
  for (int q0 = 0; q0 < chunks; q0 += 4) {
    uint4 x[4], y[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (q0 + u < chunks) {
        x[u] = av[q0 + u];
        y[u] = __ldg(wv + q0 + u);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (q0 + u < chunks) {
        const unsigned xs[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
        const unsigned ys[4] = {y[u].x, y[u].y, y[u].z, y[u].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc = __fmaf_rn(__uint_as_float(xs[e] << 16),
                          __uint_as_float(ys[e] << 16), acc);
          acc = __fmaf_rn(__uint_as_float(xs[e] & 0xffff0000u),
                          __uint_as_float(ys[e] & 0xffff0000u), acc);
        }
      }
    }
  }
  return acc;
}

// Output row r's value as the plain version computes it: the fp32 sum over
// [A0 | A1]'s row in k order (each bf16 product exact; the zeros past each
// segment's k add nothing), wrow the output's row of the output-major
// pack, plus the bias, then the activation. Out of line: it runs for few
// outputs, and inlined it would crowd the products' registers.
__device__ __noinline__ float plain_output(const bf16* a0, int k0,
                                           const bf16* a1, int k1,
                                           const bf16* wrow, float bias,
                                           bool relu) {
  float acc = dot_chunks(0.0f, a0, wrow, (k0 + 7) / 8);
  if (k1 > 0) acc = dot_chunks(acc, a1, wrow + k0, (k1 + 7) / 8);
  const float v = acc + bias;
  return relu ? fmaxf(v, 0.0f) : v;
}

// Recomputes the outputs `flags` marks (bit 2 q + e: element e of this
// thread's pair q, at pos(q, row, column)) in the plain version's order;
// wt: the layer's output-major rows, ldt apart.
template <typename Pos>
__device__ __forceinline__ void plain_fixups(unsigned long long flags,
                                             Pos pos, const ASeg<bf16>& s0,
                                             const ASeg<bf16>& s1,
                                             const bf16* wt, int ldt,
                                             const float* b, bool relu,
                                             bf16* o, int ldo) {
  while (flags) {
    const int bit = __ffsll(static_cast<long long>(flags)) - 1;
    flags &= flags - 1;
    int r, c;
    pos(bit >> 1, r, c);
    c += bit & 1;
    o[r * ldo + c] = round_to<bf16>(plain_output(
        s0.a + r * s0.ld, s0.k, s1.a + r * s1.ld, s1.k,
        wt + static_cast<long long>(c) * ldt, __ldg(b + c), relu));
  }
}

// One layer of the forward: o = round(act(sum + bias)), act ReLU or none;
// w is the layer's input-major [k][n] block (read by the cp.async
// engines; the warpgroup engine takes the layer's slabs from the feed),
// wt its output-major rows, ldt apart (the bf16 recomputes).
template <typename P, typename T = typename P::Elem>
__device__ __forceinline__ void dense(Feed& f, const ASeg<T>& s0,
                                      const ASeg<T>& s1, const T* w,
                                      const T* wt, int ldt, int n,
                                      const float* b, bool relu, T* o,
                                      int ldo, T* ring) {
  if constexpr (P::kWarpgroup) {
    for (int c0 = 0; c0 < n; c0 += kSlabN) {
      float d[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) d[i] = 0.0f;
      wg_product(f, d, s0, s1);
      // The biases of this thread's columns, their loads issued together.
      float bv[kSlabN / 4];
#pragma unroll
      for (int i = 0; i < kSlabN / 8; ++i) {
        const float* bp = b + c0 + 8 * i + 2 * (threadIdx.x & 3);
        bv[2 * i] = __ldg(bp);
        bv[2 * i + 1] = __ldg(bp + 1);
      }
      unsigned long long flags = 0;
      wg_each(d, [&](int p, int r, int c, float v0, float v1) {
        const float u0 = v0 + bv[p & ~1], u1 = v1 + bv[(p & ~1) + 1];
        const float y0 = relu ? fmaxf(u0, 0.0f) : u0;
        const float y1 = relu ? fmaxf(u1, 0.0f) : u1;
        store_pair(o + r * ldo + c0 + c, y0, y1);
        if (near_midpoint(u0, y0)) flags |= 1ull << (2 * p);
        if (near_midpoint(u1, y1)) flags |= 1ull << (2 * p + 1);
      });
      const int lane = threadIdx.x & 31;
      plain_fixups(
          flags,
          [&](int q, int& r, int& c) {
            r = wg_row0() + (lane >> 2) + 8 * (q & 1);
            c = c0 + 8 * (q >> 1) + 2 * (lane & 3);
          },
          s0, s1, wt, ldt, b, relu, o, ldo);
    }
  } else {
    panels(n, [&](int c0, auto width) {
      constexpr int N = decltype(width)::value;
      using E = typename P::template Fwd<N>;
      for (int h = 0; h < P::kRows / E::kRows; ++h) {
        const int r0 = h * E::kRows;
        E e;
        e.zero();
        weight_product<P, N>(e, ASeg<T>{s0.a + r0 * s0.ld, s0.ld, s0.k},
                             ASeg<T>{s1.a + r0 * s1.ld, s1.ld, s1.k},
                             w + c0, n, ring);
        unsigned long long flags = 0;
        int q = 0;
        e.template each<false>([&](int, int r, int c, float v0, float v1) {
          c += c0;
          const float u0 = v0 + b[c], u1 = v1 + b[c + 1];
          const float y0 = relu ? fmaxf(u0, 0.0f) : u0;
          const float y1 = relu ? fmaxf(u1, 0.0f) : u1;
          store_pair(o + (r0 + r) * ldo + c, y0, y1);
          if (P::kTensor) {
            if (near_midpoint(u0, y0)) flags |= 1ull << (2 * q);
            if (near_midpoint(u1, y1)) flags |= 1ull << (2 * q + 1);
          }
          ++q;
        });
        if constexpr (P::kTensor) {
          static_assert(E::kPairs <= 32, "a flag bit per output");
          plain_fixups(
              flags,
              [&](int qq, int& r, int& c) {
                E::pair_pos(qq, r, c);
                r += r0;
                c += c0;
              },
              s0, s1, wt, ldt, b, relu, o, ldo);
        }
      }
    });
  }
  tile_sync();
}

// sum_j a[j] w[j ws] for j < k (k a multiple of 8) in fp32, in order: a
// in shared memory, w in device memory, each 8 loads issued together.
template <typename T>
__device__ __forceinline__ float head_dot(const T* a, const T* w, int ws,
                                          int k) {
  float acc = 0.0f;
  for (int j0 = 0; j0 < k; j0 += 8) {
    float av[8], wv[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      av[u] = load(a + j0 + u);
      wv[u] = ldg(w + (j0 + u) * ws);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) acc = __fmaf_rn(av[u], wv[u], acc);
  }
  return acc;
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
__device__ void forward_tile(const Spec& s, const T* wkn, const T* wnk,
                             const float* bias, const TileBufs<T>& t,
                             Feed& f, float* out, long long row0,
                             long long end, Save save) {
  constexpr int RT = P::kRows;
  const int W = s.width, D = s.depth, CW = s.cond_width;
  const int R = s.num_rgb, S = s.num_sigma, O = R + S;
  const ASeg<T> none = {nullptr, 0, 0};
  const ASeg<T> x0 = {t.x0, t.ld_x0, s.feat};
  for (int i = 0; i < D; ++i) {
    const ASeg<T> s0 = i == 0 ? x0 : ASeg<T>{t.act[(i - 1) & 1], t.ld_act, W};
    const ASeg<T> s1 = i > 0 && skip_after(s, i - 1) ? x0 : none;
    dense<P>(f, s0, s1, wkn + s.w_off[i], wnk + s.t_off[i], s.kp[i], W,
             bias + s.b_off[i], true, t.act[i & 1], t.ld_act, t.ring);
    save(i, t.act[i & 1], W);
  }

  // Heads: the sigma column stays fp32, the bottleneck (no activation) is
  // rounded to T before it meets the condition.
  const T* h = t.act[(D - 1) & 1];
  T* bn = t.act[D & 1];
  dense<P>(f, ASeg<T>{h, t.ld_act, W}, none, wkn + s.w_off[D + 1],
           wnk + s.t_off[D + 1], s.kp[D + 1], W, bias + s.b_off[D + 1], false,
           bn, t.ld_act, t.ring);
  save(D, bn, W);
  if (out) {
    const T* w = wkn + s.w_off[D];
    const float* b = bias + s.b_off[D];
    for (int e = threadIdx.x; e < RT * S; e += kThreads) {
      const int r = e / S, c = e % S;
      if (row0 + r >= end) continue;
      out[(row0 + r) * O + R + c] =
          head_dot(h + r * t.ld_act, w + c, S, W) + b[c];
    }
    tile_sync();
  }

  // Condition layer on [bottleneck, condition], into h's buffer.
  T* ac = t.act[(D - 1) & 1];
  dense<P>(f, ASeg<T>{bn, t.ld_act, W}, ASeg<T>{t.cond, t.ld_c, s.cond},
           wkn + s.w_off[D + 2], wnk + s.t_off[D + 2], s.kp[D + 2], CW,
           bias + s.b_off[D + 2], true, ac, t.ld_act, t.ring);
  save(D + 1, ac, CW);

  if (out) {
    const T* w = wkn + s.w_off[D + 3];
    const float* b = bias + s.b_off[D + 3];
    for (int e = threadIdx.x; e < RT * R; e += kThreads) {
      const int r = e / R, c = e % R;
      if (row0 + r >= end) continue;
      out[(row0 + r) * O + c] = head_dot(ac + r * t.ld_act, w + c, R, CW) +
                                b[c];
    }
  }
}

}  // namespace fused_mlp
