// The so3 head's hidden layers in the bf16 arm (march_bwd_dtype
// "bfloat16") on Hopper's tensor cores, one definition for every kernel
// that runs them: K2's bf16 head (march_so3.cu), and K3's bf16 passes 1b
// and 3 and P3 (march_bwd.cu, namespace bfa). So the forward a step ran,
// the forward K3 differentiates and the one P3 probes are one summation,
// bit for bit.
//
// A layer: out = bf16(ReLU(A0 W0 + A1 W1 + b)) on the rows of a group of
// warps. Each mma.sync m16n8k16 adds its k16 step of bf16 products to the
// fp32 accumulator itself, k in order over A0's K0 columns and then A1's
// K1 (layer 3's skip input, the PE); the fp32 bias is added after the
// sums. The weights are resident in shared memory in K3's padded
// input-major layout (kW0 .. kWRows below, rows of kLdH bf16), the
// activations [row][kLdH] and the PE [row][kLdX].

#pragma once

#include "mlp_common.cuh"

namespace so3bf {

using fused_mlp::bf16;

constexpr int kW = 128;        // hidden width of the products
constexpr int kIn = 64;        // PE columns kept; zero past 6 * max_deg
constexpr int kLdX = kIn + 8;  // shared-memory row strides, padded
constexpr int kLdH = kW + 8;   // by 16 bytes
// The resident weights, input-major rows of kW: W0t | W1t | W2t | W3t
// (its hidden inputs, then its PE inputs); rows past in_dim are zero.
constexpr int kW0 = 0, kW1 = kIn, kW2 = kIn + kW, kW3 = kIn + 2 * kW,
              kW3x = kIn + 3 * kW, kWRows = 2 * kIn + 3 * kW;

// The warps of a block in groups of W that share 32 rows: group g's rows
// are 32 g .. 32 g + 31 of the block's buffers. A warp owns its group's 32
// rows by 128 / W columns of a product's output; a group's products and
// epilogues touch its own rows alone, so the groups run apart between
// block barriers. A geometry of product() and layer() names kMT, kNT,
// kPipeline, row0(), col0() and sync(), as this one does.
template <int W>
struct Geo {
  static constexpr int kThr = 32 * W;   // threads of a group
  static constexpr int kMT = 2;         // m16 tiles of the group's rows
  static constexpr int kNT = 16 / W;    // n8 tiles of a warp
  static constexpr bool kPipeline = false;  // see product()
  __device__ static int group() { return threadIdx.x / kThr; }
  __device__ static int tid() { return threadIdx.x % kThr; }
  __device__ static int row0() { return 32 * group(); }
  __device__ static int col0() { return (kW / W) * ((threadIdx.x >> 5) % W); }
  // The barrier of this thread's group alone (named barriers from 1).
  __device__ static void sync() {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group()), "r"(kThr)
                 : "memory");
  }
};

// A warp's block of fp32 sums, MT m16 tiles by NT n8 tiles, as m16n8
// fragments: v[mt][nt][e] is row row0 + 16 mt + lane / 4 + 8 (e / 2),
// column col0 + 8 nt + 2 (lane % 4) + e % 2.
template <int MT, int NT>
struct Acc {
  float v[MT][NT][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) v[mt][nt][e] = 0.0f;
  }
  // f(mt, nt, h, row, column, value, value of the next column) for every
  // pair held.
  template <typename F>
  __device__ __forceinline__ void each(int row0, int col0, F f) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          f(mt, nt, h, row0 + 16 * mt + g + 8 * h, col0 + 8 * nt + 2 * t,
            v[mt][nt][2 * h], v[mt][nt][2 * h + 1]);
  }
};

// The A fragments of rows row0 .. row0 + 16 MT - 1 of a row-major [*][lda]
// at k columns k0 .. k0 + 15.
template <int MT>
__device__ __forceinline__ void load_a(unsigned (&af)[MT][4], const bf16* a,
                                       int lda, int row0, int k0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    fused_mlp::ldsm_x4(af[mt], a + (row0 + 16 * mt + (lane & 15)) * lda +
                                   k0 + (lane >> 4) * 8);
}

// The B fragments of 2 NP n8 tiles from column col0 at k rows k0 .. k0 +
// 15: of B [k][n] (kNk false), or of B given as [n][k], B(k, n) = b[n * ldb
// + k] (a weight matrix read transposed). bf[np] holds tiles 2 np and
// 2 np + 1.
template <bool kNk, int NP>
__device__ __forceinline__ void load_b(unsigned (&bf)[NP][4], const bf16* b,
                                       int ldb, int k0, int col0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int np = 0; np < NP; ++np) {
    const int n0 = col0 + 16 * np;
    if (kNk) {
      fused_mlp::ldsm_x4(bf[np],
                         b + (n0 + (lane & 7) + ((lane >> 4) & 1) * 8) * ldb +
                             k0 + ((lane >> 3) & 1) * 8);
    } else {
      fused_mlp::ldsm_x4_t(
          bf[np], b + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldb + n0 +
                      (lane >> 4) * 8);
    }
  }
}

// c += one k16 step's product, added by the tensor core to c itself.
template <int MT, int NT>
__device__ __forceinline__ void mma_step(Acc<MT, NT>& c,
                                         const unsigned (&af)[MT][4],
                                         const unsigned (&bf)[NT / 2][4]) {
#pragma unroll
  for (int np = 0; np < NT / 2; ++np)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      fused_mlp::mma_bf16(c.v[mt][2 * np], af[mt], bf[np][0], bf[np][1]);
      fused_mlp::mma_bf16(c.v[mt][2 * np + 1], af[mt], bf[np][2],
                          bf[np][3]);
    }
}

// c += A B over k in [0, K), in k16 steps in order, the sum of each output
// kept in the tensor core: A row-major, the group's 16 kMT rows; B's
// columns of this warp.
template <typename G, int K, bool kNk>
__device__ __forceinline__ void product(Acc<G::kMT, G::kNT>& c,
                                        const bf16* a, int lda,
                                        const bf16* b, int ldb) {
  if constexpr (G::kPipeline) {
    // Each k16 step's fragments load while the step before runs its
    // products (two sets of registers); the products keep their order.
    if constexpr (K > 0) {
      unsigned af[2][G::kMT][4], bf[2][G::kNT / 2][4];
      load_b<kNk, G::kNT / 2>(bf[0], b, ldb, 0, G::col0());
      load_a<G::kMT>(af[0], a, lda, G::row0(), 0);
#pragma unroll
      for (int k0 = 0; k0 < K; k0 += 16) {
        const int cur = (k0 / 16) & 1;
        if (k0 + 16 < K) {
          load_b<kNk, G::kNT / 2>(bf[cur ^ 1], b, ldb, k0 + 16, G::col0());
          load_a<G::kMT>(af[cur ^ 1], a, lda, G::row0(), k0 + 16);
        }
        mma_step(c, af[cur], bf[cur]);
      }
    }
    return;
  }
  // Pass 3's wider warp blocks keep their fragments' registers in hand
  // with two k16 steps unrolled; the others unroll the whole k.
#pragma unroll(G::kNT == 8 ? 2 : K / 16)
  for (int k0 = 0; k0 < K; k0 += 16) {
    unsigned af[G::kMT][4], bf[G::kNT / 2][4];
    load_b<kNk, G::kNT / 2>(bf, b, ldb, k0, G::col0());
    load_a<G::kMT>(af, a, lda, G::row0(), k0);
    mma_step(c, af, bf);
  }
}

// One hidden layer on the group's rows: out = bf16(ReLU(A0 W0 + A1 W1 +
// b)), A0 over K0 columns, then A1 over K1 (none if 0), each product's sum
// from zero in the tensor core in k order, the fp32 bias added after them
// (K3's jac_layer sums its forward the same way, so K2, P3, 1b and 3 agree
// bit for bit). b: kW fp32 biases in device memory, or in shared memory
// (kSharedBias). With pre (P3, and K2's trial build): the fp32
// pre-activations of rows r < rows and columns c < width go to pre[r *
// pre_ld + c] (pre_ld 0: width). in_place: out is A0's buffer. keep
// (kKeep): this warp's block of the output as bf16 pairs, keep[mt][nt][h]
// as Acc's fragments.
template <typename G, int K0, int K1, bool kKeep = false,
          bool kSharedBias = false>
__device__ __forceinline__ void layer(
    const bf16* a0, int ld0, const bf16* w0, const bf16* a1, int ld1,
    const bf16* w1, const float* b, bf16* out, bool in_place,
    unsigned (*keep)[G::kNT][2] = nullptr, float* pre = nullptr,
    int rows = 0, int width = 0, long long pre_ld = 0) {
  Acc<G::kMT, G::kNT> c;
  c.zero();
  // Shared-memory biases are read before the products: a warp's columns
  // col0 + 8 nt + 2 (lane % 4) + e.
  float bs[G::kNT][2];
  if (kSharedBias) {
#pragma unroll
    for (int nt = 0; nt < G::kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        bs[nt][e] = b[G::col0() + 8 * nt + 2 * (threadIdx.x & 3) + e];
  }
  product<G, K0, false>(c, a0, ld0, w0, kLdH);
  if (K1 > 0) product<G, K1, false>(c, a1, ld1, w1, kLdH);
  if (in_place) G::sync();
  const long long ld = pre_ld ? pre_ld : width;
  c.each(G::row0(), G::col0(),
         [&](int mt, int nt, int h, int r, int col, float v0, float v1) {
           v0 += kSharedBias ? bs[nt][0] : __ldg(b + col);
           v1 += kSharedBias ? bs[nt][1] : __ldg(b + col + 1);
           if (pre && r < rows) {
             if (col < width) pre[r * ld + col] = v0;
             if (col + 1 < width) pre[r * ld + col + 1] = v1;
           }
           __nv_bfloat162 hv;
           hv.x = __float2bfloat16_rn(fmaxf(v0, 0.0f));
           hv.y = __float2bfloat16_rn(fmaxf(v1, 0.0f));
           *reinterpret_cast<__nv_bfloat162*>(out + r * kLdH + col) = hv;
           if (kKeep) keep[mt][nt][h] = *reinterpret_cast<unsigned*>(&hv);
         });
  G::sync();
}

}  // namespace so3bf
