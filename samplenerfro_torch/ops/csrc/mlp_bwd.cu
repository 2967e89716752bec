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
// path sampler). As _bwd_kernel (268-317): recompute the forward, then
// walk back through the rgb head, the condition layer, the sigma and
// bottleneck heads and the trunk; ReLU masks are taken on the stored
// activations (act > 0), each pre-activation cotangent is rounded to the
// compute type before its products, each bias gradient is the fp32 sum of
// the unrounded cotangent, and dW = (layer input)^T (rounded cotangent)
// sums over the rows in fp32. Rows past n carry a zero cotangent and add
// nothing.
//
// Two launches, one wrapper call:
//  1. mlp_bwd_kernel: a fixed grid of G blocks (one per SM at most); block
//     b takes the contiguous rows [b n / G, (b + 1) n / G), in super-tiles
//     of super_rows rows (a multiple of the row tile). For each super-tile:
//     a. per row tile (128 rows in bf16, 64 in fp32; a quarter of that
//        for layers wider than 256 or inputs past 128 columns): the
//        forward, K4's forward_tile under K4's Policy (so every stored
//        activation is K4's, bit for bit), then the cotangents, layer by
//        layer, as products with the weights transposed (dZ W^T): in bf16
//        on tensor cores (the warpgroup engine, the cotangents' slabs of
//        the slab pack following the forward's in the feed; mma.sync for
//        wide tiles), in fp32 on CUDA cores with the output-major pack.
//        Each ReLU mask is read from the scratch under the product. Bias
//        gradients and the two narrow heads' dW are summed per tile (in
//        registers, then across lanes and warps in a fixed order) into the
//        block's partial. Every stored activation, the inputs and every
//        rounded cotangent go to the block's slab of a scratch buffer.
//     b. per layer, dW over the whole super-tile as one product that
//        contracts over its rows (A^T dZ; in bf16 wgmma with A^T from
//        registers through ldmatrix.trans and dZ MN-major in shared
//        memory, or mma.sync beside wide tiles), added into the block's
//        [P] slice of a [G, P] fp32 partial once: the first super-tile
//        stores, later ones add. So the partial (P = 595,715 at ship
//        width, 2.4 MB) moves once per super-tile rather than once per row
//        tile.
//     Every entry is owned by one thread and updated in a fixed order; no
//     atomics.
//  2. mlp_bwd_reduce: sums the G partials of each parameter in block
//     order. Two runs therefore agree bit for bit.
//
// What bounds it on the card: operations, about three times K4's (the
// recompute, the products to dh, the dW products): 0.70 TFLOP for the bf16
// train batch's fine call (196,608 rows), 0.71 ms on bf16 tensor cores;
// 10.4 ms in fp32. Besides the products it moves the scratch slabs (each
// row's 4,968 stored values written once and read back about twice; a
// trial build that neither writes nor reads them, K5_TRIAL_NO_SCRATCH,
// measures their share: debug/k5_scratch_cost.py) and the partials (G x
// 2.4 MB per super-tile).

#include "mlp_common.cuh"

namespace {

using fused_mlp::ASeg;
using fused_mlp::kOutCols;
using fused_mlp::kThreads;
using fused_mlp::load;
using fused_mlp::round_to;
using fused_mlp::Spec;
using fused_mlp::TileBufs;

// The recompute is K4's forward_tile under the same Policy, so each stored
// activation is K4's, bit for bit: in bf16 the same warpgroup layer
// (wg_product: the same wgmma, k order and slabs) or, for wide tiles, the
// same mma.sync engine; in fp32 the same CUDA-core chain.
template <typename T, bool kWide>
using Chain = fused_mlp::Policy<T, kWide>;

// Trial switch for debug/k5_scratch_cost.py, 0 in use: 1 neither writes
// nor reads the scratch slabs (copy_rows, the cotangents' ReLU masks and
// the weight gradients' operands are skipped or read as zeros), so the
// gradients are wrong and only the kernel's time is read.
#ifndef K5_TRIAL_NO_SCRATCH
#define K5_TRIAL_NO_SCRATCH 0
#endif

// Floats of the column-sum buffer: [2][256] for the cp.async engines,
// [8 warps][kSlabN] for the warpgroup engine.
template <typename P>
__host__ __device__ constexpr int colbuf_floats() {
  return P::kWarpgroup ? fused_mlp::kConsumerWarps * fused_mlp::kSlabN
                       : 2 * 256;
}

// Where each stored tensor sits in a block's scratch slab, as a count of
// columns before it: the slab holds, for super_rows rows each, a dense
// [super_rows][width] section per tensor, section x at super_rows * x.
struct Sections {
  long long x0, cond, d16, act, bn, ac, dpre, dbn, dac, row_elems;
};

__host__ __device__ inline Sections sections(const Spec& s) {
  Sections q;
  const long long W = s.width, CW = s.cond_width, D = s.depth;
  q.x0 = 0;
  q.cond = q.x0 + s.fp;
  q.d16 = q.cond + s.cp;
  q.act = q.d16 + kOutCols;   // D sections of W
  q.bn = q.act + D * W;
  q.ac = q.bn + W;
  q.dpre = q.ac + CW;         // D sections of W
  q.dbn = q.dpre + D * W;
  q.dac = q.dbn + W;
  q.row_elems = q.dac + CW;
  return q;
}

// dst[r * width + j] = src[r * ld + j] for the tile's rows, 16 bytes a copy.
template <typename P, typename T>
__device__ __forceinline__ void copy_rows(const T* src, int ld, int width,
                                          T* dst) {
  constexpr int E = fused_mlp::pad<T>();
  const int cpr = width / E;
  if (K5_TRIAL_NO_SCRATCH) return;
  for (int e = threadIdx.x; e < P::kRows * cpr; e += kThreads) {
    const int r = e / cpr, q = e % cpr;
    *reinterpret_cast<uint4*>(dst + static_cast<long long>(r) * width +
                              q * E) =
        *reinterpret_cast<const uint4*>(src + r * ld + q * E);
  }
}

// Whether a stored activation (bf16 or fp32) lets its ReLU pass.
__device__ __forceinline__ float relu_mask(float a) {
  return a > 0.0f ? 1.0f : 0.0f;
}

// One cotangent product: v = f(r, c, sum_j A(r, j) W(j, c)) for the tile's
// rows and n columns (W's rows of the output-major pack, ldw apart; the
// warpgroup engine takes the product's slabs from the feed instead), in
// column panels, then masked by the ReLU of mask (a [rows][n] section of
// the scratch, or null); dst = round(v), and pb[c] += the column sums of v.
template <typename P, typename T, typename F>
__device__ __forceinline__ void cotangent(fused_mlp::Feed& fd,
                                          const ASeg<T>& a, const T* w,
                                          int ldw, int n, const T* mask,
                                          const TileBufs<T>& t, T* dst,
                                          float* colbuf, float* pb, F f) {
  if (K5_TRIAL_NO_SCRATCH) mask = nullptr;
  if constexpr (P::kWarpgroup) {
    constexpr int NS = fused_mlp::kSlabN;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int row0 = fused_mlp::wg_row0() + (lane >> 2), col = 2 * (lane & 3);
    for (int c0 = 0; c0 < n; c0 += NS) {
      // The mask's pairs at this thread's outputs, loaded under the
      // product (pair 2 i + h: row half h, n8 tile i).
      unsigned mk[NS / 4];
#pragma unroll
      for (int p = 0; p < NS / 4; ++p) {
        mk[p] = mask ? *reinterpret_cast<const unsigned*>(
                           mask + (row0 + 8 * (p & 1)) * n + c0 +
                           8 * (p >> 1) + col)
                     : 0x3f803f80u;  // bf16 ones
      }
      float d[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) d[i] = 0.0f;
      fused_mlp::wg_product(fd, d, a, ASeg<T>{nullptr, 0, 0});
      // Column sums over the warp's 16 rows as each n8 tile's two row
      // halves are done, then over the 8 warps in order.
      float h0 = 0.0f, h1 = 0.0f;
      fused_mlp::wg_each(d, [&](int p, int r, int c, float v0, float v1) {
        c += c0;
        v0 = f(r, c, v0) * relu_mask(__uint_as_float(mk[p] << 16));
        v1 = f(r, c + 1, v1) *
             relu_mask(__uint_as_float(mk[p] & 0xffff0000u));
        fused_mlp::store_pair(dst + r * t.ld_act + c, v0, v1);
        if ((p & 1) == 0) {
          h0 = v0;
          h1 = v1;
        } else {
          const float s0 = fused_mlp::lane_sum(h0 + v0, 4);
          const float s1 = fused_mlp::lane_sum(h1 + v1, 4);
          if (lane < 4) {
            colbuf[warp * NS + (p >> 1) * 8 + 2 * lane] = s0;
            colbuf[warp * NS + (p >> 1) * 8 + 2 * lane + 1] = s1;
          }
        }
      });
      fused_mlp::tile_sync();
      if (threadIdx.x < NS) {
        float sum = 0.0f;
        for (int wp = 0; wp < fused_mlp::kConsumerWarps; ++wp)
          sum += colbuf[wp * NS + threadIdx.x];
        pb[c0 + threadIdx.x] += sum;
      }
      fused_mlp::tile_sync();
    }
  } else {
    fused_mlp::panels(n, [&](int c0, auto width) {
      constexpr int N = decltype(width)::value;
      using E = typename P::template Fwd<N>;
      E e;
      e.zero();
      fused_mlp::weight_product<P, N>(e, a, ASeg<T>{nullptr, 0, 0}, w + c0,
                                      ldw, t.ring);
      float cs[E::kSlots];
#pragma unroll
      for (int q = 0; q < E::kSlots; ++q) cs[q] = 0.0f;
      e.template each<false>([&](int q, int r, int c, float v0, float v1) {
        c += c0;
        v0 = f(r, c, v0);
        v1 = f(r, c + 1, v1);
        if (mask) {
          v0 *= relu_mask(load(mask + r * n + c));
          v1 *= relu_mask(load(mask + r * n + c + 1));
        }
        fused_mlp::store_pair(dst + r * t.ld_act + c, v0, v1);
        cs[q] += v0;
        cs[q + 1] += v1;
      });
      E::colsums(cs, colbuf);
      fused_mlp::tile_sync();
      if (threadIdx.x < N) {
        pb[c0 + threadIdx.x] +=
            colbuf[threadIdx.x] + colbuf[256 + threadIdx.x];
      }
    });
  }
}

// e.acc += A^T dZ over rows [0, rows) of a super-tile: A's columns
// [m0, m0 + tile rows) of [s0 | s1] ([rows][w0] and [rows][w1] sections,
// zero past w0 + w1), dZ N columns of a [rows][ldz] section.
template <typename P, int N, typename T, typename Eng>
__device__ __forceinline__ void grad_product(Eng& e, const T* s0, int w0,
                                             const T* s1, int w1, int m0,
                                             const T* dz, int ldz, int rows,
                                             T* ring) {
  constexpr int KR = P::kSlab, MP = Eng::kRows;
  constexpr int E = fused_mlp::pad<T>(), LDA = MP + E, LDZ = N + E;
  constexpr int STAGE = KR * LDA + KR * LDZ;
  fused_mlp::pipeline(
      rows / KR,
      [&](int sl, int st) {
        T* sa = ring + st * STAGE;
        T* sz = sa + KR * LDA;
        for (int x = threadIdx.x; x < KR * (MP / E); x += kThreads) {
          const int i = x / (MP / E), q = x % (MP / E), m = m0 + q * E;
          const long long row = static_cast<long long>(sl) * KR + i;
          const T* src = nullptr;
          if (m < w0) {
            src = s0 + row * w0 + m;
          } else if (m - w0 < w1) {
            src = s1 + row * w1 + (m - w0);
          }
          fused_mlp::cp_async16(sa + i * LDA + q * E, src ? src : s0,
                                src && !K5_TRIAL_NO_SCRATCH ? 16 : 0);
        }
        for (int x = threadIdx.x; x < KR * (N / E); x += kThreads) {
          const int i = x / (N / E), q = x % (N / E);
          fused_mlp::cp_async16(
              sz + i * LDZ + q * E,
              dz + (static_cast<long long>(sl) * KR + i) * ldz + q * E,
              K5_TRIAL_NO_SCRATCH ? 0 : 16);
        }
      },
      [&](int, int st) {
        const T* sa = ring + st * STAGE;
        const T* sz = sa + KR * LDA;
#pragma unroll
        for (int kk = 0; kk < KR; kk += Eng::kK) {
          e.step_t(sa + kk * LDA, LDA, sz + kk * LDZ, LDZ);
        }
      });
}

// The warpgroup engine's weight-gradient stages: KR rows of dZ's kSlabN
// columns (MN-major in the 128-byte swizzle, desc_mn_sw128: 64-column
// blocks of KR / 8 atoms) and of A's 128 columns ([KR][128 + 8], read by
// ldmatrix.trans), each part 1024-byte aligned. KR is 64 where the ring
// fits in the tile's buffers, else 32.
constexpr int kGradLdA = 128 + 8;
template <int KR>
__host__ __device__ constexpr int grad_zbytes() {
  return KR * fused_mlp::kSlabN * 2;
}
template <int KR>
__host__ __device__ constexpr int grad_stage() {
  return grad_zbytes<KR>() + (KR * kGradLdA * 2 + 1023) / 1024 * 1024;
}
template <int KR>
__host__ __device__ constexpr size_t grad_ring() {
  return 1024 + static_cast<size_t>(fused_mlp::kStages) * grad_stage<KR>();
}

// d += A^T dZ over rows [0, rows) of a super-tile for the warpgroup's 64
// of A's columns [m0, m0 + 128) of [s0 | s1] (as grad_product) and dZ's
// kSlabN columns at dz: A^T from registers (ldmatrix.trans), dZ from
// shared memory, rows in order, the sum kept in d.
template <int KR, typename T>
__device__ __forceinline__ void wg_grad_product(float (&d)[64], const T* s0,
                                                int w0, const T* s1, int w1,
                                                int m0, const T* dz, int ldz,
                                                int rows, T* ring) {
  constexpr int LDA = kGradLdA, E = 8, STAGE = grad_stage<KR>();
  constexpr int QN = fused_mlp::kSlabN / E;  // 16-byte chunks of a dZ row
  unsigned char* base = reinterpret_cast<unsigned char*>(ring);
  base += (1024 - fused_mlp::smem_addr(base) % 1024) % 1024;
  const int lane = threadIdx.x & 31;
  const int mcol = fused_mlp::wg_row0() + ((lane >> 3) & 1) * 8;
  const int krow = (lane & 7) + ((lane >> 4) << 3);
  fused_mlp::pipeline(
      rows / KR,
      [&](int sl, int st) {
        unsigned char* sz = base + st * STAGE;
        T* sa = reinterpret_cast<T*>(sz + grad_zbytes<KR>());
        for (int x = threadIdx.x; x < KR * (128 / E); x += kThreads) {
          const int i = x / (128 / E), q = x % (128 / E), m = m0 + q * E;
          const long long row = static_cast<long long>(sl) * KR + i;
          const T* src = nullptr;
          if (m < w0) {
            src = s0 + row * w0 + m;
          } else if (m - w0 < w1) {
            src = s1 + row * w1 + (m - w0);
          }
          fused_mlp::cp_async16(sa + i * LDA + q * E, src ? src : s0,
                                src && !K5_TRIAL_NO_SCRATCH ? 16 : 0);
        }
        for (int x = threadIdx.x; x < KR * QN; x += kThreads) {
          const int i = x / QN, q = x % QN;
          unsigned char* dst = sz + ((q >> 3) * (KR / 8) + (i >> 3)) * 1024 +
                               (i & 7) * 128 + (((q & 7) ^ (i & 7)) << 4);
          fused_mlp::cp_async16(
              dst, dz + (static_cast<long long>(sl) * KR + i) * ldz + q * E,
              K5_TRIAL_NO_SCRATCH ? 0 : 16);
        }
      },
      [&](int, int st) {
        const unsigned char* sz = base + st * STAGE;
        const T* sa = reinterpret_cast<const T*>(sz + grad_zbytes<KR>());
        unsigned a[KR / 16][4];
#pragma unroll
        for (int j = 0; j < KR / 16; ++j) {
          fused_mlp::ldsm_x4_t(a[j], sa + (16 * j + krow) * LDA + mcol);
        }
        fused_mlp::wg_pin(d);
        fused_mlp::wg_fence();
#pragma unroll
        for (int j = 0; j < KR / 16; ++j) {
          fused_mlp::wgmma_n128<1>(
              d, a[j],
              fused_mlp::desc_mn_sw128(sz + 2048 * j, (KR / 8) * 1024, 1024));
        }
        fused_mlp::wg_commit();
        fused_mlp::wg_wait<0>();
        fused_mlp::wg_pin(d);
      });
}

// dW += A^T dZ for a head of `cols` (<= kOutCols) outputs on the tile:
// A [rows][k] (ld apart) and dZ (the rounded cotangent's columns, kOutCols
// apart) in shared memory; a thread a weight, the rows in order.
template <typename P, typename T>
__device__ __forceinline__ void head_grads(const T* a, int ld, int k,
                                           const T* dz, int cols, float* dw) {
  for (int e = threadIdx.x; e < k * cols; e += kThreads) {
    const int i = e / cols, j = e % cols;
    float acc = 0.0f;
    for (int r = 0; r < P::kRows; ++r) {
      acc = __fmaf_rn(load(a + r * ld + i), load(dz + r * kOutCols + j), acc);
    }
    dw[e] += acc;
  }
}

// Phase a for one row tile: inputs, forward, cotangents; rows [row0,
// row0 + tile) of the block, at row srow of the super-tile's sections.
template <typename P, typename T = typename P::Elem>
__device__ void tile_backward(const Spec& s, const float* x, const float* c,
                              const float* dout, const T* wkn, const T* wnk,
                              const float* bias, const TileBufs<T>& t,
                              fused_mlp::Feed& fd, const T* wsig, int ws,
                              float* douts, T* d16, float* colbuf, T* base,
                              const Sections& sec, int super_rows,
                              long long row0, long long end, int srow,
                              float* part) {
  constexpr int RT = P::kRows;
  const int W = s.width, D = s.depth, CW = s.cond_width;
  const int R = s.num_rgb, S = s.num_sigma, O = R + S, ld = t.ld_act;
  float* pbias = part + s.num_weights;
  auto section = [&](long long col, int width) {
    return base + super_rows * col + static_cast<long long>(srow) * width;
  };
  fused_mlp::load_tile<P>(s, x, c, row0, end, t);
  for (int e0 = threadIdx.x; e0 < RT * kOutCols; e0 += 4 * kThreads) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * kThreads, r = e / kOutCols, j = e % kOutCols;
      v[u] = e < RT * kOutCols && j < O && row0 + r < end
                 ? fused_mlp::ldg(dout + (row0 + r) * O + j)
                 : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * kThreads;
      if (e < RT * kOutCols) {
        douts[e] = v[u];
        d16[e] = round_to<T>(v[u]);
      }
    }
  }
  fused_mlp::tile_sync();
  copy_rows<P>(t.x0, t.ld_x0, s.fp, section(sec.x0, s.fp));
  copy_rows<P>(t.cond, t.ld_c, s.cp, section(sec.cond, s.cp));
  copy_rows<P>(d16, kOutCols, kOutCols, section(sec.d16, kOutCols));
  fused_mlp::forward_tile<P>(
      s, wkn, wnk, bias, t, fd, nullptr, row0, end,
      [&](int id, const T* buf, int width) {
        const long long col = id < D ? sec.act + static_cast<long long>(id) * W
                                     : (id == D ? sec.bn : sec.ac);
        copy_rows<P>(buf, ld, width, section(col, width));
        if (id == D - 1) {
          // The sigma head's dW on the trunk's output, while it is here.
          head_grads<P>(buf, ld, W, d16 + R, S, part + s.w_off[D]);
        }
      });

  // Head biases: the fp32 cotangent summed over the tile's rows.
  if (threadIdx.x < O) {
    float acc = 0.0f;
    for (int r = 0; r < RT; ++r) acc += douts[r * kOutCols + threadIdx.x];
    float* pb = threadIdx.x < R ? pbias + s.b_off[D + 3] + threadIdx.x
                                : pbias + s.b_off[D] + (threadIdx.x - R);
    *pb += acc;
  }
  // rgb head: dW += a_c^T drgb16; da_c = (drgb16 Wrgb^T) * (a_c > 0), a
  // thread a column, its bias gradient summed over the rows in order.
  const T* ac = t.act[(D - 1) & 1];
  T* dac = t.act[D & 1];
  head_grads<P>(ac, ld, CW, d16, R, part + s.w_off[D + 3]);
  for (int k = threadIdx.x; k < CW; k += kThreads) {
    const T* w = wkn + s.w_off[D + 3] + k * R;
    float sum = 0.0f;
    for (int r = 0; r < RT; ++r) {
      float v = 0.0f;
      for (int j = 0; j < R; ++j) {
        v = __fmaf_rn(load(d16 + r * kOutCols + j), load(w + j), v);
      }
      v *= load(ac + r * ld + k) > 0.0f ? 1.0f : 0.0f;
      sum += v;
      dac[r * ld + k] = round_to<T>(v);
    }
    pbias[s.b_off[D + 2] + k] += sum;
  }
  fused_mlp::tile_sync();
  copy_rows<P>(dac, ld, CW, section(sec.dac, CW));

  // The bottleneck's cotangent: (da_c16 Wc^T) over its first W inputs.
  T* dbn = t.act[(D - 1) & 1];
  cotangent<P>(fd, ASeg<T>{dac, ld, CW}, wnk + s.t_off[D + 2], s.kp[D + 2],
               W, static_cast<const T*>(nullptr), t, dbn, colbuf,
               pbias + s.b_off[D + 1],
               [](int, int, float v) { return v; });
  copy_rows<P>(dbn, ld, W, section(sec.dbn, W));

  // dh = dbn16 Wbn^T + dsigma16 Wsigma^T (wsig: the sigma head's rows, ws
  // apart), masked by the trunk's output.
  const T* act_last = section(sec.act + static_cast<long long>(D - 1) * W, W);
  T* src = t.act[D & 1];
  cotangent<P>(fd, ASeg<T>{dbn, ld, W}, wnk + s.t_off[D + 1], s.kp[D + 1], W,
               act_last, t, src, colbuf, pbias + s.b_off[D - 1],
               [&](int r, int col, float v) {
                 for (int j = 0; j < S; ++j) {
                   v = __fmaf_rn(load(d16 + r * kOutCols + R + j),
                                 load(wsig + j * ws + col), v);
                 }
                 return v;
               });
  copy_rows<P>(src, ld, W,
               section(sec.dpre + static_cast<long long>(D - 1) * W, W));

  // Trunk, last layer first: dh over the previous activation's columns
  // (the skip input's columns carry no gradient anywhere).
  T* dst = t.act[(D - 1) & 1];
  for (int i = D - 1; i >= 1; --i) {
    const T* act = section(sec.act + static_cast<long long>(i - 1) * W, W);
    cotangent<P>(fd, ASeg<T>{src, ld, W}, wnk + s.t_off[i], s.kp[i], W, act,
                 t, dst, colbuf, pbias + s.b_off[i - 1],
                 [](int, int, float v) { return v; });
    copy_rows<P>(dst, ld, W,
                 section(sec.dpre + static_cast<long long>(i - 1) * W, W));
    T* tmp = src;
    src = dst;
    dst = tmp;
  }
}

// Phase b: the dW of every layer but the two heads over the super-tile's
// first `rows` rows, into the block's partial (stored when first, added
// after), in column panels of the layer's outputs.
template <typename P, typename T = typename P::Elem>
__device__ void weight_grads(const Spec& s, const T* base,
                             const Sections& sec, int super_rows, int rows,
                             float* part, bool first, T* ring,
                             bool wide_ring) {
  const int W = s.width, D = s.depth, CW = s.cond_width;
  auto sect = [&](long long col) { return base + super_rows * col; };
  fused_mlp::tile_sync();  // the ring overwrites the tile's buffers
  for (int l = 0; l < D + 3; ++l) {
    if (l == D) continue;  // the sigma head, summed in tile_backward
    const T* s0;
    const T* s1 = nullptr;
    const T* dz;
    int w0, k0, w1 = 0, k1 = 0, n;
    if (l < D) {
      if (l == 0) {
        s0 = sect(sec.x0);
        w0 = s.fp;
        k0 = s.feat;
      } else {
        s0 = sect(sec.act + static_cast<long long>(l - 1) * W);
        w0 = k0 = W;
        if (fused_mlp::skip_after(s, l - 1)) {
          s1 = sect(sec.x0);
          w1 = s.fp;
          k1 = s.feat;
        }
      }
      dz = sect(sec.dpre + static_cast<long long>(l) * W);
      n = W;
    } else if (l == D + 1) {
      s0 = sect(sec.act + static_cast<long long>(D - 1) * W);
      w0 = k0 = W;
      dz = sect(sec.dbn);
      n = W;
    } else {
      s0 = sect(sec.bn);
      w0 = k0 = W;
      s1 = sect(sec.cond);
      w1 = s.cp;
      k1 = s.cond;
      dz = sect(sec.dac);
      n = CW;
    }
    float* p = part + s.w_off[l];
    // Stores (first) or adds dW's entries at A's column m0 + r, column
    // c of dz.
    auto put = [&](int m0, int r, int c, float v0, float v1) {
      const int m = m0 + r;
      int row;
      if (m < w0) {
        if (m >= k0) return;
        row = m;
      } else {
        if (m - w0 >= k1) return;
        row = k0 + (m - w0);
      }
      float* q = p + static_cast<long long>(row) * n + c;
      if (first) {
        q[0] = v0;
        q[1] = v1;
      } else {
        q[0] += v0;
        q[1] += v1;
      }
    };
    if constexpr (P::kWarpgroup) {
      for (int c0 = 0; c0 < n; c0 += fused_mlp::kSlabN) {
        for (int m0 = 0; m0 < w0 + w1; m0 += 128) {
          float d[64];
#pragma unroll
          for (int i = 0; i < 64; ++i) d[i] = 0.0f;
          if (wide_ring) {
            wg_grad_product<64>(d, s0, w0, s1, w1, m0, dz + c0, n, rows,
                                ring);
          } else {
            wg_grad_product<32>(d, s0, w0, s1, w1, m0, dz + c0, n, rows,
                                ring);
          }
          fused_mlp::wg_each(d, [&](int, int r, int c, float v0, float v1) {
            put(m0, r, c0 + c, v0, v1);
          });
        }
      }
    } else {
      fused_mlp::panels(n, [&](int c0, auto width) {
        constexpr int N = decltype(width)::value;
        using E = typename P::template Grad<N>;
        for (int m0 = 0; m0 < w0 + w1; m0 += E::kRows) {
          E e;
          e.zero();
          grad_product<P, N>(e, s0, w0, s1, w1, m0, dz + c0, n, rows, ring);
          e.template each<true>([&](int, int r, int c, float v0, float v1) {
            put(m0, r, c0 + c, v0, v1);
          });
        }
      });
    }
  }

  fused_mlp::tile_sync();
}

// Shared memory of a block: the tile's, the cotangent's rows (fp32 and
// rounded), the column sums and, with the warpgroup engine, a copy of the
// sigma head's weights.
template <typename P, typename T = typename P::Elem>
__host__ __device__ inline size_t smem_bytes(const Spec& s, int stages) {
  return fused_mlp::tile_bytes<P>(s, stages) +
         (sizeof(float) + sizeof(T)) * P::kRows * kOutCols +
         sizeof(float) * colbuf_floats<P>() +
         (P::kWarpgroup ? sizeof(T) * s.num_sigma * s.width : 0);
}

// Shared memory of weight_grads' ring, which reuses the tile's buffers.
template <typename P, typename T = typename P::Elem>
__host__ __device__ inline size_t grad_ring_bytes(const Spec& s) {
  if (P::kWarpgroup) return grad_ring<32>();
  constexpr int E = fused_mlp::pad<T>();
  constexpr int MP = P::template Grad<128>::kRows;
  const int maxw = s.width > s.cond_width ? s.width : s.cond_width;
  return sizeof(T) * fused_mlp::kStages * P::kSlab *
         (MP + E + fused_mlp::panel_width(maxw) + E);
}

template <typename T, bool kWide>
__global__ void __launch_bounds__(fused_mlp::block_threads<Chain<T, kWide>>())
    mlp_bwd_kernel(Spec s, const float* x, const float* c, const float* dout,
                   const T* wkn, const T* wnk, const void* slabs,
                   const float* bias, T* scratch, float* partial, long long n,
                   int super_rows, int stages) {
  using P = Chain<T, kWide>;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int RT = P::kRows;
  const TileBufs<T> t = fused_mlp::tile_bufs<P>(s, smem, stages);
  float* douts = reinterpret_cast<float*>(
      smem + fused_mlp::tile_bytes<P>(s, stages));
  T* d16 = reinterpret_cast<T*>(douts + RT * kOutCols);
  float* colbuf = reinterpret_cast<float*>(d16 + RT * kOutCols);

  const Sections sec = sections(s);
  const long long G = gridDim.x, b = blockIdx.x;
  const long long begin = n * b / G, end = n * (b + 1) / G;
  // The feed: each of the block's tiles takes the forward's slabs, then
  // the cotangents'.
  fused_mlp::Feed fd{};
  if (P::kWarpgroup) {
    const int per_tile = s.fwd_slabs + s.cot_slabs;
    fused_mlp::feed_init(fd, reinterpret_cast<unsigned char*>(t.ring), t.bars,
                         stages, slabs, per_tile,
                         (end - begin + RT - 1) / RT * per_tile);
    if (!fused_mlp::feed_split(fd)) return;
  }
  // The sigma head's weights for dh's epilogue: read in place, or (the
  // warpgroup engine) copied to shared memory once.
  const T* wsig = wnk + s.t_off[s.depth];
  int ws = s.kp[s.depth];
  if (P::kWarpgroup) {
    T* copy = reinterpret_cast<T*>(colbuf + colbuf_floats<P>());
    for (int e = threadIdx.x; e < s.num_sigma * s.width; e += kThreads)
      copy[e] = wsig[(e / s.width) * ws + e % s.width];
    wsig = copy;
    ws = s.width;
  }
  T* base = scratch + b * super_rows * sec.row_elems;
  float* part = partial + b * (s.num_weights + s.num_biases);
  float* pbias = part + s.num_weights;
  // The biases and the two narrow heads' weights are summed tile by tile.
  for (int e = threadIdx.x; e < s.num_biases; e += kThreads) pbias[e] = 0.0f;
  for (int e = threadIdx.x; e < s.k[s.depth] * s.n[s.depth]; e += kThreads)
    part[s.w_off[s.depth] + e] = 0.0f;
  for (int e = threadIdx.x; e < s.k[s.depth + 3] * s.n[s.depth + 3];
       e += kThreads)
    part[s.w_off[s.depth + 3] + e] = 0.0f;
  bool first = true;
  for (long long st0 = begin; st0 < end; st0 += super_rows) {
    const long long st_end = st0 + super_rows < end ? st0 + super_rows : end;
    int rows = 0;
    for (long long row0 = st0; row0 < st_end; row0 += RT, rows += RT) {
      tile_backward<P>(s, x, c, dout, wkn, wnk, bias, t, fd, wsig, ws,
                       douts, d16, colbuf, base, sec, super_rows, row0, end,
                       rows, part);
    }
    weight_grads<P>(s, base, sec, super_rows, rows, part, first, t.act[0],
                    grad_ring<64>() <= fused_mlp::tile_bytes<P>(s, stages) -
                                           fused_mlp::feed_bytes(stages));
    first = false;
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

template <typename T, bool kWide>
int launch(const Spec& s, const float* x, const float* c, const float* dout,
           const void* wkn, const void* wnk, const void* slabs,
           const float* bias, void* scratch, float* partial, float* grads,
           long long n, int blocks, int super_rows, cudaStream_t stream) {
  using P = Chain<T, kWide>;
  // The feed's stages: as many as fit, up to kMaxFeedStages.
  int stages = 0;
  if (P::kWarpgroup) {
    stages = fused_mlp::kMaxFeedStages;
    while (stages > 2 && smem_bytes<P>(s, stages) > fused_mlp::kMaxSmem)
      --stages;
    if (slabs == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes<P>(s, stages);
  // weight_grads' ring reuses the tile's activation and input buffers.
  const size_t bufs = fused_mlp::tile_bytes<P>(s, stages) -
                      (P::kWarpgroup ? fused_mlp::feed_bytes(stages) : 0);
  if (super_rows <= 0 || super_rows % P::kRows != 0 ||
      P::kRows % P::kSlab != 0 || grad_ring_bytes<P>(s) > bufs ||
      smem > fused_mlp::kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_bwd_kernel<T, kWide>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mlp_bwd_kernel<T, kWide><<<blocks, fused_mlp::block_threads<P>(), smem,
                             stream>>>(
      s, x, c, dout, static_cast<const T*>(wkn), static_cast<const T*>(wnk),
      slabs, bias, static_cast<T*>(scratch), partial, n, super_rows, stages);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long count = s.num_weights + s.num_biases;
  mlp_bwd_reduce<<<static_cast<unsigned>((count + 255) / 256), 256, 0,
                   stream>>>(partial, blocks, count, grads);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_any(const Spec& s, const float* x, const float* c,
               const float* dout, const void* wkn, const void* wnk,
               const void* slabs, const float* bias, void* scratch,
               float* partial, float* grads, long long n, int blocks,
               int super_rows, cudaStream_t stream) {
  return s.wide ? launch<T, true>(s, x, c, dout, wkn, wnk, slabs, bias,
                                  scratch, partial, grads, n, blocks,
                                  super_rows, stream)
                : launch<T, false>(s, x, c, dout, wkn, wnk, slabs, bias,
                                   scratch, partial, grads, n, blocks,
                                   super_rows, stream);
}

}  // namespace

// x, c, wkn, bias: as mlp_fwd_launch; dout: [n, num_rgb + num_sigma] fp32
// cotangent of K4's output; wnk: the output-major weight pack (rows padded,
// see mlp_common.cuh:Spec); slabs: the slab pack (bf16 tiles that are not
// wide: num_slabs = the forward's and the cotangents' slabs), else null
// and 0; scratch: blocks x super_rows x the row's stored
// values (Sections) in the compute type; partial: [blocks, num_weights +
// num_biases] fp32 (written by the kernel); grads: the same count, weight
// gradients in the input-major pack's order, then the biases'. Every block
// must get at least one row (blocks <= n). Returns a cudaError_t.
extern "C" int mlp_bwd_launch(const float* x, const float* c,
                              const float* dout, const void* wkn,
                              const void* wnk, const void* slabs,
                              long long num_slabs, const float* bias,
                              void* scratch, float* partial, float* grads,
                              long long n, int blocks, int super_rows,
                              int bf16, int depth, int width, int skip,
                              int feat, int cond, int cond_width, int num_rgb,
                              int num_sigma, int pe, long long num_weights,
                              long long num_wnk, void* stream) {
  Spec s;
  if (!fused_mlp::make_spec(&s, depth, width, skip, feat, cond, cond_width,
                            num_rgb, num_sigma, pe) ||
      s.num_weights != num_weights || s.num_wnk != num_wnk || blocks <= 0 ||
      blocks > n ||
      num_slabs != (bf16 && !s.wide ? s.fwd_slabs + s.cot_slabs : 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_any<__nv_bfloat16>(s, x, c, dout, wkn, wnk, slabs,
                                          bias, scratch, partial, grads, n,
                                          blocks, super_rows, st)
              : launch_any<float>(s, x, c, dout, wkn, wnk, slabs, bias,
                                  scratch, partial, grads, n, blocks,
                                  super_rows, st);
}
