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
//           sin(p 2^k + pi/2) w_k]               (6K features, K <= 10)
//     raw = MLP(x): 4 ReLU layers of width W (<= 128), the inputs
//           concatenated after the third, then a linear layer to 3
//     u   = Rodrigues rotation of g by the axis-angle raw
//   p' = p + (h / n) d;  d' = d + h u;  t' = t + |p - p'|
// starting from p = o + near d0, d = d0, t = near. The window weights w_k
// come from the wrapper, computed there exactly as the plain version
// computes them. Skipping the MLP where |g| <= 1e-3 is exact: the plain
// version's `where` discards its result there.
//
// What bounds it. (1) The head's fp32 operations on the active ray-steps:
// ~1.3e5 a ray-step, 0.640 ms at ship (329,450 active of 786,432) at the
// 67 TFLOP/s of the CUDA cores. Tensor cores and TF32 are ruled out: K3
// and P3 recompute this head with its rounding points (fp32 sums from zero
// in k order, then the skip input, then + bias) and must find the same
// ReLU masks. (2) Latency: a ray's steps are a dependent chain of 768
// steps, each a gather and 5 dependent layers, and 1024 rays are few
// threads for 132 SMs.
//
// Design. The head's weights (65,411 floats) do not fit the 227 KB of one
// block, but half of them do: a cluster of kCluster = 2 CTAs on two SMs
// marches kRays = 16 rays, 1024 rays make 64 clusters on 128 SMs. Both
// CTAs hold the first hidden layer and the output layer whole; CTA `rank`
// holds the input-major columns [64 rank, 64 rank + 64) of hidden layers
// 1-3 (W3 with its 60 skip rows) and their biases. All of it is
// zero-padded to width 128 and 60 inputs as K3 pads the head, and loaded
// once with cp.async: no weight crosses from L2 inside the step loop.
// Warp q of each CTA runs the cluster's rays 4 q .. 4 q + 3 through the
// head on its own, a lane summing 2 columns for the 4 rays (each output one
// fmaf chain in k order: the split is over outputs only): layer 0 whole in
// both CTAs, so that it needs no exchange; then per layer 1-3 its 64
// columns, written into both CTAs' activations through distributed shared
// memory, and one exchange with warp q of the peer (an mbarrier a warp; no
// barrier across the CTA). The march (8 lanes a ray, march_common.cuh),
// the PE (by each ray's own lanes), the output layer and the Rodrigues
// rotation run in both CTAs on the same values in the same arithmetic, so
// both hold the same state without another exchange, and whether a warp's
// 4 rays need the head at a step is decided identically in both: every
// exchange is taken by both warps or by neither. A step loads its next
// corner before its head runs: the next position needs only n and the old
// direction. Each CTA writes half of the rays' trajectory rows.
// What bounds it now: a busy warp issues 10 instructions for 8 fmaf at
// every k of a layer (504 k a step), and waits at 3 exchanges a step that
// runs the head; 4 warps an SM, one a scheduler. Every output comes from
// the same expressions in the same order as in a one-thread-a-ray march,
// so the layout does not change a bit of the trajectory.
//
// Two template parameters pick the arm (one instantiation each): kInterp,
// the interpolation's precision (march_interp; march_common.cuh:interp8),
// and kBf16, the head at the TPU's DEFAULT precision, which the port ties
// to march_bwd_dtype = bfloat16 so that K3's bf16 sweep differentiates the
// head K2 ran: the PE features and every hidden activation are rounded to
// bf16 as they are stored, and the wrapper passes the weights rounded to
// bf16 (the biases stay fp32). A product of two bf16 values is exact in
// fp32, so each sum is still one fp32 chain in k order.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "march_common.cuh"

namespace cg = cooperative_groups;

namespace {

using march::kLanes;

constexpr int kCluster = 2;               // CTAs a cluster
constexpr int kRays = 16;                 // rays a cluster
constexpr int kThreads = kRays * kLanes;  // 128: the march's 8 lanes a ray
constexpr int kW = 128;                   // head width, padded
constexpr int kIn = 60;                   // PE features, padded
constexpr int kMaxDeg = kIn / 6;
constexpr int kCols = kW / kCluster;      // columns a CTA
// Row stride of the activations [k][ray]: 16 rays and 4 floats of
// padding, so that a warp's float4 stores of 32 rows fall in different
// banks (2-way, where a stride of 16 would be 8-way).
constexpr int kLd = kRays + 4;
constexpr float kHalfPi = 1.5707963267948966f;
constexpr int kQuads = kThreads / 32;     // warps: a warp 4 rays
// The layers: a thread sums 2 columns for its warp's 4 rays.
static_assert(kCols == 2 * 32 && kRays == 4 * kQuads,
              "a thread: 2 columns x 4 rays");

// Shared memory, in floats; every block 16-byte aligned.
constexpr int kOffW0 = 0;                          // [kIn][kW], whole
constexpr int kOffW1 = kOffW0 + kIn * kW;          // [kW][kCols]
constexpr int kOffW2 = kOffW1 + kW * kCols;        // [kW][kCols]
constexpr int kOffW3 = kOffW2 + kW * kCols;        // [kW + kIn][kCols]
constexpr int kOffB0 = kOffW3 + (kW + kIn) * kCols; // [kW], whole
constexpr int kOffB = kOffB0 + kW;                 // [3][kCols]
constexpr int kOffWo = kOffB + 3 * kCols;          // [kW][4], whole
constexpr int kOffBo = kOffWo + kW * 4;            // [4]
constexpr int kOffX = kOffBo + 4;                  // [kIn][kLd]
constexpr int kOffHa = kOffX + kIn * kLd;          // [kW][kLd]: h0, h2
constexpr int kOffHb = kOffHa + kW * kLd;          // [kW][kLd]: h1
constexpr int kOffHc = kOffHb + kW * kLd;          // [kW][kLd]: h3
constexpr int kOffWin = kOffHc + kW * kLd;         // [16]
constexpr int kOffBar = kOffWin + 16;              // [kQuads][2] mbarriers
constexpr int kSmemFloats = kOffBar + 2 * 2 * kQuads;
constexpr int kSmemBytes = 4 * kSmemFloats;
static_assert(kOffX % 4 == 0 && kOffHa % 4 == 0 && kOffHb % 4 == 0 &&
                  kOffHc % 4 == 0 && kOffB % 4 == 0,
              "activation rows are read as float4");
static_assert(kOffBar % 2 == 0, "an mbarrier is 8-byte aligned");
static_assert(kSmemBytes <= 232448, "a block's shared memory");

struct So3Args {
  const float* origins;  // [B, 3]
  const float* dirs;     // [B, 3]
  march::Grid grid;
  // The head in nn.Linear layout: W_l [out][in], b_l [out].
  const float *w0, *b0, *w1, *b1, *w2, *b2, *w3, *b3, *wo, *bo;
  const float* window;   // [max_deg] annealing weights
  float* traj;           // [B, S, 11]
  int batch, num_samples, max_deg, in_dim, width;
  float near, step;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// dst[k][c] = w[col0 + c][koff + k] for c < cols (ld floats a row of w)
// where k < kn and col0 + c < width; zero for the rest of the rows <
// krows.
__device__ __forceinline__ void load_cols(float* dst, const float* w,
                                          int ld, int koff, int kn,
                                          int krows, int col0, int width,
                                          int cols) {
  for (int e = threadIdx.x; e < krows * cols; e += kThreads) {
    const int k = e / cols, col = col0 + e % cols;
    const bool ok = k < kn && col < width;
    cp_async4(dst + e, ok ? w + (long long)col * ld + koff + k : w, ok);
  }
}

// A warp's exchange with the same warp of the peer CTA (they run the same
// 4 rays). Each warp has two mbarriers, used by alternate exchanges, each
// expecting the peer warp's 32 arrivals a phase: every lane arrives on the
// peer's once its stores into the peer are made, with release semantics at
// cluster scope, and then waits on its own, with acquire. A warp cannot
// run two exchanges ahead of its peer (it needs the peer's columns of each
// layer), so an mbarrier's phase cannot advance twice before both have
// waited on it.
__device__ __forceinline__ void arrive_peer(unsigned bar, int peer) {
  asm volatile(
      "{\n .reg .b32 remote;\n mapa.shared::cluster.u32 remote, %0, %1;\n"
      " mbarrier.arrive.release.cluster.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(bar), "r"(peer)
      : "memory");
}

__device__ __forceinline__ void wait_peer(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred done;\n"
      "WAIT:\n"
      " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0],"
      " %1;\n"
      " @!done bra WAIT;\n}\n" ::"r"(bar), "r"(parity)
      : "memory");
}

__device__ __forceinline__ float safe_norm(float x, float y, float z) {
  return sqrtf(fmaxf(x * x + y * y + z * z, 1e-6f));
}

// acc[c][r] += in[k][4 q + r] * w[k][2 cp + c] for k < K, in k order; w
// has LDW floats a row.
template <int K, int LDW>
__device__ __forceinline__ void sum_rows(const float* w, const float* in,
                                         int cp, int q, float (&acc)[2][4]) {
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    const float2 wk = *reinterpret_cast<const float2*>(w + k * LDW + 2 * cp);
    const float4 x = *reinterpret_cast<const float4*>(in + k * kLd + 4 * q);
    acc[0][0] = __fmaf_rn(x.x, wk.x, acc[0][0]);
    acc[0][1] = __fmaf_rn(x.y, wk.x, acc[0][1]);
    acc[0][2] = __fmaf_rn(x.z, wk.x, acc[0][2]);
    acc[0][3] = __fmaf_rn(x.w, wk.x, acc[0][3]);
    acc[1][0] = __fmaf_rn(x.x, wk.y, acc[1][0]);
    acc[1][1] = __fmaf_rn(x.y, wk.y, acc[1][1]);
    acc[1][2] = __fmaf_rn(x.z, wk.y, acc[1][2]);
    acc[1][3] = __fmaf_rn(x.w, wk.y, acc[1][3]);
  }
}

// One hidden layer for rays 4 q .. 4 q + 3 of the cluster and the columns
// col, col + 1 (w and bias start at this thread's column block, 2 cp
// columns in): ReLU(sum over in_a's KA rows, then in_b's KB rows, of
// in[k][ray] * w[k][c], from zero in k order, + b), written to out[col]
// here and, unless out_peer is null, in the peer CTA.
template <int KA, int KB, int LDW, bool kBf16>
__device__ __forceinline__ void hidden_layer(const float* w,
                                             const float* bias,
                                             const float* in_a,
                                             const float* in_b, float* out,
                                             float* out_peer, int cp, int col,
                                             int q) {
  float acc[2][4];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[c][r] = 0.0f;
  sum_rows<KA, LDW>(w, in_a, cp, q, acc);
  if constexpr (KB > 0) sum_rows<KB, LDW>(w + KA * LDW, in_b, cp, q, acc);
  const float2 b = *reinterpret_cast<const float2*>(bias + 2 * cp);
  auto act = [](float v) {
    v = fmaxf(v, 0.0f);
    return kBf16 ? march::bf16r(v) : v;
  };
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const float bc = c == 0 ? b.x : b.y;
    const float4 o = make_float4(act(acc[c][0] + bc), act(acc[c][1] + bc),
                                 act(acc[c][2] + bc), act(acc[c][3] + bc));
    *reinterpret_cast<float4*>(out + (col + c) * kLd + 4 * q) = o;
    if (out_peer)
      *reinterpret_cast<float4*>(out_peer + (col + c) * kLd + 4 * q) = o;
  }
}

template <int kInterp, bool kBf16>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kThreads, 1) march_so3_kernel(const So3Args a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int W = a.width, IN = a.in_dim;
  const int col0 = rank * kCols;

  // The weights, once: layer 0 and the output layer whole, this CTA's
  // columns of layers 1-3, the window.
  load_cols(sm + kOffW0, a.w0, IN, 0, IN, kIn, 0, W, kW);
  load_cols(sm + kOffW1, a.w1, W, 0, W, kW, col0, W, kCols);
  load_cols(sm + kOffW2, a.w2, W, 0, W, kW, col0, W, kCols);
  load_cols(sm + kOffW3, a.w3, W + IN, 0, W, kW, col0, W, kCols);
  load_cols(sm + kOffW3 + kW * kCols, a.w3, W + IN, W, IN, kIn, col0, W,
            kCols);
  for (int e = tid; e < kW; e += kThreads)
    cp_async4(sm + kOffB0 + e, e < W ? a.b0 + e : a.b0, e < W);
  {
    const float* bs[3] = {a.b1, a.b2, a.b3};
    for (int e = tid; e < 3 * kCols; e += kThreads) {
      const int col = col0 + e % kCols;
      const float* b = bs[e / kCols];
      cp_async4(sm + kOffB + e, col < W ? b + col : b, col < W);
    }
  }
  for (int e = tid; e < kW * 4; e += kThreads) {
    const int k = e / 4, o = e % 4;
    const bool ok = k < W && o < 3;
    cp_async4(sm + kOffWo + e, ok ? a.wo + o * W + k : a.wo, ok);
  }
  if (tid < 4) cp_async4(sm + kOffBo + tid, tid < 3 ? a.bo + tid : a.bo,
                         tid < 3);
  if (tid < 16) sm[kOffWin + tid] = tid < a.max_deg ? a.window[tid] : 0.0f;
  const unsigned bars =
      static_cast<unsigned>(__cvta_generic_to_shared(sm + kOffBar));
  if (tid < 2 * kQuads)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 32;\n" ::"r"(
                     bars + 8 * tid)
                 : "memory");
  asm volatile(
      "cp.async.wait_all;\n"
      "fence.mbarrier_init.release.cluster;\n" ::: "memory");
  // Both CTAs have started, hold their weights and have set up their
  // mbarriers before either writes into the other's shared memory.
  cluster.sync();

  const float* w0 = sm + kOffW0;
  const float* w1 = sm + kOffW1;
  const float* w2 = sm + kOffW2;
  const float* w3 = sm + kOffW3;
  const float* b0 = sm + kOffB0;
  const float* bias = sm + kOffB;
  const float* wo = sm + kOffWo;
  const float* bo = sm + kOffBo;
  const float* win = sm + kOffWin;
  float* x_s = sm + kOffX;
  float* ha = sm + kOffHa;
  float* hb = sm + kOffHb;
  float* hc = sm + kOffHc;
  float* ha_peer = cluster.map_shared_rank(ha, rank ^ 1);
  float* hb_peer = cluster.map_shared_rank(hb, rank ^ 1);
  float* hc_peer = cluster.map_shared_rank(hc, rank ^ 1);

  // The march: 8 lanes a ray.
  const int lane = tid % kLanes, local = tid / kLanes;
  const int want = (blockIdx.x / kCluster) * kRays + local;
  const bool valid = want < a.batch;
  const int ray = valid ? want : a.batch - 1;
  // Rank r writes the trajectory of the cluster's rays 8 r .. 8 r + 7.
  const bool writer = valid && local / (kRays / kCluster) == rank;
  float dx = a.dirs[3 * ray], dy = a.dirs[3 * ray + 1],
        dz = a.dirs[3 * ray + 2];
  float px = a.origins[3 * ray] + a.near * dx;
  float py = a.origins[3 * ray + 1] + a.near * dy;
  float pz = a.origins[3 * ray + 2] + a.near * dz;
  float t = a.near;
  float* traj = a.traj + (long long)ray * a.num_samples * 11;
  // The head: warp q runs the rays 4 q .. 4 q + 3 through every layer,
  // columns 2 cp, 2 cp + 1 of a column block a lane; it exchanges columns
  // with warp q of the peer only (no barrier across the CTA).
  const int cp = tid % 32, q = tid / 32;
  unsigned exchanges = 0;
  auto exchange = [&]() {
    const unsigned bar = bars + 8 * (2 * q + (exchanges & 1));
    arrive_peer(bar, rank ^ 1);
    wait_peer(bar, (exchanges >> 1) & 1);
    __syncwarp();
    ++exchanges;
  };
  // Features past IN stay zero: they meet zero weights.
  for (int i = tid; i < kIn * kLd; i += kThreads)
    if (i / kLd >= IN) x_s[i] = 0.0f;
  __syncthreads();
  // This step's corner of the cell and its value, loaded a step ahead.
  march::Corner cn = march::corner8(a.grid, px, py, pz, lane);
  float4 cv = march::load_now(cn.addr);

  for (int s = 0; s < a.num_samples; ++s) {
    const float4 v = march::interp8<kInterp>(cv, cn, lane);
    const float n = v.x, gx = v.y, gy = v.z, gz = v.w;
    // The next position does not wait for the head: its corner loads
    // while the head runs.
    float qx, qy, qz;
    march::next_position(a.step, n, px, py, pz, dx, dy, dz, qx, qy, qz);
    cn = march::corner8(a.grid, qx, qy, qz, lane);
    cv = march::load_now(cn.addr);
    const bool act = valid && sqrtf(gx * gx + gy * gy + gz * gz) > 1e-3f;
    if (writer) {
      float* o = traj + 11 * (long long)s;
      o[lane] = lane == 0 ? px : lane == 1 ? py : lane == 2 ? pz
              : lane == 3 ? dx : lane == 4 ? dy : lane == 5 ? dz
              : lane == 6 ? t : n;
      if (lane < 3) o[8 + lane] = lane == 0 ? gx : lane == 1 ? gy : gz;
    }
    float ux = gx, uy = gy, uz = gz;
    // The head runs where any of the warp's 4 rays is active: the same in
    // the peer's warp, so both take every exchange.
    if (__any_sync(0xffffffffu, act)) {
      if (act) {
        // The ray's PE, by its own 8 lanes: features lane, lane + 8, ...
        for (int f = lane; f < IN; f += kLanes) {
          const int deg = f / 6, c = f % 3;
          const float pc = c == 0 ? px : c == 1 ? py : pz;
          const float xb = pc * (float)(1 << deg);
          const float arg = (f % 6) < 3 ? xb : xb + kHalfPi;
          const float x = sinf(arg) * win[deg];
          x_s[f * kLd + local] = kBf16 ? march::bf16r(x) : x;
        }
      }
      __syncwarp();
      // Layer 0 whole in each CTA, so that it needs no exchange.
      hidden_layer<kIn, 0, kW, kBf16>(w0, b0, x_s, nullptr, ha, nullptr, cp,
                                      2 * cp, q);
      hidden_layer<kIn, 0, kW, kBf16>(w0 + kCols, b0 + kCols, x_s, nullptr,
                                      ha, nullptr, cp, kCols + 2 * cp, q);
      __syncwarp();
      hidden_layer<kW, 0, kCols, kBf16>(w1, bias, ha, nullptr, hb, hb_peer,
                                        cp, col0 + 2 * cp, q);
      exchange();
      hidden_layer<kW, 0, kCols, kBf16>(w2, bias + kCols, hb, nullptr, ha,
                                        ha_peer, cp, col0 + 2 * cp, q);
      exchange();
      hidden_layer<kW, kIn, kCols, kBf16>(w3, bias + 2 * kCols, ha, x_s, hc,
                                          hc_peer, cp, col0 + 2 * cp, q);
      exchange();
      // The output layer: lane o < 3 of each ray sums raw[o] in k order;
      // the ray's lanes then share it.
      float raw = 0.0f;
      if (act && lane < 3) {
        float acc = 0.0f;
#pragma unroll 16
        for (int k = 0; k < kW; ++k)
          acc = __fmaf_rn(hc[k * kLd + local], wo[4 * k + lane], acc);
        raw = acc + bo[lane];
      }
      const int base = tid % 32 - lane;
      const float rx = __shfl_sync(0xffffffffu, raw, base);
      const float ry = __shfl_sync(0xffffffffu, raw, base + 1);
      const float rz = __shfl_sync(0xffffffffu, raw, base + 2);
      if (act) {
        // ops/eikonal.rodrigues_rotate, term by term in its order.
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
    }
    march::finish_step(a.step, ux, uy, uz, qx, qy, qz, px, py, pz, dx, dy,
                       dz, t);
  }
  // Neither CTA leaves while the other may still write into it.
  cluster.sync();
}

// K2 in one arm, its dynamic shared memory raised once.
template <int kInterp, bool kBf16>
cudaError_t launch_so3(const So3Args& a, int ctas, cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        march_so3_kernel<kInterp, kBf16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  march_so3_kernel<kInterp, kBf16><<<ctas, kThreads, kSmemBytes, stream>>>(
      a);
  return cudaGetLastError();
}

template <bool kBf16>
cudaError_t launch_so3(const So3Args& a, int ctas, int interp,
                       cudaStream_t stream) {
  return interp == march::kHighest
             ? launch_so3<march::kHighest, kBf16>(a, ctas, stream)
         : interp == march::kHigh
             ? launch_so3<march::kHigh, kBf16>(a, ctas, stream)
             : launch_so3<march::kDefault, kBf16>(a, ctas, stream);
}

}  // namespace

// The launch geometry is march_kernel.so3_launch_geometry's; the caller
// passes it and it is checked here again. interp: march_common.cuh's
// kHighest, kHigh or kDefault; bf16: the head's arm (the weights already
// rounded to bf16 by the caller).
extern "C" int march_so3_launch(
    const float* origins, const float* dirs, const float* grid,
    const float* w0, const float* b0, const float* w1, const float* b1,
    const float* w2, const float* b2, const float* w3, const float* b3,
    const float* wo, const float* bo, const float* window, float* traj,
    int batch, int num_samples, int max_deg, int width, int nx, int ny,
    int nz, float near, float step, float nmin_x, float nmin_y,
    float nmin_z, float nd_x, float nd_y, float nd_z, int cluster,
    int rays_per_cluster, int ctas, int threads, int smem_bytes, int interp,
    int bf16, void* stream) {
  const int clusters = (batch + kRays - 1) / kRays;
  if (batch < 1 || width < 1 || width > kW || max_deg < 1 ||
      max_deg > kMaxDeg || cluster != kCluster ||
      rays_per_cluster != kRays || ctas != kCluster * clusters ||
      threads != kThreads || smem_bytes != kSmemBytes ||
      (interp != march::kHighest && interp != march::kHigh &&
       interp != march::kDefault) ||
      (bf16 != 0 && bf16 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  So3Args a;
  a.origins = origins;
  a.dirs = dirs;
  a.grid = {reinterpret_cast<const float4*>(grid), nx, ny, nz,
            nmin_x, nmin_y, nmin_z, nd_x, nd_y, nd_z,
            1.0f / nd_x, 1.0f / nd_y, 1.0f / nd_z};
  a.w0 = w0; a.b0 = b0; a.w1 = w1; a.b1 = b1; a.w2 = w2; a.b2 = b2;
  a.w3 = w3; a.b3 = b3; a.wo = wo; a.bo = bo;
  a.window = window;
  a.traj = traj;
  a.batch = batch;
  a.num_samples = num_samples;
  a.max_deg = max_deg;
  a.in_dim = 6 * max_deg;
  a.width = width;
  a.near = near;
  a.step = step;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? launch_so3<true>(a, ctas, interp, s)
                               : launch_so3<false>(a, ctas, interp, s));
}
