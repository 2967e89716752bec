// K3: the reverse sweep of the 'all'-stage march (K2), hand-written for
// Hopper (sm_90a).
//
// Replaces samplenerfro_tpu/ops/pallas/march_bwd_kernel.py:_bwd_kernel,
// reached there through march_bwd_pallas as the backward of
// ops/eikonal_vjp.make_march_allstage. Its design is the JAX package's
// other backward, bwd_impl="passes" (samplenerfro_tpu/ops/eikonal_vjp.py:
// 209-444): the step adjoints are linear in the state cotangents (pbar,
// dbar) with coefficients that depend only on stored forward values, so
// the so3 head leaves the sequential loop.
//
// What it computes: the cotangents of K2's inputs (origins, directions,
// the annealing alpha and every so3 weight and bias) from the cotangents
// of its trajectory. Walking s = S-1 .. 0 with (pbar, dbar) the
// cotangents of (p_{s+1}, d_{s+1}) (eikonal_vjp.py:11-25):
//   pbar' = pbar + h K_s dbar + a_s (-(h / n_s^2) pbar . d_s) + c_p,s
//   dbar' = dbar + (h / n_s) pbar + c_d,s
// with a = dn/dp, B = dg/dp (the trilinear derivative at p_s), and at the
// active ray-steps (|g_s| > 1e-3) K = Jp^T + B^T Jg^T, Jp = du/dp through
// the annealed PE, the head and Rodrigues, Jg = du/dg; elsewhere K = B^T.
// c_p = a (dn_s - segbar_s (h / n^2) |d|) + B^T dg_s + dp_s and c_d = dd_s
// + segbar_s (h / n) d / |d| gather the direct cotangents (the wrapper has
// turned the direction cotangent into the raw direction's and the
// arclength's into segbar_s = sum_{k>s} ddist_k). The head's weight and
// window cotangents are then one batched VJP at ubar_s = h dbar_{s+1} over
// the active ray-steps.
//
// Five launches, one wrapper call:
//  1a. k3_pieces: one thread a ray-step: the trilinear derivative (the 8
//      corner gathers), inv_n, c_p, c_d and K = B^T, stored field-major
//      for the sweep ([S][22][Bp], Bp the rays rounded up to 32).
//  1b. k3_jacobians: the active ray-steps, compacted in order into tiles
//      of 64 by a grid of blocks that each own a contiguous range of
//      ray-steps. Per tile: the annealed PE and its derivative, each
//      hidden layer forward and then its three tangents (one per axis of
//      p), each a product of the tile's 64 rows with the layer's weights
//      on the CUDA-core engine of mlp_common.cuh (weights streamed from L2
//      in k-slabs through the cp.async ring, 8 x 8 register tiles a
//      lane), then the output layer, Rodrigues' Jacobians (its adjoint at
//      three unit cotangents) and K, written over B^T.
//  2.  k3_sweep: the recurrence above, one thread a ray, 32 rays a block
//      (a block per 32 rays spreads 1,024 rays over 32 SMs), the pieces
//      of 8 steps staged by cp.async while the 8 before are swept. It
//      writes dbar_{s+1} at every ray-step and (pbar_0, dbar_0).
//  3.  k3_params: as 1b, a fixed grid of blocks over contiguous ranges,
//      compacting the active ray-steps into tiles of 64. Per tile: the
//      head's forward again (the same device functions as 1b), rawbar by
//      the Rodrigues adjoint at ubar, the cotangents of each layer (dZ
//      W^T on the engine, masked by the stored activations), and each
//      layer's dW = A^T dZ over the tile's rows on the engine, added into
//      the block's own [P] slice of a [G, P] partial; the first layer's
//      and the skip rows' products are taken against the PE's sines
//      before the window, so that the wrapper gets the window's cotangent
//      from them (W . G summed per degree) and scales them by the window
//      into dW.
//  4.  k3_reduce: sums the G partials of each parameter in block order.
// Every sum is owned by one thread and runs in a fixed order; no atomics,
// so two runs agree bit for bit.
//
// The head's products are fp32 sums on CUDA cores that start from zero and
// run in k order over the layer's input, then the skip input, then + bias:
// the rounding points of the first version's gemv_tile and of K2. Tensor
// cores would flip ReLU masks near 0 (PERF.md). The hidden layers are
// computed at width 128: a narrower head is zero-padded by the wrapper
// (zero units add exact zeros to every sum).
//
// What bounds it: the head's arithmetic at the active ray-steps. This
// design runs seven head products a ray-step (1b: forward and three
// tangents; 3: forward, cotangents, dW), 7/3 of the bound's three, fp32
// on CUDA cores; besides, it streams the trajectory and its cotangent
// once, the pieces out and back in (88 bytes a ray-step) and each block's
// 262 KB partial through L2 once a tile.
//
// The file also holds P3 (so3_preacts_launch), which computes the head's
// pre-activations with 1b's and 3's forward (so3_encode, so3_layer), so
// that ReLU masks can be held against another summation order's.

#include "mlp_common.cuh"

namespace {

using Seg = fused_mlp::ASeg<float>;
using Engine = fused_mlp::Simt<128, float>;

constexpr int kThreads = fused_mlp::kThreads;  // 256
constexpr int kW = 128;        // hidden width of the products
constexpr int kTile = Engine::kRows;  // 64 ray-steps a tile
constexpr int kIn = 64;        // PE columns kept; zero past 6 * max_deg
constexpr int kLdH = kW + 4;   // shared-memory rows padded by 16 bytes
constexpr int kLdX = kIn + 4;
constexpr int kMaxDeg = 10;
constexpr int kFields = 22;    // pieces a ray-step: K 9, a 3, inv_n,
                               // c_p 3, c_d 3, d 3
constexpr int kChunk = 8;      // steps a sweep stage holds
constexpr int kRing = fused_mlp::kStages * 16 * kLdH;  // floats
constexpr float kHalfPi = 1.5707963267948966f;

// The engine's k-slab pipeline in fp32: 16 weight rows a slab.
struct Pol {
  using Elem = float;
  static constexpr int kSlab = 16;
};

// The head's weights. Forward pack, input-major, hidden units padded to
// kW: W0t [I][kW] b0 W1t [kW][kW] b1 W2t b2 W3t [kW + I][kW] b3 Woutt
// [kW][3] bout. Backward pack, nn.Linear layout [out][in]: W1, W2 and the
// first kW inputs of W3, each [kW][kW].
struct Net {
  const float *w0t, *b0, *w1t, *b1, *w2t, *b2, *w3t, *b3, *wot, *bo;
  const float *w1, *w2, *w3;
  int in_dim;
};

__device__ __forceinline__ Net make_net(const float* fwd, const float* bwd,
                                        int in_dim) {
  Net n;
  const int I = in_dim;
  n.in_dim = I;
  n.w0t = fwd;           n.b0 = n.w0t + I * kW;
  n.w1t = n.b0 + kW;     n.b1 = n.w1t + kW * kW;
  n.w2t = n.b1 + kW;     n.b2 = n.w2t + kW * kW;
  n.w3t = n.b2 + kW;     n.b3 = n.w3t + (kW + I) * kW;
  n.wot = n.b3 + kW;     n.bo = n.wot + kW * 3;
  n.w1 = bwd;            n.w2 = bwd + kW * kW;
  n.w3 = bwd + 2 * kW * kW;
  return n;
}

// Parameters of the padded forward pack, which the partial mirrors.
__host__ __device__ inline int num_params(int in_dim) {
  return in_dim * kW + kW + 2 * (kW * kW + kW) + (kW + in_dim) * kW + kW +
         kW * 3 + 3;
}

__device__ __forceinline__ float4 lerp4(float4 a, float4 b, float t) {
  const float u = 1.0f - t;
  return make_float4(a.x * u + b.x * t, a.y * u + b.y * t,
                     a.z * u + b.z * t, a.w * u + b.w * t);
}

__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

struct GridArgs {
  const float4* grid;
  int nx, ny, nz;
  float nmin_x, nmin_y, nmin_z;
  float nd_x, nd_y, nd_z;
};

// d(trilinear)/dp of ops/grid.trilinear at p: dv[a] = the derivative of
// the x-then-y-then-z lerps of [n, g] along axis a, over the voxel size
// (the fraction has slope 1 / ndelta; clamped corners give 0).
__device__ void trilinear_jacobian(const GridArgs& a, float px, float py,
                                   float pz, float4 (&dv)[3]) {
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
  const float4 dvx = lerp4(lerp4(sub4(c100, c000), sub4(c110, c010), yd),
                           lerp4(sub4(c101, c001), sub4(c111, c011), yd), zd);
  const float4 dvy = lerp4(sub4(c10, c00), sub4(c11, c01), zd);
  const float4 dvz = sub4(lerp4(c01, c11, yd), lerp4(c00, c10, yd));
  dv[0] = make_float4(dvx.x / a.nd_x, dvx.y / a.nd_x, dvx.z / a.nd_x,
                      dvx.w / a.nd_x);
  dv[1] = make_float4(dvy.x / a.nd_y, dvy.y / a.nd_y, dvy.z / a.nd_y,
                      dvy.w / a.nd_y);
  dv[2] = make_float4(dvz.x / a.nd_z, dvz.y / a.nd_z, dvz.z / a.nd_z,
                      dvz.w / a.nd_z);
}

__device__ __forceinline__ float3 cross3(float3 a, float3 b) {
  return make_float3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
                     a.x * b.y - a.y * b.x);
}

__device__ __forceinline__ float dot3(float3 a, float3 b) {
  return (a.x * b.x + a.y * b.y) + a.z * b.z;
}

// Adjoint of ops/eikonal.rodrigues_rotate (the norms floored at 1e-3):
// the output cotangent ub gives the cotangents of raw and of g.
__device__ void rodrigues_bwd(float3 raw, float3 g, float3 ub, float3* rawbar,
                              float3* gbar) {
  const float eps = 1e-6f;
  const float sq_r = dot3(raw, raw);
  const float theta = sqrtf(fmaxf(sq_r, eps));
  const float ind_r = sq_r > eps ? 1.0f : 0.0f;
  const float3 e = make_float3(raw.x / theta, raw.y / theta, raw.z / theta);
  const float sq_g = dot3(g, g);
  const float a = sqrtf(fmaxf(sq_g, eps));
  const float ind_g = sq_g > eps ? 1.0f : 0.0f;
  const float3 v = make_float3(g.x / a, g.y / a, g.z / a);
  const float c = cosf(theta), s = sinf(theta);
  const float3 exv = cross3(e, v);
  const float wev = dot3(e, v);
  const float3 out = make_float3(
      a * ((c * v.x + s * exv.x) + (1.0f - c) * wev * e.x),
      a * ((c * v.y + s * exv.y) + (1.0f - c) * wev * e.y),
      a * ((c * v.z + s * exv.z) + (1.0f - c) * wev * e.z));
  const float abar = dot3(ub, out) / a;
  const float pdote = dot3(ub, e);
  const float3 uxe = cross3(ub, e);
  const float3 vxu = cross3(v, ub);
  const float3 vbar = make_float3(
      a * c * ub.x + a * s * uxe.x + a * (1.0f - c) * pdote * e.x,
      a * c * ub.y + a * s * uxe.y + a * (1.0f - c) * pdote * e.y,
      a * c * ub.z + a * s * uxe.z + a * (1.0f - c) * pdote * e.z);
  const float3 ebar = make_float3(
      a * s * vxu.x + a * (1.0f - c) * (pdote * v.x + wev * ub.x),
      a * s * vxu.y + a * (1.0f - c) * (pdote * v.y + wev * ub.y),
      a * s * vxu.z + a * (1.0f - c) * (pdote * v.z + wev * ub.z));
  const float3 dt = make_float3(a * (-s * v.x + c * exv.x + s * wev * e.x),
                                a * (-s * v.y + c * exv.y + s * wev * e.y),
                                a * (-s * v.z + c * exv.z + s * wev * e.z));
  float tbar = dot3(ub, dt);
  tbar = tbar - dot3(ebar, e) / theta;
  const float kr = tbar * ind_r / theta;
  *rawbar = make_float3(ebar.x / theta + kr * raw.x,
                        ebar.y / theta + kr * raw.y,
                        ebar.z / theta + kr * raw.z);
  const float vv = ind_g * dot3(vbar, v) / a;
  const float ka = abar * ind_g;
  *gbar = make_float3(vbar.x / a - vv * v.x + ka * v.x,
                      vbar.y / a - vv * v.y + ka * v.y,
                      vbar.z / a - vv * v.z + ka * v.z);
}

__device__ __forceinline__ bool active_g(const float* row) {
  const float gx = row[8], gy = row[9], gz = row[10];
  return sqrtf(gx * gx + gy * gy + gz * gz) > 1e-3f;
}

// ------------------------------------------------- the head on a tile

// The annealed PE of the tile's points p[r] (r < kTile), column f < I of
// degree f / 6, coordinate f % 3, sine for f % 6 < 3 and the sine of the
// argument + pi/2 past it: x[r][f] = sin(arg) * win[deg]; with val, the
// sine itself; with dco, the derivative of x[r][f] along p[r][f % 3],
// cos(arg) 2^deg win[deg]. Columns I .. kIn - 1 are zero.
__device__ void so3_encode(const float (*p)[3], int in_dim, const float* win,
                           float* x, float* val, float* dco) {
  for (int i = threadIdx.x; i < kTile * kIn; i += kThreads) {
    const int r = i / kIn, f = i % kIn;
    float xv = 0.0f, sv = 0.0f, dv = 0.0f;
    if (f < in_dim) {
      const int deg = f / 6, c = f % 3;
      const float scale = (float)(1 << deg);
      const float xb = p[r][c] * scale;
      const float arg = (f % 6) < 3 ? xb : xb + kHalfPi;
      sv = sinf(arg);
      xv = sv * win[deg];
      if (dco) dv = win[deg] * (cosf(arg) * scale);
    }
    x[r * kLdX + f] = xv;
    if (val) val[r * kLdX + f] = sv;
    if (dco) dco[r * kLdX + f] = dv;
  }
}

// One hidden layer of the head on the tile, fp32 on CUDA cores: out[r][c]
// = ReLU(sum_k s0(r, k) W[k][c] + sum_k s1(r, k) W[s0.k + k][c] + b[c]),
// each sum from zero in k order. W is input-major [*][kW] in device
// memory. With pre, the pre-activations of rows r < rows and columns c <
// width also go to pre[r * width + c]. out may be s0's buffer.
__device__ void so3_layer(const Seg& s0, const Seg& s1, const float* w,
                          const float* b, float* out, float* ring,
                          float* pre = nullptr, int rows = 0,
                          int width = 0) {
  Engine e;
  e.zero();
  fused_mlp::weight_product<Pol, kW>(e, s0, s1, w, kW, ring);
  e.template each<false>([&](int, int r, int c, float v0, float v1) {
    v0 += __ldg(b + c);
    v1 += __ldg(b + c + 1);
    if (pre && r < rows) {
      if (c < width) pre[r * width + c] = v0;
      if (c + 1 < width) pre[r * width + c + 1] = v1;
    }
    out[r * kLdH + c] = fmaxf(v0, 0.0f);
    out[r * kLdH + c + 1] = fmaxf(v1, 0.0f);
  });
  __syncthreads();
}

// A layer's product without bias, its output masked by mask[r][c] > 0:
// out[r][c] = (sum_k s0(r, k) W[k][c] + ...) * (mask > 0), W [*][ldw] in
// device memory, its first kW columns. The tangents (W input-major) and
// the cotangents (W in nn.Linear layout) of the head. out may be s0's
// buffer.
__device__ void masked_product(const Seg& s0, const Seg& s1, const float* w,
                               int ldw, const float* mask, float* out,
                               float* ring) {
  Engine e;
  e.zero();
  fused_mlp::weight_product<Pol, kW>(e, s0, s1, w, ldw, ring);
  e.template each<false>([&](int, int r, int c, float v0, float v1) {
    out[r * kLdH + c] = mask[r * kLdH + c] > 0.0f ? v0 : 0.0f;
    out[r * kLdH + c + 1] = mask[r * kLdH + c + 1] > 0.0f ? v1 : 0.0f;
  });
  __syncthreads();
}

// raw[r][o] = sum_k h[r][k] Wout[k][o] (+ bout[o] when bias), k in order.
__device__ void so3_out(const float* h, const Net& n, bool bias,
                        float (*raw)[3]) {
  for (int i = threadIdx.x; i < kTile * 3; i += kThreads) {
    const int r = i / 3, o = i % 3;
    float acc = 0.0f;
    for (int k = 0; k < kW; ++k)
      acc = __fmaf_rn(h[r * kLdH + k], __ldg(n.wot + 3 * k + o), acc);
    raw[r][o] = bias ? acc + __ldg(n.bo + o) : acc;
  }
}

// ------------------------------------------- compaction of active steps

// The active ray-steps of [begin, end), in order, handed to tile(nt) in
// groups of kTile (the last one shorter) as list[0 .. nt).
template <typename Tile>
__device__ void active_tiles(const float* traj, long long begin,
                             long long end, int* list, int* warp_count,
                             Tile tile) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  int count = 0;
  for (long long base = begin; base < end; base += kThreads) {
    const long long idx = base + tid;
    const bool flag = idx < end && active_g(traj + 11 * idx);
    const unsigned ballot = __ballot_sync(0xffffffffu, flag);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      if (w < warp) before += warp_count[w];
      total += warp_count[w];
    }
    if (flag)
      list[count + before + __popc(ballot & ((1u << lane) - 1u))] = (int)idx;
    count += total;
    __syncthreads();
    while (count >= kTile) {
      tile(kTile);
      int keep[2];
      const int rest = count - kTile;
      for (int q = 0; q < 2; ++q) {
        const int i = tid + q * kThreads;
        keep[q] = i < rest ? list[kTile + i] : 0;
      }
      __syncthreads();
      for (int q = 0; q < 2; ++q) {
        const int i = tid + q * kThreads;
        if (i < rest) list[i] = keep[q];
      }
      count = rest;
      __syncthreads();
    }
  }
  if (count > 0) tile(count);
}

struct Args {
  const float* traj;     // [B, S, 11]: p, raw d, t, n, g
  const float* cts;      // [B, S, 11]: dp, dd(raw), segbar, dn, dg
  const float* wfwd;
  const float* wbwd;
  const float* window;   // [max_deg]
  GridArgs grid;
  float* pieces;         // [S][kFields][Bp]
  float* dbar;           // [B * S, 3]: dbar_{s+1} of each ray-step
  float* raybar;         // [B, 6]: pbar_0, dbar_0
  float* partial;        // [G, P]
  int batch, bp, num_samples, max_deg;
  long long chunk;       // ray-steps a block of 1b / 3 owns
  float step;
};

__device__ __forceinline__ float* piece(const Args& a, int s, int f,
                                        int ray) {
  return a.pieces + ((long long)s * kFields + f) * a.bp + ray;
}

// ------------------------------------------------------------ pass 1a

__global__ void __launch_bounds__(256) k3_pieces(const Args a) {
  const long long i = blockIdx.x * 256LL + threadIdx.x;
  const long long total = (long long)a.batch * a.num_samples;
  if (i >= total) return;
  const int s = (int)(i / a.batch), ray = (int)(i % a.batch);
  const long long row = (long long)ray * a.num_samples + s;
  const float* tr = a.traj + 11 * row;
  const float* ct = a.cts + 11 * row;
  const float h = a.step;
  const float dx = tr[3], dy = tr[4], dz = tr[5], n = tr[7];
  float4 dv[3];
  trilinear_jacobian(a.grid, tr[0], tr[1], tr[2], dv);
  // a_vec[c] = dn/dp_c; bg[j][c] = dg_j/dp_c.
  const float av[3] = {dv[0].x, dv[1].x, dv[2].x};
  const float bg[3][3] = {{dv[0].y, dv[1].y, dv[2].y},
                          {dv[0].z, dv[1].z, dv[2].z},
                          {dv[0].w, dv[1].w, dv[2].w}};
  const float sb = ct[6];
  const float dlen = sqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-6f));
  const float inv_n = 1.0f / n;
  const float hn = h * inv_n, hn2 = h * inv_n * inv_n;
  const float c_n = ct[7] - sb * hn2 * dlen;
  const float d3[3] = {dx, dy, dz};
  for (int c = 0; c < 3; ++c) {
    for (int k = 0; k < 3; ++k) *piece(a, s, 3 * c + k, ray) = bg[k][c];
    *piece(a, s, 9 + c, ray) = av[c];
    const float btdg = (bg[0][c] * ct[8] + bg[1][c] * ct[9]) + bg[2][c] * ct[10];
    *piece(a, s, 13 + c, ray) = (av[c] * c_n + btdg) + ct[c];
    *piece(a, s, 16 + c, ray) = ct[3 + c] + sb * hn * d3[c] / dlen;
    *piece(a, s, 19 + c, ray) = d3[c];
  }
  *piece(a, s, 12, ray) = inv_n;
}

// ------------------------------------------------------------ pass 1b

struct JacSmem {
  float x[kTile * kLdX];
  float dco[kTile * kLdX];      // then a tangent's skip input
  float h[kTile * kLdH];
  float t[3][kTile * kLdH];
  float ring[kRing];
  float p[kTile][3];
  float raw[kTile][3];
  float traw[3][kTile][3];
  float win[kMaxDeg];
  int list[kThreads + kTile];
  int warp_count[kThreads / 32];
};

// The tangent of the PE along axis c: dco's columns of coordinate c.
__device__ void tangent_input(const float* dco, int c, float* out, int ld) {
  for (int i = threadIdx.x; i < kTile * kIn; i += kThreads) {
    const int r = i / kIn, f = i % kIn;
    out[r * ld + f] = f % 3 == c ? dco[r * kLdX + f] : 0.0f;
  }
}

__device__ void jacobian_tile(const Args& a, const Net& net, JacSmem& m,
                              int nt) {
  const int tid = threadIdx.x, I = net.in_dim;
  for (int i = tid; i < kTile * 3; i += kThreads) {
    const int r = i / 3, c = i % 3;
    m.p[r][c] = r < nt ? a.traj[11 * (long long)m.list[r] + c] : 0.0f;
  }
  __syncthreads();
  so3_encode(m.p, I, m.win, m.x, nullptr, m.dco);
  __syncthreads();
  const Seg none = {nullptr, 0, 0};
  const float* wt[4] = {net.w0t, net.w1t, net.w2t, net.w3t};
  const float* bs[4] = {net.b0, net.b1, net.b2, net.b3};
  for (int l = 0; l < 4; ++l) {
    // Forward, into h (over its input past layer 0).
    const Seg in = l == 0 ? Seg{m.x, kLdX, I} : Seg{m.h, kLdH, kW};
    so3_layer(in, l == 3 ? Seg{m.x, kLdX, I} : none, wt[l], bs[l], m.h,
              m.ring);
    // The three tangents, each over its own input, masked by h.
    for (int c = 0; c < 3; ++c) {
      if (l == 0) tangent_input(m.dco, c, m.t[c], kLdH);
      if (l == 3) tangent_input(m.dco, c, m.x, kLdX);  // x is free now
      if (l == 0 || l == 3) __syncthreads();
      const Seg tin = l == 0 ? Seg{m.t[c], kLdH, I} : Seg{m.t[c], kLdH, kW};
      masked_product(tin, l == 3 ? Seg{m.x, kLdX, I} : none, wt[l], kW, m.h,
                     m.t[c], m.ring);
    }
  }
  so3_out(m.h, net, true, m.raw);
  for (int i = tid; i < 3 * kTile * 3; i += kThreads) {
    const int c = i / (kTile * 3), r = (i / 3) % kTile, o = i % 3;
    float acc = 0.0f;
    for (int k = 0; k < kW; ++k)
      acc = __fmaf_rn(m.t[c][r * kLdH + k], __ldg(net.wot + 3 * k + o), acc);
    m.traw[c][r][o] = acc;
  }
  __syncthreads();
  if (tid < nt) {
    const long long idx = m.list[tid];
    const int ray = (int)(idx / a.num_samples);
    const int s = (int)(idx % a.num_samples);
    const float* tr = a.traj + 11 * idx;
    const float3 raw = make_float3(m.raw[tid][0], m.raw[tid][1],
                                   m.raw[tid][2]);
    const float3 g = make_float3(tr[8], tr[9], tr[10]);
    // Row i of du/draw and of du/dg: the adjoint at the unit cotangent e_i.
    float jp[3][3], jg[3][3];
    for (int i = 0; i < 3; ++i) {
      float3 rb, gb;
      rodrigues_bwd(raw, g,
                    make_float3(i == 0 ? 1.f : 0.f, i == 1 ? 1.f : 0.f,
                                i == 2 ? 1.f : 0.f),
                    &rb, &gb);
      for (int c = 0; c < 3; ++c) {
        // du_i/dp_c = du_i/draw . draw/dp_c.
        jp[i][c] = (rb.x * m.traw[c][tid][0] + rb.y * m.traw[c][tid][1]) +
                   rb.z * m.traw[c][tid][2];
      }
      jg[i][0] = gb.x;
      jg[i][1] = gb.y;
      jg[i][2] = gb.z;
    }
    // K[c][k] = Jp[k][c] + sum_j B[j][c] Jg[k][j], B^T read from K.
    float bt[3][3];
    for (int c = 0; c < 3; ++c)
      for (int j = 0; j < 3; ++j) bt[c][j] = *piece(a, s, 3 * c + j, ray);
    for (int c = 0; c < 3; ++c)
      for (int k = 0; k < 3; ++k)
        *piece(a, s, 3 * c + k, ray) =
            jp[k][c] +
            ((bt[c][0] * jg[k][0] + bt[c][1] * jg[k][1]) + bt[c][2] * jg[k][2]);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) k3_jacobians(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  JacSmem& m = *reinterpret_cast<JacSmem*>(smem_raw);
  const Net net = make_net(a.wfwd, a.wbwd, 6 * a.max_deg);
  if (threadIdx.x < a.max_deg) m.win[threadIdx.x] = a.window[threadIdx.x];
  __syncthreads();
  const long long total = (long long)a.batch * a.num_samples;
  const long long begin = blockIdx.x * a.chunk;
  const long long end = begin + a.chunk < total ? begin + a.chunk : total;
  active_tiles(a.traj, begin, end, m.list, m.warp_count,
               [&](int nt) { jacobian_tile(a, net, m, nt); });
}

// ------------------------------------------------------------- pass 2

__global__ void __launch_bounds__(32) k3_sweep(const Args a) {
  __shared__ __align__(16) float buf[2][kChunk][kFields][32];
  const int lane = threadIdx.x, ray0 = blockIdx.x * 32, ray = ray0 + lane;
  const int S = a.num_samples;
  const int chunks = (S + kChunk - 1) / kChunk;
  const float h = a.step;
  // Chunk j holds steps [S - (j + 1) kChunk, S - j kChunk), clipped at 0.
  auto load = [&](int j) {
    const int s0 = S - (j + 1) * kChunk;
    float(*dst)[kFields][32] = buf[j & 1];
    for (int i = lane; i < kChunk * kFields * 8; i += 32) {
      const int st = i / (kFields * 8), f = (i / 8) % kFields, q = i % 8;
      const int s = s0 + st;
      if (s >= 0)
        fused_mlp::cp_async16(&dst[st][f][4 * q], piece(a, s, f, ray0 + 4 * q),
                              16);
    }
  };
  float pb[3] = {0.f, 0.f, 0.f}, db[3] = {0.f, 0.f, 0.f};
  load(0);
  fused_mlp::cp_async_commit();
  for (int j = 0; j < chunks; ++j) {
    if (j + 1 < chunks) load(j + 1);
    fused_mlp::cp_async_commit();
    fused_mlp::cp_async_wait<1>();
    __syncwarp();
    const int s0 = S - (j + 1) * kChunk;
    const float(*src)[kFields][32] = buf[j & 1];
    for (int st = kChunk - 1; st >= 0; --st) {
      const int s = s0 + st;
      if (s < 0) break;
      float v[kFields];
#pragma unroll
      for (int f = 0; f < kFields; ++f) v[f] = src[st][f][lane];
      if (ray < a.batch) {
        float* out = a.dbar + 3 * ((long long)ray * S + s);
        out[0] = db[0];
        out[1] = db[1];
        out[2] = db[2];
      }
      const float inv_n = v[12];
      const float pdot = (pb[0] * v[19] + pb[1] * v[20]) + pb[2] * v[21];
      const float coef = -(h * inv_n * inv_n) * pdot;
      const float hn = h * inv_n;
      float np[3], nd[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float kd = (v[3 * c] * db[0] + v[3 * c + 1] * db[1]) +
                         v[3 * c + 2] * db[2];
        np[c] = ((pb[c] + h * kd) + v[9 + c] * coef) + v[13 + c];
        nd[c] = (db[c] + hn * pb[c]) + v[16 + c];
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        pb[c] = np[c];
        db[c] = nd[c];
      }
    }
    __syncwarp();
  }
  fused_mlp::cp_async_wait<0>();
  if (ray < a.batch) {
    float* rb = a.raybar + 6 * (long long)ray;
    for (int c = 0; c < 3; ++c) {
      rb[c] = pb[c];
      rb[3 + c] = db[c];
    }
  }
}

// ------------------------------------------------------------- pass 3

struct ParamSmem {
  float x[kTile * kLdX];
  float val[kTile * kLdX];
  float h[4][kTile * kLdH];   // h[3] then each layer's cotangent in turn
  float ring[kRing];
  float p[kTile][3];
  float raw[kTile][3];
  float rb[kTile][3];
  float win[kMaxDeg];
  int list[kThreads + kTile];
  int warp_count[kThreads / 32];
};

// part[(row0 + m) * kW + c] += sum_r A[r][m0 + m] Z[r][c] over the tile's
// rows in order, for m0 + m < mrows: A [kTile][lda], Z [kTile][kLdH] in
// shared memory.
__device__ void grad_product(const float* A, int lda, int m0, int mrows,
                             const float* Z, float* part, int row0) {
  Engine e;
  e.zero();
  for (int k = 0; k < kTile; k += Engine::kK)
    e.step_t(A + k * lda + m0, lda, Z + k * kLdH, kLdH);
  e.template each<true>([&](int, int r, int c, float v0, float v1) {
    const int m = m0 + r;
    if (m >= mrows) return;
    float* q = part + (long long)(row0 + m) * kW + c;
    q[0] += v0;
    q[1] += v1;
  });
}

// bias[c] += sum_r Z[r][c] over the tile's rows in order.
__device__ void bias_sum(const float* Z, float* bias) {
  for (int c = threadIdx.x; c < kW; c += kThreads) {
    float s = 0.0f;
    for (int r = 0; r < kTile; ++r) s += Z[r * kLdH + c];
    bias[c] += s;
  }
}

__device__ void param_tile(const Args& a, const Net& net, ParamSmem& m,
                           float* part, int nt) {
  const int tid = threadIdx.x, I = net.in_dim;
  const float h = a.step;
  for (int i = tid; i < kTile * 3; i += kThreads) {
    const int r = i / 3, c = i % 3;
    m.p[r][c] = r < nt ? a.traj[11 * (long long)m.list[r] + c] : 0.0f;
  }
  __syncthreads();
  so3_encode(m.p, I, m.win, m.x, m.val, nullptr);
  __syncthreads();
  const Seg none = {nullptr, 0, 0};
  so3_layer(Seg{m.x, kLdX, I}, none, net.w0t, net.b0, m.h[0], m.ring);
  so3_layer(Seg{m.h[0], kLdH, kW}, none, net.w1t, net.b1, m.h[1], m.ring);
  so3_layer(Seg{m.h[1], kLdH, kW}, none, net.w2t, net.b2, m.h[2], m.ring);
  so3_layer(Seg{m.h[2], kLdH, kW}, Seg{m.x, kLdX, I}, net.w3t, net.b3,
            m.h[3], m.ring);
  so3_out(m.h[3], net, true, m.raw);
  __syncthreads();
  if (tid < kTile) {
    float3 rb = make_float3(0.f, 0.f, 0.f), gb;
    if (tid < nt) {
      const long long idx = m.list[tid];
      const float* tr = a.traj + 11 * idx;
      const float* db = a.dbar + 3 * idx;
      rodrigues_bwd(make_float3(m.raw[tid][0], m.raw[tid][1], m.raw[tid][2]),
                    make_float3(tr[8], tr[9], tr[10]),
                    make_float3(h * db[0], h * db[1], h * db[2]), &rb, &gb);
    }
    m.rb[tid][0] = rb.x;
    m.rb[tid][1] = rb.y;
    m.rb[tid][2] = rb.z;
  }
  __syncthreads();
  // Offsets of the forward pack in the partial.
  float* pw0 = part;
  float* pb0 = pw0 + I * kW;
  float* pw1 = pb0 + kW;
  float* pb1 = pw1 + kW * kW;
  float* pw2 = pb1 + kW;
  float* pb2 = pw2 + kW * kW;
  float* pw3 = pb2 + kW;
  float* pb3 = pw3 + (kW + I) * kW;
  float* pwo = pb3 + kW;
  float* pbo = pwo + kW * 3;
  // Output layer: dWout = h3^T rawbar, dbout; then dh3 over h3's buffer.
  for (int e = tid; e < kW * 3; e += kThreads) {
    const int k = e / 3, o = e % 3;
    float acc = 0.0f;
    for (int r = 0; r < kTile; ++r)
      acc = __fmaf_rn(m.h[3][r * kLdH + k], m.rb[r][o], acc);
    pwo[e] += acc;
  }
  if (tid < 3) {
    float acc = 0.0f;
    for (int r = 0; r < kTile; ++r) acc += m.rb[r][tid];
    pbo[tid] += acc;
  }
  __syncthreads();
  float* dz = m.h[3];
  for (int i = tid; i < kTile * kW; i += kThreads) {
    const int r = i / kW, c = i % kW;
    float v = 0.0f;
    for (int o = 0; o < 3; ++o)
      v = __fmaf_rn(m.rb[r][o], __ldg(net.wot + 3 * c + o), v);
    dz[r * kLdH + c] = dz[r * kLdH + c] > 0.0f ? v : 0.0f;
  }
  __syncthreads();
  // Layer 3: dW over [h2 | sines], its cotangent to h2.
  bias_sum(dz, pb3);
  grad_product(m.h[2], kLdH, 0, kW, dz, pw3, 0);
  grad_product(m.h[2], kLdH, 64, kW, dz, pw3, 0);
  grad_product(m.val, kLdX, 0, I, dz, pw3, kW);
  __syncthreads();
  masked_product(Seg{dz, kLdH, kW}, none, net.w3, kW, m.h[2], dz, m.ring);
  // Layers 2, 1, 0.
  float* const pws[3] = {pw2, pw1, pw0};
  float* const pbs[3] = {pb2, pb1, pb0};
  const float* const wb[2] = {net.w2, net.w1};
  for (int l = 2; l >= 0; --l) {
    bias_sum(dz, pbs[2 - l]);
    if (l > 0) {
      grad_product(m.h[l - 1], kLdH, 0, kW, dz, pws[2 - l], 0);
      grad_product(m.h[l - 1], kLdH, 64, kW, dz, pws[2 - l], 0);
    } else {
      grad_product(m.val, kLdX, 0, I, dz, pws[2], 0);
    }
    __syncthreads();
    if (l > 0) {
      masked_product(Seg{dz, kLdH, kW}, none, wb[2 - l], kW, m.h[l - 1], dz,
                     m.ring);
    }
  }
}

__global__ void __launch_bounds__(kThreads) k3_params(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ParamSmem& m = *reinterpret_cast<ParamSmem*>(smem_raw);
  const int I = 6 * a.max_deg, P = num_params(I);
  const Net net = make_net(a.wfwd, a.wbwd, I);
  float* part = a.partial + (long long)blockIdx.x * P;
  for (int e = threadIdx.x; e < P; e += kThreads) part[e] = 0.0f;
  if (threadIdx.x < a.max_deg) m.win[threadIdx.x] = a.window[threadIdx.x];
  __syncthreads();
  const long long total = (long long)a.batch * a.num_samples;
  const long long begin = blockIdx.x * a.chunk;
  const long long end = begin + a.chunk < total ? begin + a.chunk : total;
  active_tiles(a.traj, begin, end, m.list, m.warp_count,
               [&](int nt) { param_tile(a, net, m, part, nt); });
}

__global__ void k3_reduce(const float* partial, int num_blocks,
                          int num_params, float* out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= num_params) return;
  float s = 0.0f;
  for (int b = 0; b < num_blocks; ++b)
    s += partial[(long long)b * num_params + e];
  out[e] = s;
}

// P3, the ReLU-flip probe: the so3 head's pre-activations of hidden layers
// 1-3 at n points, with K3's own forward (so3_encode, so3_layer): each
// value is bitwise what passes 1b and 3 compute at that point. Replaces
// the Pallas kernel of samplenerfro_tpu's scripts/debug/probe_so3_relu.py.
// A block takes 64 points. Bound by its multiply-adds (60 W + 2 W^2 a
// point), fp32 on CUDA cores.
struct PreactSmem {
  float x[kTile * kLdX];
  float h[kTile * kLdH];
  float ring[kRing];
  float p[kTile][3];
  float win[kMaxDeg];
};

__global__ void __launch_bounds__(kThreads)
    so3_preacts_kernel(const float* pts, const float* wfwd,
                       const float* window, float* pre, int n, int max_deg,
                       int width) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PreactSmem& m = *reinterpret_cast<PreactSmem*>(smem_raw);
  const int I = 6 * max_deg;
  // Only the forward pack is read.
  const Net net = make_net(wfwd, wfwd, I);
  if (threadIdx.x < max_deg) m.win[threadIdx.x] = window[threadIdx.x];
  const long long row0 = (long long)blockIdx.x * kTile;
  const int rows = n - row0 < kTile ? (int)(n - row0) : kTile;
  for (int i = threadIdx.x; i < kTile * 3; i += kThreads) {
    const int r = i / 3, c = i % 3;
    m.p[r][c] = r < rows ? pts[3 * (row0 + r) + c] : 0.0f;
  }
  __syncthreads();
  so3_encode(m.p, I, m.win, m.x, nullptr, nullptr);
  __syncthreads();
  const Seg none = {nullptr, 0, 0};
  const float* const w[3] = {net.w0t, net.w1t, net.w2t};
  const float* const b[3] = {net.b0, net.b1, net.b2};
  for (int l = 0; l < 3; ++l) {
    const Seg in = l == 0 ? Seg{m.x, kLdX, I} : Seg{m.h, kLdH, kW};
    so3_layer(in, none, w[l], b[l], m.h, m.ring,
              pre + (long long)l * n * width + row0 * width, rows, width);
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// traj, cts: [B, S, 11] (cts with segbar in channel 6); wfwd, wbwd: the
// padded packs (see Net); window: [max_deg]; pieces: [S, 22, bp] scratch
// (bp = B rounded up to 32); dbar: [B, S, 3] scratch; raybar: [B, 6];
// partial: [num_blocks, P]; grads: [P], P the padded forward pack's size.
// Returns a cudaError_t.
extern "C" int march_bwd_launch(
    const float* traj, const float* cts, const float* grid,
    const float* wfwd, const float* wbwd, const float* window, float* pieces,
    float* dbar, float* raybar, float* partial, float* grads, int batch,
    int num_samples, int max_deg, int num_blocks, int nx, int ny, int nz,
    float step, float nmin_x, float nmin_y, float nmin_z, float nd_x,
    float nd_y, float nd_z, void* stream_ptr) {
  if (6 * max_deg > kIn - 4 || max_deg < 1 || max_deg > kMaxDeg ||
      batch < 1 || num_samples < 1 || num_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Args a;
  a.traj = traj;
  a.cts = cts;
  a.wfwd = wfwd;
  a.wbwd = wbwd;
  a.window = window;
  a.grid.grid = reinterpret_cast<const float4*>(grid);
  a.grid.nx = nx; a.grid.ny = ny; a.grid.nz = nz;
  a.grid.nmin_x = nmin_x; a.grid.nmin_y = nmin_y; a.grid.nmin_z = nmin_z;
  a.grid.nd_x = nd_x; a.grid.nd_y = nd_y; a.grid.nd_z = nd_z;
  a.pieces = pieces;
  a.dbar = dbar;
  a.raybar = raybar;
  a.partial = partial;
  a.batch = batch;
  a.bp = (batch + 31) / 32 * 32;
  a.num_samples = num_samples;
  a.max_deg = max_deg;
  a.step = step;
  const long long total = (long long)batch * num_samples;
  a.chunk = (total + num_blocks - 1) / num_blocks;

  k3_pieces<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = set_smem(k3_jacobians, sizeof(JacSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  k3_jacobians<<<num_blocks, kThreads, sizeof(JacSmem), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  k3_sweep<<<a.bp / 32, 32, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = set_smem(k3_params, sizeof(ParamSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  k3_params<<<num_blocks, kThreads, sizeof(ParamSmem), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int P = num_params(6 * max_deg);
  k3_reduce<<<(P + 255) / 256, 256, 0, stream>>>(partial, num_blocks, P,
                                                  grads);
  return static_cast<int>(cudaGetLastError());
}

// Parameters of the padded forward pack for 6 * max_deg inputs.
extern "C" int march_bwd_num_params(int max_deg) {
  return num_params(6 * max_deg);
}

extern "C" int so3_preacts_launch(const float* pts, const float* wfwd,
                                  const float* window, float* pre, int n,
                                  int max_deg, int width, void* stream_ptr) {
  if (n < 0 || width < 1 || width > kW || max_deg < 1 ||
      max_deg > kMaxDeg)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaError_t err = set_smem(so3_preacts_kernel, sizeof(PreactSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  so3_preacts_kernel<<<(n + kTile - 1) / kTile, kThreads, sizeof(PreactSmem),
                       static_cast<cudaStream_t>(stream_ptr)>>>(
      pts, wfwd, window, pre, n, max_deg, width);
  return static_cast<int>(cudaGetLastError());
}
