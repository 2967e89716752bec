// K3: the reverse sweep of the 'all'-stage march (K2), hand-written for
// Hopper (sm_90a).
//
// Replaces samplenerfro_tpu/ops/pallas/march_bwd_kernel.py:_bwd_kernel,
// reached there through march_bwd_pallas as the backward of
// ops/eikonal_vjp.make_march_allstage.
//
// What it computes: the cotangents of K2's inputs (origins, directions,
// the annealing alpha and every so3 weight and bias) from the cotangents
// of its trajectory, by the step adjoints of
// samplenerfro_tpu/ops/eikonal_vjp.py:11-25. Walking s = S-1 .. 0 with
// (pbar, dbar) the cotangents of (p_{s+1}, d_{s+1}):
//   ubar = h dbar;  m = |g_s| > 1e-3
//   if m: recompute the so3 head at p_s, then back through Rodrigues
//         (rawbar, g_so3), the MLP and the annealed PE (p_so3, wbar_k)
//   gbar  = (1-m) ubar + g_so3 + dg_s
//   nbar  = -(h/n^2)(pbar.d) + dn_s - segbar_s (h/n^2)|d|
//   dbar' = dbar + (h/n) pbar + dd_s + segbar_s (h/n) d/|d|
//   pbar' = pbar + p_so3 + [nbar, gbar] . d(trilinear)/dp + dp_s
// The trilinear adjoint re-gathers the 8 corners of p_s and takes the
// derivative of the x-then-y-then-z lerps along each axis, divided by the
// voxel size (ops/grid.trilinear's fraction has slope 1/ndelta). The
// wrapper has already turned the direction cotangent into the raw
// direction's and the arclength cotangent into segbar_s = sum_{k>s} ddist_k
// (eikonal_vjp.py:590-594).
//
// Three launches, one wrapper call:
//  1. march_bwd_sweep: sequential in s, parallel over rays. As K2, a block
//     of 128 threads takes a tile of R = 8 rays; threads 0..R-1 own the
//     rays' (pbar, dbar) and do the Euler and trilinear adjoints, and all
//     threads recompute the MLP for the tile and run it backward to its
//     input (thread j owns hidden unit j). It writes the origin/direction
//     cotangents, each ray's per-degree window cotangent (the wrapper turns
//     those into alpha's by autograd of the window function) and, for
//     every ray-step, the MLP output cotangent rawbar.
//  2. march_bwd_params: the parameter gradients, a sum over the ~786k
//     ray-steps of a training batch (pass 3 of eikonal_vjp.py:226-227). A
//     fixed grid of G blocks each owns a contiguous range of ray-steps,
//     compacts the active ones in order into tiles of T = 32, recomputes
//     the MLP forward and backward for the tile in shared memory, and adds
//     the tile's outer products into its own slice of a [G, P] partial
//     buffer. No atomics: each block adds in a fixed order.
//  3. march_bwd_reduce: sums the G partials of each parameter in block
//     order. Repeated runs therefore match bit for bit.
//
// What bounds it: about three times K2's MLP arithmetic on the active
// ray-steps (forward recompute, backward to the input, and the weight
// outer products), fp32 on CUDA cores, against reading the trajectory and
// its cotangents once. Known weaknesses of this first version: the sweep
// streams the 260 KB of weights through L1 twice a step (forward and
// backward layouts), the parameter pass reads and writes its 260 KB
// partial once per tile, and the outer products read shared memory for
// every multiply-add.
//
// The file also holds P3 (so3_preacts_launch), which recomputes the head's
// pre-activations with the sweep's own code so that ReLU masks can be held
// against another summation order's; see so3_preacts_kernel.

#include <cuda_runtime.h>

namespace {

constexpr int kRays = 8;        // rays per sweep block
constexpr int kThreads = 128;   // sweep threads = max hidden width
constexpr int kMaxIn = 64;      // max PE features
constexpr int kMaxCat = 192;    // max width + PE features
constexpr int kMaxDeg = 10;
constexpr int kTile = 32;       // ray-steps per parameter-pass tile
constexpr int kPThreads = 256;  // parameter-pass threads
constexpr float kHalfPi = 1.5707963267948966f;

struct Net {
  // Forward pack, input-major: W0t b0 W1t b1 W2t b2 W3t b3 Woutt bout.
  const float *w0t, *b0, *w1t, *b1, *w2t, *b2, *w3t, *b3, *wot, *bo;
  // Backward pack, nn.Linear layout [out][in]: W0 W1 W2 W3 Wout.
  const float *w0, *w1, *w2, *w3, *wo;
  int in_dim, width;
};

__device__ __forceinline__ Net make_net(const float* fwd, const float* bwd,
                                        int in_dim, int width) {
  Net n;
  const int I = in_dim, W = width;
  n.in_dim = I;
  n.width = W;
  n.w0t = fwd;          n.b0 = n.w0t + I * W;
  n.w1t = n.b0 + W;     n.b1 = n.w1t + W * W;
  n.w2t = n.b1 + W;     n.b2 = n.w2t + W * W;
  n.w3t = n.b2 + W;     n.b3 = n.w3t + (W + I) * W;
  n.wot = n.b3 + W;     n.bo = n.wot + W * 3;
  n.w0 = bwd;           n.w1 = n.w0 + W * I;
  n.w2 = n.w1 + W * W;  n.w3 = n.w2 + W * W;
  n.wo = n.w3 + W * (W + I);
  return n;
}

__device__ __forceinline__ float4 lerp4(float4 a, float4 b, float t) {
  const float u = 1.0f - t;
  return make_float4(a.x * u + b.x * t, a.y * u + b.y * t,
                     a.z * u + b.z * t, a.w * u + b.w * t);
}

__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return ((a.x * b.x + a.y * b.y) + a.z * b.z) + a.w * b.w;
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

// d(trilinear)/dp . vbar for ops/grid.trilinear at p: the three fraction
// derivatives of the x-then-y-then-z lerps, over the voxel size.
__device__ void trilinear_adjoint(const GridArgs& a, float px, float py,
                                  float pz, float4 vbar, float* out) {
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
  out[0] = dot4(vbar, dvx) / a.nd_x;
  out[1] = dot4(vbar, dvy) / a.nd_y;
  out[2] = dot4(vbar, dvz) / a.nd_z;
}

// out[r][i] = f(sum_k in[r][k] M[k*ncols + i] (+ sum_k in2[r][k]
// M[(K+k)*ncols + i]) + bias[i]) for the sweep tile's R rows, thread i
// owning columns i, i+128, ...; f applies ReLU, a mask (row r, column i of
// `mask` > 0) and an addend, each when given.
__device__ void gemv_tile(const float* in, int ld_in, int K,
                          const float* in2, int ld_in2, int K2,
                          const float* __restrict__ M, int ncols,
                          const float* __restrict__ bias, bool relu,
                          const float* mask, int ld_mask, const float* add,
                          int ld_add, float* out, int ld_out) {
  for (int i = threadIdx.x; i < ncols; i += kThreads) {
    float acc[kRays];
#pragma unroll
    for (int r = 0; r < kRays; ++r) acc[r] = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float m = __ldg(M + k * ncols + i);
#pragma unroll
      for (int r = 0; r < kRays; ++r)
        acc[r] = __fmaf_rn(in[r * ld_in + k], m, acc[r]);
    }
    for (int k = 0; k < K2; ++k) {
      const float m = __ldg(M + (K + k) * ncols + i);
#pragma unroll
      for (int r = 0; r < kRays; ++r)
        acc[r] = __fmaf_rn(in2[r * ld_in2 + k], m, acc[r]);
    }
    const float b = bias ? __ldg(bias + i) : 0.0f;
#pragma unroll
    for (int r = 0; r < kRays; ++r) {
      float v = acc[r] + b;
      if (relu) v = fmaxf(v, 0.0f);
      if (mask && !(mask[r * ld_mask + i] > 0.0f)) v = 0.0f;
      if (add) v = v + add[r * ld_add + i];
      out[r * ld_out + i] = v;
    }
  }
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

struct SweepArgs {
  const float* traj;     // [B, S, 11]: p, raw d, t, n, g
  const float* cts;      // [B, S, 11]: dp, dd(raw), segbar, dn, dg
  const float* wfwd;
  const float* wbwd;
  const float* window;   // [max_deg]
  GridArgs grid;
  float* raybar;         // [B, 6]: pbar_0, dbar_0
  float* rawbar;         // [B, S, 3]
  float* wbar;           // [B, max_deg]
  int batch, num_samples, max_deg, width;
  float step;
};

__global__ void __launch_bounds__(kThreads)
march_bwd_sweep(const SweepArgs a) {
  __shared__ float x_s[kRays][kMaxIn];    // PE features; then p terms
  __shared__ float val_s[kRays][kMaxIn];  // sin(arg); then window terms
  __shared__ float dco_s[kRays][kMaxIn];  // cos(arg) * 2^k
  __shared__ float h_s[4][kRays][kThreads];
  __shared__ float ba_s[kRays][kThreads];
  __shared__ float bb_s[kRays][kThreads];
  __shared__ float bc_s[kRays][kMaxCat];
  __shared__ float p_s[kRays][3];
  __shared__ float raw_s[kRays][3];
  __shared__ float rb_s[kRays][3];
  __shared__ int act_s[kRays];
  __shared__ float win_s[kMaxDeg];

  const int tid = threadIdx.x;
  const int IN = 6 * a.max_deg, W = a.width;
  const Net net = make_net(a.wfwd, a.wbwd, IN, W);
  if (tid < a.max_deg) win_s[tid] = a.window[tid];

  const int ray = blockIdx.x * kRays + tid;
  const bool owner = tid < kRays && ray < a.batch;
  const int S = a.num_samples;
  const float h = a.step;
  float pbx = 0.f, pby = 0.f, pbz = 0.f, dbx = 0.f, dby = 0.f, dbz = 0.f;
  float wacc[kMaxDeg];
#pragma unroll
  for (int k = 0; k < kMaxDeg; ++k) wacc[k] = 0.0f;

  for (int s = S - 1; s >= 0; --s) {
    const long long row = (long long)ray * S + s;
    float px = 0.f, py = 0.f, pz = 0.f, n = 1.f, gx = 0.f, gy = 0.f,
          gz = 0.f;
    bool act = false;
    if (owner) {
      const float* tr = a.traj + 11 * row;
      px = tr[0]; py = tr[1]; pz = tr[2];
      n = tr[7]; gx = tr[8]; gy = tr[9]; gz = tr[10];
      act = active_g(tr);
      p_s[tid][0] = px; p_s[tid][1] = py; p_s[tid][2] = pz;
      act_s[tid] = act;
    } else if (tid < kRays) {
      p_s[tid][0] = p_s[tid][1] = p_s[tid][2] = 0.0f;
      act_s[tid] = 0;
    }
    __syncthreads();
    int any = 0;
#pragma unroll
    for (int r = 0; r < kRays; ++r) any |= act_s[r];
    const float ubx = h * dbx, uby = h * dby, ubz = h * dbz;
    float3 g_so3 = make_float3(0.f, 0.f, 0.f);
    float3 p_so3 = make_float3(0.f, 0.f, 0.f);
    if (any) {
      // Forward recompute: annealed PE, four hidden layers, output.
      for (int i = tid; i < kRays * IN; i += kThreads) {
        const int r = i / IN, f = i % IN;
        const int deg = f / 6, c = f % 3;
        const float scale = (float)(1 << deg);
        const float xb = p_s[r][c] * scale;
        const float arg = (f % 6) < 3 ? xb : xb + kHalfPi;
        const float sv = sinf(arg);
        val_s[r][f] = sv;
        dco_s[r][f] = cosf(arg) * scale;
        x_s[r][f] = sv * win_s[deg];
      }
      __syncthreads();
      gemv_tile(&x_s[0][0], kMaxIn, IN, nullptr, 0, 0, net.w0t, W, net.b0,
                true, nullptr, 0, nullptr, 0, &h_s[0][0][0], kThreads);
      __syncthreads();
      gemv_tile(&h_s[0][0][0], kThreads, W, nullptr, 0, 0, net.w1t, W,
                net.b1, true, nullptr, 0, nullptr, 0, &h_s[1][0][0],
                kThreads);
      __syncthreads();
      gemv_tile(&h_s[1][0][0], kThreads, W, nullptr, 0, 0, net.w2t, W,
                net.b2, true, nullptr, 0, nullptr, 0, &h_s[2][0][0],
                kThreads);
      __syncthreads();
      gemv_tile(&h_s[2][0][0], kThreads, W, &x_s[0][0], kMaxIn, IN, net.w3t,
                W, net.b3, true, nullptr, 0, nullptr, 0, &h_s[3][0][0],
                kThreads);
      __syncthreads();
      if (tid < 3 * kRays) {
        const int r = tid / 3, o = tid % 3;
        float acc = 0.0f;
        for (int k = 0; k < W; ++k)
          acc = __fmaf_rn(h_s[3][r][k], __ldg(net.wot + 3 * k + o), acc);
        raw_s[r][o] = acc + __ldg(net.bo + o);
      }
      __syncthreads();
      // Rodrigues adjoint of the owner's ray; rawbar is 0 where m = 0.
      if (tid < kRays) {
        float3 rb = make_float3(0.f, 0.f, 0.f);
        if (act) {
          rodrigues_bwd(make_float3(raw_s[tid][0], raw_s[tid][1],
                                    raw_s[tid][2]),
                        make_float3(gx, gy, gz), make_float3(ubx, uby, ubz),
                        &rb, &g_so3);
        }
        rb_s[tid][0] = rb.x; rb_s[tid][1] = rb.y; rb_s[tid][2] = rb.z;
      }
      __syncthreads();
      // MLP backward to its input: dh4, [dh3 | dx_skip], dh2, dh1, dx.
      gemv_tile(&rb_s[0][0], 3, 3, nullptr, 0, 0, net.wo, W, nullptr, false,
                &h_s[3][0][0], kThreads, nullptr, 0, &ba_s[0][0], kThreads);
      __syncthreads();
      gemv_tile(&ba_s[0][0], kThreads, W, nullptr, 0, 0, net.w3, W + IN,
                nullptr, false, nullptr, 0, nullptr, 0, &bc_s[0][0],
                kMaxCat);
      __syncthreads();
      for (int i = tid; i < kRays * W; i += kThreads) {
        const int r = i / W, j = i % W;
        if (!(h_s[2][r][j] > 0.0f)) bc_s[r][j] = 0.0f;
      }
      __syncthreads();
      gemv_tile(&bc_s[0][0], kMaxCat, W, nullptr, 0, 0, net.w2, W, nullptr,
                false, &h_s[1][0][0], kThreads, nullptr, 0, &ba_s[0][0],
                kThreads);
      __syncthreads();
      gemv_tile(&ba_s[0][0], kThreads, W, nullptr, 0, 0, net.w1, W, nullptr,
                false, &h_s[0][0][0], kThreads, nullptr, 0, &bb_s[0][0],
                kThreads);
      __syncthreads();
      // dx = dh1 . W0 + the skip part; then the PE adjoint terms.
      gemv_tile(&bb_s[0][0], kThreads, W, nullptr, 0, 0, net.w0, IN, nullptr,
                false, nullptr, 0, &bc_s[0][W], kMaxCat, &ba_s[0][0],
                kThreads);
      __syncthreads();
      for (int i = tid; i < kRays * IN; i += kThreads) {
        const int r = i / IN, f = i % IN;
        const float dxf = ba_s[r][f];
        x_s[r][f] = dxf * win_s[f / 6] * dco_s[r][f];
        val_s[r][f] = dxf * val_s[r][f];
      }
      __syncthreads();
      if (owner && act) {
        float pc[3] = {0.f, 0.f, 0.f};
        for (int f = 0; f < IN; ++f) pc[f % 3] += x_s[tid][f];
        p_so3 = make_float3(pc[0], pc[1], pc[2]);
        for (int k = 0; k < a.max_deg; ++k) {
          float wk = 0.0f;
          for (int f = 6 * k; f < 6 * k + 6; ++f) wk += val_s[tid][f];
          wacc[k] += wk;
        }
      }
    }
    if (owner) {
      float* rbo = a.rawbar + 3 * row;
      if (any) {
        rbo[0] = rb_s[tid][0]; rbo[1] = rb_s[tid][1]; rbo[2] = rb_s[tid][2];
      } else {
        rbo[0] = rbo[1] = rbo[2] = 0.0f;
      }
      const float* tr = a.traj + 11 * row;
      const float* ct = a.cts + 11 * row;
      const float dx = tr[3], dy = tr[4], dz = tr[5];
      const float sb = ct[6];
      const float mk = act ? 0.0f : 1.0f;
      const float gbx = (mk * ubx + g_so3.x) + ct[8];
      const float gby = (mk * uby + g_so3.y) + ct[9];
      const float gbz = (mk * ubz + g_so3.z) + ct[10];
      const float dlen = sqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-6f));
      const float inv_n = 1.0f / n;
      const float hn = h * inv_n, hn2 = h * inv_n * inv_n;
      const float pdotd = (pbx * dx + pby * dy) + pbz * dz;
      const float nbar = (-hn2 * pdotd + ct[7]) - sb * hn2 * dlen;
      const float ndx = ((dbx + hn * pbx) + ct[3]) + sb * hn * dx / dlen;
      const float ndy = ((dby + hn * pby) + ct[4]) + sb * hn * dy / dlen;
      const float ndz = ((dbz + hn * pbz) + ct[5]) + sb * hn * dz / dlen;
      float pin[3];
      trilinear_adjoint(a.grid, px, py, pz,
                        make_float4(nbar, gbx, gby, gbz), pin);
      pbx = ((pbx + p_so3.x) + pin[0]) + ct[0];
      pby = ((pby + p_so3.y) + pin[1]) + ct[1];
      pbz = ((pbz + p_so3.z) + pin[2]) + ct[2];
      dbx = ndx; dby = ndy; dbz = ndz;
    }
    __syncthreads();
  }
  if (owner) {
    float* rb = a.raybar + 6 * (long long)ray;
    rb[0] = pbx; rb[1] = pby; rb[2] = pbz;
    rb[3] = dbx; rb[4] = dby; rb[5] = dbz;
    for (int k = 0; k < a.max_deg; ++k)
      a.wbar[(long long)ray * a.max_deg + k] = wacc[k];
  }
}

struct ParamArgs {
  const float* traj;     // [M, 11]
  const float* rawbar;   // [M, 3]
  const float* wfwd;
  const float* wbwd;
  const float* window;
  float* partial;        // [G, P]
  long long total, chunk;
  int max_deg, width, num_params;
};

// Shared memory of the parameter pass, carved from one dynamic buffer.
struct ParamSmem {
  float p[kTile][3];
  float rb[kTile][3];
  float x[kTile][kMaxIn];
  float h[4][kTile][kThreads];
  float ba[kTile][kThreads];
  float bb[kTile][kThreads];
  float bc[kTile][kMaxCat];
  float win[kMaxDeg];
  int list[kPThreads + kTile];
  int warp_count[kPThreads / 32];
};

// out[t][i] = f(sum_k in[t][k] M[k*ncols + i] (+ in2 part) + bias[i]) for
// the tile's kTile rows; thread (i, half) owns rows half, half+2, ...
__device__ void gemm_tile(const float* in, int ld_in, int K, const float* in2,
                          int ld_in2, int K2, const float* __restrict__ M,
                          int ncols, const float* __restrict__ bias,
                          bool relu, const float* mask, int ld_mask,
                          float* out, int ld_out) {
  constexpr int kRows = kTile / 2;
  const int half = threadIdx.x / kThreads;
  for (int i = threadIdx.x % kThreads; i < ncols; i += kThreads) {
    float acc[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) acc[q] = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float m = __ldg(M + k * ncols + i);
#pragma unroll
      for (int q = 0; q < kRows; ++q)
        acc[q] = __fmaf_rn(in[(half + 2 * q) * ld_in + k], m, acc[q]);
    }
    for (int k = 0; k < K2; ++k) {
      const float m = __ldg(M + (K + k) * ncols + i);
#pragma unroll
      for (int q = 0; q < kRows; ++q)
        acc[q] = __fmaf_rn(in2[(half + 2 * q) * ld_in2 + k], m, acc[q]);
    }
    const float b = bias ? __ldg(bias + i) : 0.0f;
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int t = half + 2 * q;
      float v = acc[q] + b;
      if (relu) v = fmaxf(v, 0.0f);
      if (mask && !(mask[t * ld_mask + i] > 0.0f)) v = 0.0f;
      out[t * ld_out + i] = v;
    }
  }
}

// partial[row*ncols + col] += sum_{t < nt} act(t, row) * dh[t][col], where
// act(t, row) is a[t][row] for row < ka, else a2[t][row - ka].
__device__ void accumulate_outer(float* partial, int nrows, int ncols,
                                 const float* act, int ld_a, int ka,
                                 const float* act2, int ld_a2,
                                 const float* dh, int ld_dh, int nt) {
  const int n = nrows * ncols;
  for (int e = threadIdx.x; e < n; e += kPThreads) {
    const int row = e / ncols, col = e % ncols;
    const float* ap = row < ka ? act + row : act2 + (row - ka);
    const int lda = row < ka ? ld_a : ld_a2;
    float s = 0.0f;
    for (int t = 0; t < nt; ++t)
      s = __fmaf_rn(ap[t * lda], dh[t * ld_dh + col], s);
    partial[e] += s;
  }
}

__device__ void accumulate_bias(float* partial, int ncols, const float* dh,
                                int ld_dh, int nt) {
  for (int c = threadIdx.x; c < ncols; c += kPThreads) {
    float s = 0.0f;
    for (int t = 0; t < nt; ++t) s += dh[t * ld_dh + c];
    partial[c] += s;
  }
}

__device__ void param_tile(const ParamArgs& a, const Net& net, ParamSmem& m,
                           float* part, int nt) {
  const int tid = threadIdx.x;
  const int IN = net.in_dim, W = net.width;
  for (int t = tid; t < kTile; t += kPThreads) {
    const long long idx = t < nt ? m.list[t] : -1;
    for (int c = 0; c < 3; ++c) {
      m.p[t][c] = idx >= 0 ? a.traj[11 * idx + c] : 0.0f;
      m.rb[t][c] = idx >= 0 ? a.rawbar[3 * idx + c] : 0.0f;
    }
  }
  __syncthreads();
  for (int i = tid; i < kTile * IN; i += kPThreads) {
    const int t = i / IN, f = i % IN;
    const int deg = f / 6, c = f % 3;
    const float xb = m.p[t][c] * (float)(1 << deg);
    const float arg = (f % 6) < 3 ? xb : xb + kHalfPi;
    m.x[t][f] = sinf(arg) * m.win[deg];
  }
  __syncthreads();
  gemm_tile(&m.x[0][0], kMaxIn, IN, nullptr, 0, 0, net.w0t, W, net.b0, true,
            nullptr, 0, &m.h[0][0][0], kThreads);
  __syncthreads();
  gemm_tile(&m.h[0][0][0], kThreads, W, nullptr, 0, 0, net.w1t, W, net.b1,
            true, nullptr, 0, &m.h[1][0][0], kThreads);
  __syncthreads();
  gemm_tile(&m.h[1][0][0], kThreads, W, nullptr, 0, 0, net.w2t, W, net.b2,
            true, nullptr, 0, &m.h[2][0][0], kThreads);
  __syncthreads();
  gemm_tile(&m.h[2][0][0], kThreads, W, &m.x[0][0], kMaxIn, IN, net.w3t, W,
            net.b3, true, nullptr, 0, &m.h[3][0][0], kThreads);
  __syncthreads();
  // dh4 = (rawbar . Wout) * relu'(h4); then dhc = dh4 . W3.
  gemm_tile(&m.rb[0][0], 3, 3, nullptr, 0, 0, net.wo, W, nullptr, false,
            &m.h[3][0][0], kThreads, &m.ba[0][0], kThreads);
  __syncthreads();
  gemm_tile(&m.ba[0][0], kThreads, W, nullptr, 0, 0, net.w3, W + IN, nullptr,
            false, nullptr, 0, &m.bc[0][0], kMaxCat);
  // Offsets of the forward pack, which the partial mirrors.
  float* pw0 = part;
  float* pb0 = pw0 + IN * W;
  float* pw1 = pb0 + W;
  float* pb1 = pw1 + W * W;
  float* pw2 = pb1 + W;
  float* pb2 = pw2 + W * W;
  float* pw3 = pb2 + W;
  float* pb3 = pw3 + (W + IN) * W;
  float* pwo = pb3 + W;
  float* pbo = pwo + W * 3;
  accumulate_outer(pwo, W, 3, &m.h[3][0][0], kThreads, W, nullptr, 0,
                   &m.rb[0][0], 3, nt);
  accumulate_bias(pbo, 3, &m.rb[0][0], 3, nt);
  accumulate_outer(pw3, W + IN, W, &m.h[2][0][0], kThreads, W, &m.x[0][0],
                   kMaxIn, &m.ba[0][0], kThreads, nt);
  accumulate_bias(pb3, W, &m.ba[0][0], kThreads, nt);
  __syncthreads();
  for (int i = tid; i < kTile * W; i += kPThreads) {
    const int t = i / W, j = i % W;
    if (!(m.h[2][t][j] > 0.0f)) m.bc[t][j] = 0.0f;
  }
  __syncthreads();
  accumulate_outer(pw2, W, W, &m.h[1][0][0], kThreads, W, nullptr, 0,
                   &m.bc[0][0], kMaxCat, nt);
  accumulate_bias(pb2, W, &m.bc[0][0], kMaxCat, nt);
  gemm_tile(&m.bc[0][0], kMaxCat, W, nullptr, 0, 0, net.w2, W, nullptr,
            false, &m.h[1][0][0], kThreads, &m.ba[0][0], kThreads);
  __syncthreads();
  accumulate_outer(pw1, W, W, &m.h[0][0][0], kThreads, W, nullptr, 0,
                   &m.ba[0][0], kThreads, nt);
  accumulate_bias(pb1, W, &m.ba[0][0], kThreads, nt);
  gemm_tile(&m.ba[0][0], kThreads, W, nullptr, 0, 0, net.w1, W, nullptr,
            false, &m.h[0][0][0], kThreads, &m.bb[0][0], kThreads);
  __syncthreads();
  accumulate_outer(pw0, IN, W, &m.x[0][0], kMaxIn, IN, nullptr, 0,
                   &m.bb[0][0], kThreads, nt);
  accumulate_bias(pb0, W, &m.bb[0][0], kThreads, nt);
  __syncthreads();
}

__global__ void __launch_bounds__(kPThreads)
march_bwd_params(const ParamArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ParamSmem& m = *reinterpret_cast<ParamSmem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const Net net = make_net(a.wfwd, a.wbwd, 6 * a.max_deg, a.width);
  float* part = a.partial + (long long)blockIdx.x * a.num_params;
  for (int e = tid; e < a.num_params; e += kPThreads) part[e] = 0.0f;
  if (tid < a.max_deg) m.win[tid] = a.window[tid];
  const long long begin = (long long)blockIdx.x * a.chunk;
  const long long end = begin + a.chunk < a.total ? begin + a.chunk : a.total;
  int count = 0;
  __syncthreads();
  for (long long base = begin; base < end; base += kPThreads) {
    const long long idx = base + tid;
    const bool flag = idx < end && active_g(a.traj + 11 * idx);
    const unsigned ballot = __ballot_sync(0xffffffffu, flag);
    if (lane == 0) m.warp_count[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kPThreads / 32; ++w) {
      if (w < warp) before += m.warp_count[w];
      total += m.warp_count[w];
    }
    if (flag)
      m.list[count + before + __popc(ballot & ((1u << lane) - 1u))] =
          (int)idx;
    count += total;
    __syncthreads();
    while (count >= kTile) {
      param_tile(a, net, m, part, kTile);
      int keep[2];
      const int rest = count - kTile;
      for (int q = 0; q < 2; ++q) {
        const int i = tid + q * kPThreads;
        keep[q] = i < rest ? m.list[kTile + i] : 0;
      }
      __syncthreads();
      for (int q = 0; q < 2; ++q) {
        const int i = tid + q * kPThreads;
        if (i < rest) m.list[i] = keep[q];
      }
      count = rest;
      __syncthreads();
    }
  }
  if (count > 0) param_tile(a, net, m, part, count);
}

__global__ void march_bwd_reduce(const float* partial, int num_blocks,
                                 int num_params, float* out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= num_params) return;
  float s = 0.0f;
  for (int b = 0; b < num_blocks; ++b)
    s += partial[(long long)b * num_params + e];
  out[e] = s;
}

// P3, the ReLU-flip probe: the so3 head's pre-activations of hidden layers
// 1-3 at n points, in the sweep's own arithmetic. Replaces the Pallas
// kernel of samplenerfro_tpu's scripts/debug/probe_so3_relu.py. Each block
// takes 8 points on 128 threads, encodes them with the sweep's PE
// expression and runs the sweep's gemv_tile, so every value is bitwise
// what the sweep recomputes at that point (the parameter pass's gemm_tile
// sums in the same k order). The ReLU is applied after the pre-activation
// is written, as gemv_tile's own fmaxf would. Bound by its multiply-adds
// (60*W + 2*W*W a point), fp32 on CUDA cores.
struct PreactArgs {
  const float* pts;     // [n, 3]
  const float* wfwd;    // forward pack, as the sweep's
  const float* window;  // [max_deg]
  float* pre;           // [3, n, width]
  int n, max_deg, width;
};

__global__ void __launch_bounds__(kThreads)
so3_preacts_kernel(const PreactArgs a) {
  __shared__ float x_s[kRays][kMaxIn];
  __shared__ float h_s[2][kRays][kThreads];
  __shared__ float p_s[kRays][3];
  __shared__ float win_s[kMaxDeg];

  const int tid = threadIdx.x;
  const int IN = 6 * a.max_deg, W = a.width;
  // Only the forward pack is read; its offsets are the sweep's.
  const Net net = make_net(a.wfwd, a.wfwd, IN, W);
  if (tid < a.max_deg) win_s[tid] = a.window[tid];
  const long long row0 = (long long)blockIdx.x * kRays;
  if (tid < 3 * kRays) {
    const int r = tid / 3, c = tid % 3;
    p_s[r][c] = row0 + r < a.n ? a.pts[3 * (row0 + r) + c] : 0.0f;
  }
  __syncthreads();
  for (int i = tid; i < kRays * IN; i += kThreads) {
    const int r = i / IN, f = i % IN;
    const int deg = f / 6, c = f % 3;
    const float scale = (float)(1 << deg);
    const float xb = p_s[r][c] * scale;
    const float arg = (f % 6) < 3 ? xb : xb + kHalfPi;
    const float sv = sinf(arg);
    x_s[r][f] = sv * win_s[deg];
  }
  __syncthreads();
  const float* const w[3] = {net.w0t, net.w1t, net.w2t};
  const float* const b[3] = {net.b0, net.b1, net.b2};
  const float* in = &x_s[0][0];
  int ld_in = kMaxIn, k_in = IN;
  for (int layer = 0; layer < 3; ++layer) {
    float* h = &h_s[layer % 2][0][0];
    gemv_tile(in, ld_in, k_in, nullptr, 0, 0, w[layer], W, b[layer], false,
              nullptr, 0, nullptr, 0, h, kThreads);
    __syncthreads();
    float* out = a.pre + (long long)layer * a.n * W;
    for (int i = tid; i < kRays * W; i += kThreads) {
      const int r = i / W, j = i % W;
      const float v = h[r * kThreads + j];
      if (row0 + r < a.n) out[(row0 + r) * W + j] = v;
      h[r * kThreads + j] = fmaxf(v, 0.0f);
    }
    __syncthreads();
    in = h;
    ld_in = kThreads;
    k_in = W;
  }
}

}  // namespace

extern "C" int march_bwd_launch(
    const float* traj, const float* cts, const float* grid,
    const float* wfwd, const float* wbwd, const float* window, float* raybar,
    float* rawbar, float* wbar, float* partial, float* grads, int batch,
    int num_samples, int max_deg, int width, int num_blocks, int nx, int ny,
    int nz, float step, float nmin_x, float nmin_y, float nmin_z, float nd_x,
    float nd_y, float nd_z, void* stream_ptr) {
  if (width > kThreads || 6 * max_deg > kMaxIn || max_deg > kMaxDeg ||
      width + 6 * max_deg > kMaxCat)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int in_dim = 6 * max_deg;
  const int num_params = in_dim * width + width + 2 * (width * width + width)
                         + (width + in_dim) * width + width + width * 3 + 3;

  SweepArgs s;
  s.traj = traj;
  s.cts = cts;
  s.wfwd = wfwd;
  s.wbwd = wbwd;
  s.window = window;
  s.grid.grid = reinterpret_cast<const float4*>(grid);
  s.grid.nx = nx; s.grid.ny = ny; s.grid.nz = nz;
  s.grid.nmin_x = nmin_x; s.grid.nmin_y = nmin_y; s.grid.nmin_z = nmin_z;
  s.grid.nd_x = nd_x; s.grid.nd_y = nd_y; s.grid.nd_z = nd_z;
  s.raybar = raybar;
  s.rawbar = rawbar;
  s.wbar = wbar;
  s.batch = batch;
  s.num_samples = num_samples;
  s.max_deg = max_deg;
  s.width = width;
  s.step = step;
  march_bwd_sweep<<<(batch + kRays - 1) / kRays, kThreads, 0, stream>>>(s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  ParamArgs p;
  p.traj = traj;
  p.rawbar = rawbar;
  p.wfwd = wfwd;
  p.wbwd = wbwd;
  p.window = window;
  p.partial = partial;
  p.total = (long long)batch * num_samples;
  p.chunk = (p.total + num_blocks - 1) / num_blocks;
  p.max_deg = max_deg;
  p.width = width;
  p.num_params = num_params;
  const int smem = static_cast<int>(sizeof(ParamSmem));
  err = cudaFuncSetAttribute(march_bwd_params,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  march_bwd_params<<<num_blocks, kPThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  march_bwd_reduce<<<(num_params + 255) / 256, 256, 0, stream>>>(
      partial, num_blocks, num_params, grads);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int so3_preacts_launch(const float* pts, const float* wfwd,
                                  const float* window, float* pre, int n,
                                  int max_deg, int width, void* stream_ptr) {
  if (n < 0 || width < 1 || width > kThreads || max_deg < 1 ||
      max_deg > kMaxDeg)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  PreactArgs a;
  a.pts = pts;
  a.wfwd = wfwd;
  a.window = window;
  a.pre = pre;
  a.n = n;
  a.max_deg = max_deg;
  a.width = width;
  so3_preacts_kernel<<<(n + kRays - 1) / kRays, kThreads, 0,
                       static_cast<cudaStream_t>(stream_ptr)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
