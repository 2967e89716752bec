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
//      for the sweep ([S][22][Bp], Bp the rays rounded up to 32). In the
//      bf16 arm it also counts the active rows of traj in its block's 256.
//  1b. k3_jacobians: the active ray-steps, compacted in order into tiles.
//      Per tile: the annealed PE and its derivative, each hidden layer
//      forward and its three tangents (one per axis of p), each a product
//      of the tile's rows with the layer's weights, then the output layer,
//      Rodrigues' Jacobians (its adjoint at three unit cotangents) and K,
//      written over B^T.
//  2.  k3_sweep: the recurrence above, one thread a ray, 32 rays a block
//      (a block per 32 rays spreads 1,024 rays over 32 SMs), the pieces
//      of 8 steps staged by cp.async while the 8 before are swept. It
//      writes dbar_{s+1} at every ray-step and (pbar_0, dbar_0).
//  3.  k3_params: over the same tiles as 1b: the head's forward again,
//      rawbar by the Rodrigues adjoint at ubar, the cotangents of each
//      layer (dZ W^T, masked by the stored activations), and each layer's
//      dW = A^T dZ over the tile's rows, added into the block's own row of
//      a [G, stride] partial; the first layer's and the skip rows'
//      products are taken against the PE's sines before the window, so
//      that the wrapper gets the window's cotangent from them (W . G summed
//      per degree) and scales them by the window into dW.
//  4.  k3_reduce: sums the G partials of each parameter in block order.
// Every sum is owned by one thread (or one mma.sync fragment) and runs in
// a fixed order; no atomics, so two runs agree bit for bit.
//
// Two arms, chosen by march_bwd_dtype (1a takes the arm as a flag; the
// sweep and the reduction are shared):
//  - float32: 1b and 3 are the templates below (F32Arm): a fixed grid of
//    blocks over contiguous ranges of ray-steps, compacting the active
//    ones into tiles of 64; the head's products are fp32 sums on CUDA
//    cores (the Simt engine of mlp_common.cuh, weights streamed from L2 in
//    k-slabs through its cp.async ring) that start from zero and run in k
//    order over the layer's input, then the skip input, then + bias: the
//    rounding points of the first version's gemv_tile and of K2's fp32
//    head. Tensor cores would flip ReLU masks near 0 (PERF.md).
//  - bfloat16: the TPU kernel's so3_precision DEFAULT and the passes
//    form's bf16 casts (samplenerfro_tpu/ops/pallas/march_bwd_kernel.py:
//    270-300; eikonal_vjp.py:270-275, 300-321, 428-430). The head's
//    forward, tangent, cotangent and dW products take bf16 operands (the PE
//    features and sines, every stored activation, tangent and cotangent,
//    the weights rounded by the wrapper) on the tensor cores. The bias,
//    ReLU, PE, Rodrigues, the 3-wide output layer (fp32 sums of bf16
//    operands on CUDA cores) and the sweep stay fp32; the bias gradients
//    sum the bf16 cotangents in fp32. 1a forms the trilinear derivative
//    from the corner values and the axis weights rounded to bf16, summed
//    in fp32 (trilinear_jacobian_bf16). K2's bf16 head (march_so3.cu,
//    namespace bfh) runs the hidden layers with the same operands through
//    the same layer() (so3_bf16.cuh), so K3 differentiates the forward K2
//    ran, bit for bit in its pre-activations.
// The hidden layers are computed at width 128: a narrower head is
// zero-padded by the wrapper (zero units add exact zeros to every sum).
//
// The bf16 arm's 1b, 3 and P3 (namespace bfa, explicit specializations of
// k3_jacobians, k3_params and so3_preacts_kernel), for Hopper:
//  - Balanced tiles. 1a counts the active rows of traj (ray-major) in each
//    range of 256; every block of 1b and 3 scans the counts: A active
//    ray-steps make T = ceil(A / R) tiles of R (64 in 1b, 128 in 3), and
//    block b of G takes tiles [b T / G, (b + 1) T / G), so no block runs
//    more than one tile more than another. 1b compacts its share in
//    ray-major order into the list (a ballot a warp, from the range that
//    holds its first tile), and 3 reads the list back. T is read on the
//    card, never on the host, and every scratch has a shape fixed by B x
//    S, so the call is captured in the K-step CUDA graph as it is.
//  - Resident weights. One persistent block of 8 warps an SM loads the
//    head's bf16 weights into its shared memory once (cp.async): W0t,
//    W1t, W2t and W3t as 512 input-major rows of 128. Forward and tangent
//    products read them as [k][n] (ldmatrix.trans), the cotangents dZ W^T
//    as [n][k] (ldmatrix): one copy, and no weight read from L2 in the
//    tile loop.
//  - Groups of warps that share 32 rows of a tile (named barriers from 1):
//    a group's products, epilogues, PE, output layer and Rodrigues touch
//    its own rows alone, so the groups run apart between block barriers.
//    1b: two groups of 4 warps on tiles of 64, each warp a 32 x 32 block
//    of m16n8 fragments; a layer's forward and its three tangents run in
//    one pass over the layer's weights (four accumulators; the PE's
//    derivative is loaded once and masked to each axis in registers). 3:
//    four groups of 2 warps on tiles of 128, each warp 32 x 64; the
//    forward runs through two activation buffers (x -> A -> B -> A -> B)
//    while each warp keeps its blocks of h0 and h1 in registers, and the
//    backward stages them back into the buffer just freed: the masks and
//    the weight gradients' operands of a 128-row tile in 227 KB with the
//    weights. dW = A^T dZ runs over the tile's 128 rows (all groups), so
//    each block's 262 KB partial is read and written once per 128 rows.
//  - The sum in the tensor core. Each mma.sync m16n8k16 adds its k16 step
//    to the accumulator itself, k in order: over the layer's input, then
//    the skip input; the fp32 bias is added after (mlp_common.cuh's
//    add_mma, which K4 and K5 keep, sums each step from zero and adds it
//    in fp32). P3 and K2's bf16 head run the same layer()
//    (so3_bf16.cuh) and so give these pre-activations bit for bit.
//  - Overlap instead of occupancy (the weights leave room for one block):
//    the next tile's gathers are in flight while a tile's products run
//    (cp.async of 4 bytes: in 1b p after the PE and g after K; in 3 p and
//    g after the sines, dbar after rawbar is used). 3 keeps dWout, dbout
//    and the bias gradients in registers over all its tiles and adds them
//    to the partial once a block; dW goes to the partial once a tile, the
//    old values loaded before the products and stored in aligned pairs
//    that fill whole sectors.
//  Shared memory (bytes): 1b 228,952: weights 139,264; x, dco 9,216 each
//  (dco then each group's raw, traw and Rodrigues rows); h 17,408; three
//  tangents 52,224; p, g 768 each; window and scan 88. 3 232,024: weights
//  139,264; x (then raw, then the sines) 18,432; two activation buffers
//  34,816 each; p, g, dbar (then rawbar) 4,608; window and scan 88. P3
//  114,472 (layers 1-3's weights, x, h, p), two blocks an SM.
//
// What bounds it: the head's arithmetic at the active ray-steps. The
// design runs seven head products a ray-step (1b: forward and three
// tangents; 3: forward, cotangents, dW), 7/3 of the bound's three; besides,
// it streams the trajectory and its cotangent once, the pieces out and
// back in (88 bytes a ray-step), and each block's 262 KB partial through L2
// once a tile (128 rows in the bf16 arm). In the bf16 arm a warp's k16 step
// reads 2 KB of fragments from shared memory for 8 mma.sync (1b's fused
// layer: 3 to 5 KB for 32), so shared memory's 128 bytes a clock an SM
// hold it near half the dense bf16 peak; one block of 8 warps an SM hides
// less of ldmatrix's and the mma's latency than more warps would.
//
// The file also holds P3 (so3_preacts_launch), which computes the head's
// pre-activations with 1b's and 3's forward in either arm, so that ReLU
// masks can be held against another summation order's.

#include "mlp_common.cuh"
#include "so3_bf16.cuh"

namespace {

using fused_mlp::bf16;

constexpr int kThreads = fused_mlp::kThreads;  // 256
constexpr int kW = 128;        // hidden width of the products
constexpr int kIn = 64;        // PE columns kept; zero past 6 * max_deg
constexpr int kMaxDeg = 10;
constexpr int kFields = 22;    // pieces a ray-step: K 9, a 3, inv_n,
                               // c_p 3, c_d 3, d 3
constexpr int kChunk = 8;      // steps a sweep stage holds
constexpr float kHalfPi = 1.5707963267948966f;

// The fp32 arm: CUDA-core products, 64-row tiles, 16 weight rows a slab.
struct F32Arm {
  using T = float;
  using Engine = fused_mlp::Simt<kW, float>;
  using GradEngine = Engine;   // A^T Z, 64 output rows a call
  using GradXEngine = Engine;  // the same over the PE's columns
  struct Pol {
    using Elem = float;
    static constexpr int kSlab = 16;
  };
};

// The bf16 arm: its passes 1b and 3 and P3 are the kernels of namespace
// bfa below (explicit specializations), not the templates above.
struct Bf16Arm {
  using T = bf16;
};

// An arm's tile rows, its shared-memory row strides (padded by 16 bytes)
// and its weight ring.
template <typename A>
constexpr int kTileOf = A::Engine::kRows;
template <typename A>
constexpr int kLdXOf = kIn + fused_mlp::pad<typename A::T>();
template <typename A>
constexpr int kLdHOf = kW + fused_mlp::pad<typename A::T>();
template <typename A>
constexpr int kRingOf = fused_mlp::kStages * A::Pol::kSlab * kLdHOf<A>;

// v as an operand of arm T: itself, or rounded to bf16.
template <typename T>
__device__ __forceinline__ float operand(float v) {
  const T r = fused_mlp::round_to<T>(v);
  return fused_mlp::load(&r);
}

// The head's weights. Forward pack, input-major, hidden units padded to
// kW: W0t [I][kW] b0 W1t [kW][kW] b1 W2t b2 W3t [kW + I][kW] b3 Woutt
// [kW][3] bout, in fp32 (the biases and the output layer are read from
// it) and as the products' operands, T (the weights at the same offsets).
// Backward pack, nn.Linear layout [out][in], T: W1, W2 and the first kW
// inputs of W3, each [kW][kW].
template <typename T>
struct Net {
  const T *w0t, *w1t, *w2t, *w3t;
  const float *b0, *b1, *b2, *b3, *wot, *bo;
  const T *w1, *w2, *w3;
  int in_dim;
};

template <typename T>
__device__ __forceinline__ Net<T> make_net(const float* fwd, const T* fwd_t,
                                           const T* bwd, int in_dim) {
  Net<T> n;
  const int I = in_dim;
  const int o_b0 = I * kW, o_w1 = o_b0 + kW, o_b1 = o_w1 + kW * kW;
  const int o_w2 = o_b1 + kW, o_b2 = o_w2 + kW * kW, o_w3 = o_b2 + kW;
  const int o_b3 = o_w3 + (kW + I) * kW, o_wo = o_b3 + kW,
            o_bo = o_wo + kW * 3;
  n.in_dim = I;
  n.w0t = fwd_t;        n.b0 = fwd + o_b0;
  n.w1t = fwd_t + o_w1; n.b1 = fwd + o_b1;
  n.w2t = fwd_t + o_w2; n.b2 = fwd + o_b2;
  n.w3t = fwd_t + o_w3; n.b3 = fwd + o_b3;
  n.wot = fwd + o_wo;   n.bo = fwd + o_bo;
  n.w1 = bwd;           n.w2 = bwd + kW * kW;
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

// The 8 corners of the cell that holds p, c[x + 2 y + 4 z] (clamped
// indices, ops/grid.trilinear), and its fractions.
__device__ __forceinline__ void cell_corners(const GridArgs& a, float px,
                                             float py, float pz,
                                             float4 (&c)[8], float& xd,
                                             float& yd, float& zd) {
  const float cx = (px - a.nmin_x) / a.nd_x;
  const float cy = (py - a.nmin_y) / a.nd_y;
  const float cz = (pz - a.nmin_z) / a.nd_z;
  const float fx0 = floorf(cx), fy0 = floorf(cy), fz0 = floorf(cz);
  xd = cx - fx0;
  yd = cy - fy0;
  zd = cz - fz0;
  const int ix = (int)fx0, iy = (int)fy0, iz = (int)fz0;
  const long long x0 = clampi(ix, a.nx - 1), x1 = clampi(ix + 1, a.nx - 1);
  const long long y0 = clampi(iy, a.ny - 1), y1 = clampi(iy + 1, a.ny - 1);
  const long long z0 = clampi(iz, a.nz - 1), z1 = clampi(iz + 1, a.nz - 1);
  const long long sy = a.nz, sx = (long long)a.ny * a.nz;
  const float4* g = a.grid;
  c[0] = __ldg(g + sx * x0 + sy * y0 + z0);
  c[1] = __ldg(g + sx * x1 + sy * y0 + z0);
  c[2] = __ldg(g + sx * x0 + sy * y1 + z0);
  c[3] = __ldg(g + sx * x1 + sy * y1 + z0);
  c[4] = __ldg(g + sx * x0 + sy * y0 + z1);
  c[5] = __ldg(g + sx * x1 + sy * y0 + z1);
  c[6] = __ldg(g + sx * x0 + sy * y1 + z1);
  c[7] = __ldg(g + sx * x1 + sy * y1 + z1);
}

// d(trilinear)/dp of ops/grid.trilinear at p: dv[a] = the derivative of
// the x-then-y-then-z lerps of [n, g] along axis a, over the voxel size
// (the fraction has slope 1 / ndelta; clamped corners give 0).
__device__ void trilinear_jacobian(const GridArgs& a, float px, float py,
                                   float pz, float4 (&dv)[3]) {
  float4 c[8];
  float xd, yd, zd;
  cell_corners(a, px, py, pz, c, xd, yd, zd);
  const float4 c000 = c[0], c100 = c[1], c010 = c[2], c110 = c[3];
  const float4 c001 = c[4], c101 = c[5], c011 = c[6], c111 = c[7];
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

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The same derivative in the passes form's bf16 arm (eikonal_vjp.py:
// 300-321): along axis a, its weights are the one-hot derivative (-1 at
// the lower corner, +1 at the upper) and the other axes' the lerp weights
// (1 - f, f); dv[a] = sum_z uz(z) sum_{y, x} bf16(c_xyz) bf16(ux(x) uy(y)),
// each bf16 product exact in fp32, summed along x, then y (the lower
// corner's addend first), then the z sum in fp32; over the voxel size.
// ops/eikonal_vjp.trilinear_jacobian_bf16 is its plain version.
__device__ void trilinear_jacobian_bf16(const GridArgs& a, float px,
                                        float py, float pz,
                                        float4 (&dv)[3]) {
  float4 c[8];
  float xd, yd, zd;
  cell_corners(a, px, py, pz, c, xd, yd, zd);
  const float lerp_w[3][2] = {{1.0f - xd, xd}, {1.0f - yd, yd},
                              {1.0f - zd, zd}};
  const float nd[3] = {a.nd_x, a.nd_y, a.nd_z};
  for (int ax = 0; ax < 3; ++ax) {
    float w[3][2];
    for (int k = 0; k < 3; ++k) {
      w[k][0] = k == ax ? -1.0f : lerp_w[k][0];
      w[k][1] = k == ax ? 1.0f : lerp_w[k][1];
    }
    float t[2][4];
    for (int z = 0; z < 2; ++z) {
      float q[4][4];  // [x + 2 y][channel]
      for (int xy = 0; xy < 4; ++xy) {
        const float wxy = bf16r(w[0][xy & 1] * w[1][xy >> 1]);
        const float4 v = c[xy + 4 * z];
        q[xy][0] = bf16r(v.x) * wxy;
        q[xy][1] = bf16r(v.y) * wxy;
        q[xy][2] = bf16r(v.z) * wxy;
        q[xy][3] = bf16r(v.w) * wxy;
      }
      for (int ch = 0; ch < 4; ++ch)
        t[z][ch] = (q[0][ch] + q[1][ch]) + (q[2][ch] + q[3][ch]);
    }
    float o[4];
    for (int ch = 0; ch < 4; ++ch)
      o[ch] = (t[0][ch] * w[2][0] + t[1][ch] * w[2][1]) / nd[ax];
    dv[ax] = make_float4(o[0], o[1], o[2], o[3]);
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

// ------------------------------------------------- the head on a tile

// The annealed PE of the tile's points p[r] (r < the arm's tile rows),
// column f < I of degree f / 6, coordinate f % 3, sine for f % 6 < 3 and
// the sine of the argument + pi/2 past it: x[r][f] = sin(arg) * win[deg];
// with val, the sine itself; with dco, the derivative of x[r][f] along
// p[r][f % 3], cos(arg) 2^deg win[deg]. Columns I .. kIn - 1 are zero.
// Each is stored as the arm's operand.
template <typename A>
__device__ void so3_encode(const float (*p)[3], int in_dim, const float* win,
                           typename A::T* x, typename A::T* val,
                           typename A::T* dco) {
  using T = typename A::T;
  constexpr int R = kTileOf<A>, LD = kLdXOf<A>;
  for (int i = threadIdx.x; i < R * kIn; i += kThreads) {
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
    x[r * LD + f] = fused_mlp::round_to<T>(xv);
    if (val) val[r * LD + f] = fused_mlp::round_to<T>(sv);
    if (dco) dco[r * LD + f] = fused_mlp::round_to<T>(dv);
  }
}

// One hidden layer of the head on the tile, on the arm's engine: out[r][c]
// = ReLU(sum_k s0(r, k) W[k][c] + sum_k s1(r, k) W[s0.k + k][c] + b[c]),
// each sum from zero in k order (fp32), or in k16 steps (bf16), stored as
// the arm's operand. W is input-major [*][kW] in device memory. With pre,
// the fp32 pre-activations of rows r < rows and columns c < width also go
// to pre[r * width + c]. out may be s0's buffer.
template <typename A, typename T = typename A::T>
__device__ void so3_layer(const fused_mlp::ASeg<T>& s0,
                          const fused_mlp::ASeg<T>& s1, const T* w,
                          const float* b, T* out, T* ring,
                          float* pre = nullptr, int rows = 0,
                          int width = 0) {
  typename A::Engine e;
  e.zero();
  fused_mlp::weight_product<typename A::Pol, kW>(e, s0, s1, w, kW, ring);
  e.template each<false>([&](int, int r, int c, float v0, float v1) {
    v0 += __ldg(b + c);
    v1 += __ldg(b + c + 1);
    if (pre && r < rows) {
      if (c < width) pre[r * width + c] = v0;
      if (c + 1 < width) pre[r * width + c + 1] = v1;
    }
    fused_mlp::store_pair(out + r * kLdHOf<A> + c, fmaxf(v0, 0.0f),
                          fmaxf(v1, 0.0f));
  });
  __syncthreads();
}

// A layer's product without bias, its output masked by mask[r][c] > 0:
// out[r][c] = (sum_k s0(r, k) W[k][c] + ...) * (mask > 0), W [*][ldw] in
// device memory, its first kW columns. The tangents (W input-major) and
// the cotangents (W in nn.Linear layout) of the head. out may be s0's
// buffer.
template <typename A, typename T = typename A::T>
__device__ void masked_product(const fused_mlp::ASeg<T>& s0,
                               const fused_mlp::ASeg<T>& s1, const T* w,
                               int ldw, const T* mask, T* out, T* ring) {
  constexpr int LD = kLdHOf<A>;
  typename A::Engine e;
  e.zero();
  fused_mlp::weight_product<typename A::Pol, kW>(e, s0, s1, w, ldw, ring);
  e.template each<false>([&](int, int r, int c, float v0, float v1) {
    const bool m0 = fused_mlp::load(mask + r * LD + c) > 0.0f;
    const bool m1 = fused_mlp::load(mask + r * LD + c + 1) > 0.0f;
    fused_mlp::store_pair(out + r * LD + c, m0 ? v0 : 0.0f, m1 ? v1 : 0.0f);
  });
  __syncthreads();
}

// raw[r][o] = sum_k h[r][k] Wout[k][o] (+ bout[o] when bias), k in order.
template <typename A, typename T = typename A::T>
__device__ void so3_out(const T* h, const Net<T>& n, bool bias,
                        float (*raw)[3]) {
  for (int i = threadIdx.x; i < kTileOf<A> * 3; i += kThreads) {
    const int r = i / 3, o = i % 3;
    float acc = 0.0f;
    for (int k = 0; k < kW; ++k)
      acc = __fmaf_rn(fused_mlp::load(h + r * kLdHOf<A> + k),
                      __ldg(n.wot + 3 * k + o), acc);
    raw[r][o] = bias ? acc + __ldg(n.bo + o) : acc;
  }
}

// ------------------------------------------- compaction of active steps

// The active ray-steps of [begin, end), in order, handed to tile(nt) in
// groups of R (the last one shorter) as list[0 .. nt).
template <int R, typename Tile>
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
    while (count >= R) {
      tile(R);
      int keep[2];
      const int rest = count - R;
      for (int q = 0; q < 2; ++q) {
        const int i = tid + q * kThreads;
        keep[q] = i < rest ? list[R + i] : 0;
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
  const float* wfwd;     // fp32 forward pack
  const void* wfwd_t;    // the arm's forward pack (wfwd in fp32)
  const void* wbwd_t;    // the arm's backward pack
  const float* window;   // [max_deg]
  GridArgs grid;
  float* pieces;         // [S][kFields][Bp]
  float* dbar;           // [B * S, 3]: dbar_{s+1} of each ray-step
  float* raybar;         // [B, 6]: pbar_0, dbar_0
  float* partial;        // [G, stride]: the first P of each row used
  int batch, bp, num_samples, max_deg;
  long long chunk;       // ray-steps a block of 1b / 3 owns (fp32 arm)
  float step;
  int* counts;           // bf16 arm: active ray-steps of each range of
                         // kThreads rows of traj, by k3_pieces
  int* list;             // bf16 arm: [B * S], the active rows compacted
  int stride;            // of the partial's rows (partial_stride)
};

template <typename T>
__device__ __forceinline__ Net<T> args_net(const Args& a) {
  return make_net(a.wfwd, static_cast<const T*>(a.wfwd_t),
                  static_cast<const T*>(a.wbwd_t), 6 * a.max_deg);
}

__device__ __forceinline__ float* piece(const Args& a, int s, int f,
                                        int ray) {
  return a.pieces + ((long long)s * kFields + f) * a.bp + ray;
}

// ------------------------------------------------------------ pass 1a

template <bool kBf16>
__global__ void __launch_bounds__(256) k3_pieces(const Args a) {
  const long long i = blockIdx.x * 256LL + threadIdx.x;
  const long long total = (long long)a.batch * a.num_samples;
  if constexpr (kBf16) {
    // The bf16 arm's partition: the active rows of traj (ray-major) among
    // this block's 256, in a.counts[block].
    __shared__ int warp_count[8];
    const bool f = i < total && active_g(a.traj + 11 * i);
    const unsigned ballot = __ballot_sync(0xffffffffu, f);
    if ((threadIdx.x & 31) == 0) warp_count[threadIdx.x >> 5] = __popc(ballot);
    __syncthreads();
    if (threadIdx.x == 0) {
      int n = 0;
      for (int w = 0; w < 8; ++w) n += warp_count[w];
      a.counts[blockIdx.x] = n;
    }
  }
  if (i >= total) return;
  const int s = (int)(i / a.batch), ray = (int)(i % a.batch);
  const long long row = (long long)ray * a.num_samples + s;
  const float* tr = a.traj + 11 * row;
  const float* ct = a.cts + 11 * row;
  const float h = a.step;
  const float dx = tr[3], dy = tr[4], dz = tr[5], n = tr[7];
  float4 dv[3];
  if (kBf16) {
    trilinear_jacobian_bf16(a.grid, tr[0], tr[1], tr[2], dv);
  } else {
    trilinear_jacobian(a.grid, tr[0], tr[1], tr[2], dv);
  }
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

template <typename A, typename T = typename A::T>
struct JacSmem {
  static constexpr int R = kTileOf<A>;
  T x[R * kLdXOf<A>];
  T dco[R * kLdXOf<A>];         // then a tangent's skip input
  T h[R * kLdHOf<A>];
  T t[3][R * kLdHOf<A>];
  T ring[kRingOf<A>];
  float p[R][3];
  float raw[R][3];
  float traw[3][R][3];
  float win[kMaxDeg];
  int list[kThreads + R];
  int warp_count[kThreads / 32];
};

// The tangent of the PE along axis c: dco's columns of coordinate c.
template <typename A, typename T = typename A::T>
__device__ void tangent_input(const T* dco, int c, T* out, int ld) {
  const T zero = fused_mlp::round_to<T>(0.0f);
  for (int i = threadIdx.x; i < kTileOf<A> * kIn; i += kThreads) {
    const int r = i / kIn, f = i % kIn;
    out[r * ld + f] = f % 3 == c ? dco[r * kLdXOf<A> + f] : zero;
  }
}

template <typename A, typename T = typename A::T>
__device__ void jacobian_tile(const Args& a, const Net<T>& net,
                              JacSmem<A>& m, int nt) {
  using Seg = fused_mlp::ASeg<T>;
  constexpr int R = kTileOf<A>, LDX = kLdXOf<A>, LDH = kLdHOf<A>;
  const int tid = threadIdx.x, I = net.in_dim;
  for (int i = tid; i < R * 3; i += kThreads) {
    const int r = i / 3, c = i % 3;
    m.p[r][c] = r < nt ? a.traj[11 * (long long)m.list[r] + c] : 0.0f;
  }
  __syncthreads();
  so3_encode<A>(m.p, I, m.win, m.x, nullptr, m.dco);
  __syncthreads();
  const Seg none = {nullptr, 0, 0};
  const T* wt[4] = {net.w0t, net.w1t, net.w2t, net.w3t};
  const float* bs[4] = {net.b0, net.b1, net.b2, net.b3};
  for (int l = 0; l < 4; ++l) {
    // Forward, into h (over its input past layer 0).
    const Seg in = l == 0 ? Seg{m.x, LDX, I} : Seg{m.h, LDH, kW};
    so3_layer<A>(in, l == 3 ? Seg{m.x, LDX, I} : none, wt[l], bs[l], m.h,
                 m.ring);
    // The three tangents, each over its own input, masked by h.
    for (int c = 0; c < 3; ++c) {
      if (l == 0) tangent_input<A>(m.dco, c, m.t[c], LDH);
      if (l == 3) tangent_input<A>(m.dco, c, m.x, LDX);  // x is free now
      if (l == 0 || l == 3) __syncthreads();
      const Seg tin = l == 0 ? Seg{m.t[c], LDH, I} : Seg{m.t[c], LDH, kW};
      masked_product<A>(tin, l == 3 ? Seg{m.x, LDX, I} : none, wt[l], kW,
                        m.h, m.t[c], m.ring);
    }
  }
  so3_out<A>(m.h, net, true, m.raw);
  for (int i = tid; i < 3 * R * 3; i += kThreads) {
    const int c = i / (R * 3), r = (i / 3) % R, o = i % 3;
    float acc = 0.0f;
    for (int k = 0; k < kW; ++k)
      acc = __fmaf_rn(fused_mlp::load(m.t[c] + r * LDH + k),
                      __ldg(net.wot + 3 * k + o), acc);
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

template <typename A>
__global__ void __launch_bounds__(kThreads) k3_jacobians(const Args a) {
  using T = typename A::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  JacSmem<A>& m = *reinterpret_cast<JacSmem<A>*>(smem_raw);
  const Net<T> net = args_net<T>(a);
  if (threadIdx.x < a.max_deg) m.win[threadIdx.x] = a.window[threadIdx.x];
  __syncthreads();
  const long long total = (long long)a.batch * a.num_samples;
  const long long begin = blockIdx.x * a.chunk;
  const long long end = begin + a.chunk < total ? begin + a.chunk : total;
  active_tiles<kTileOf<A>>(a.traj, begin, end, m.list, m.warp_count,
                           [&](int nt) { jacobian_tile<A>(a, net, m, nt); });
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

template <typename A, typename T = typename A::T>
struct ParamSmem {
  static constexpr int R = kTileOf<A>;
  T x[R * kLdXOf<A>];
  T val[R * kLdXOf<A>];
  T h[4][R * kLdHOf<A>];   // h[3] then each layer's cotangent in turn
  T ring[kRingOf<A>];
  float p[R][3];
  float raw[R][3];
  float rb[R][3];
  float win[kMaxDeg];
  int list[kThreads + R];
  int warp_count[kThreads / 32];
};

// part[(row0 + m) * kW + c] += sum_r A[r][m0 + m] Z[r][c] over the tile's
// rows in order, for m0 + m < mrows, on engine E (E::kRows values of m a
// call): A [R][lda], Z [R][ldz] in shared memory.
template <typename E, int R, typename T>
__device__ void grad_product(const T* a, int lda, int m0, int mrows,
                             const T* z, int ldz, float* part, int row0) {
  E e;
  e.zero();
  for (int k = 0; k < R; k += E::kK)
    e.step_t(a + k * lda + m0, lda, z + k * ldz, ldz);
  e.template each<true>([&](int, int r, int c, float v0, float v1) {
    const int m = m0 + r;
    if (m >= mrows) return;
    float* q = part + (long long)(row0 + m) * kW + c;
    q[0] += v0;
    q[1] += v1;
  });
}

// The weight gradients of a layer over the tile: dW rows [0, kW) against
// the hidden input h, and (skip) rows [kW, kW + I) against the PE's sines.
template <typename A, typename T = typename A::T>
__device__ void hidden_grad(const T* h, const T* z, float* part) {
  using E = typename A::GradEngine;
  for (int m0 = 0; m0 < kW; m0 += E::kRows)
    grad_product<E, kTileOf<A>>(h, kLdHOf<A>, m0, kW, z, kLdHOf<A>, part, 0);
}

template <typename A, typename T = typename A::T>
__device__ void sine_grad(const T* val, int in_dim, const T* z, float* part,
                          int row0) {
  grad_product<typename A::GradXEngine, kTileOf<A>>(
      val, kLdXOf<A>, 0, in_dim, z, kLdHOf<A>, part, row0);
}

// bias[c] += sum_r Z[r][c] over the tile's rows in order.
template <typename A, typename T = typename A::T>
__device__ void bias_sum(const T* z, float* bias) {
  for (int c = threadIdx.x; c < kW; c += kThreads) {
    float s = 0.0f;
    for (int r = 0; r < kTileOf<A>; ++r)
      s += fused_mlp::load(z + r * kLdHOf<A> + c);
    bias[c] += s;
  }
}

template <typename A, typename T = typename A::T>
__device__ void param_tile(const Args& a, const Net<T>& net, ParamSmem<A>& m,
                           float* part, int nt) {
  using Seg = fused_mlp::ASeg<T>;
  constexpr int R = kTileOf<A>, LDX = kLdXOf<A>, LDH = kLdHOf<A>;
  const int tid = threadIdx.x, I = net.in_dim;
  const float h = a.step;
  for (int i = tid; i < R * 3; i += kThreads) {
    const int r = i / 3, c = i % 3;
    m.p[r][c] = r < nt ? a.traj[11 * (long long)m.list[r] + c] : 0.0f;
  }
  __syncthreads();
  so3_encode<A>(m.p, I, m.win, m.x, m.val, nullptr);
  __syncthreads();
  const Seg none = {nullptr, 0, 0};
  so3_layer<A>(Seg{m.x, LDX, I}, none, net.w0t, net.b0, m.h[0], m.ring);
  so3_layer<A>(Seg{m.h[0], LDH, kW}, none, net.w1t, net.b1, m.h[1], m.ring);
  so3_layer<A>(Seg{m.h[1], LDH, kW}, none, net.w2t, net.b2, m.h[2], m.ring);
  so3_layer<A>(Seg{m.h[2], LDH, kW}, Seg{m.x, LDX, I}, net.w3t, net.b3,
               m.h[3], m.ring);
  so3_out<A>(m.h[3], net, true, m.raw);
  __syncthreads();
  if (tid < R) {
    float3 rb = make_float3(0.f, 0.f, 0.f), gb;
    if (tid < nt) {
      const long long idx = m.list[tid];
      const float* tr = a.traj + 11 * idx;
      const float* db = a.dbar + 3 * idx;
      rodrigues_bwd(make_float3(m.raw[tid][0], m.raw[tid][1], m.raw[tid][2]),
                    make_float3(tr[8], tr[9], tr[10]),
                    make_float3(h * db[0], h * db[1], h * db[2]), &rb, &gb);
    }
    // rawbar as the products' operand.
    m.rb[tid][0] = operand<T>(rb.x);
    m.rb[tid][1] = operand<T>(rb.y);
    m.rb[tid][2] = operand<T>(rb.z);
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
    for (int r = 0; r < R; ++r)
      acc = __fmaf_rn(fused_mlp::load(m.h[3] + r * LDH + k), m.rb[r][o],
                      acc);
    pwo[e] += acc;
  }
  if (tid < 3) {
    float acc = 0.0f;
    for (int r = 0; r < R; ++r) acc += m.rb[r][tid];
    pbo[tid] += acc;
  }
  __syncthreads();
  T* dz = m.h[3];
  const T zero = fused_mlp::round_to<T>(0.0f);
  for (int i = tid; i < R * kW; i += kThreads) {
    const int r = i / kW, c = i % kW;
    float v = 0.0f;
    for (int o = 0; o < 3; ++o)
      v = __fmaf_rn(m.rb[r][o], __ldg(net.wot + 3 * c + o), v);
    dz[r * LDH + c] = fused_mlp::load(dz + r * LDH + c) > 0.0f
                          ? fused_mlp::round_to<T>(v)
                          : zero;
  }
  __syncthreads();
  // Layer 3: dW over [h2 | sines], its cotangent to h2.
  bias_sum<A>(dz, pb3);
  hidden_grad<A>(m.h[2], dz, pw3);
  sine_grad<A>(m.val, I, dz, pw3, kW);
  __syncthreads();
  masked_product<A>(Seg{dz, LDH, kW}, none, net.w3, kW, m.h[2], dz, m.ring);
  // Layers 2, 1, 0.
  float* const pws[3] = {pw2, pw1, pw0};
  float* const pbs[3] = {pb2, pb1, pb0};
  const T* const wb[2] = {net.w2, net.w1};
  for (int l = 2; l >= 0; --l) {
    bias_sum<A>(dz, pbs[2 - l]);
    if (l > 0) {
      hidden_grad<A>(m.h[l - 1], dz, pws[2 - l]);
    } else {
      sine_grad<A>(m.val, I, dz, pws[2], 0);
    }
    __syncthreads();
    if (l > 0) {
      masked_product<A>(Seg{dz, LDH, kW}, none, wb[2 - l], kW, m.h[l - 1],
                        dz, m.ring);
    }
  }
}

template <typename A>
__global__ void __launch_bounds__(kThreads) k3_params(const Args a) {
  using T = typename A::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ParamSmem<A>& m = *reinterpret_cast<ParamSmem<A>*>(smem_raw);
  const int I = 6 * a.max_deg, P = num_params(I);
  const Net<T> net = args_net<T>(a);
  float* part = a.partial + (long long)blockIdx.x * P;
  for (int e = threadIdx.x; e < P; e += kThreads) part[e] = 0.0f;
  if (threadIdx.x < a.max_deg) m.win[threadIdx.x] = a.window[threadIdx.x];
  __syncthreads();
  const long long total = (long long)a.batch * a.num_samples;
  const long long begin = blockIdx.x * a.chunk;
  const long long end = begin + a.chunk < total ? begin + a.chunk : total;
  active_tiles<kTileOf<A>>(
      a.traj, begin, end, m.list, m.warp_count,
      [&](int nt) { param_tile<A>(a, net, m, part, nt); });
}

__global__ void k3_reduce(const float* partial, int num_blocks,
                          int num_params, int stride, float* out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= num_params) return;
  float s = 0.0f;
  for (int b = 0; b < num_blocks; ++b)
    s += partial[(long long)b * stride + e];
  out[e] = s;
}

// The partial's row stride: P in the fp32 arm; in the bf16 arm P rounded
// up to 8 floats, so that every block's row starts on 32 bytes and pass 3
// moves its sums in aligned pairs that fill whole 32-byte sectors
// (ops/eikonal_vjp.partial_stride).
__host__ __device__ inline int partial_stride(int num_params, bool bf16) {
  return bf16 ? (num_params + 7) / 8 * 8 : num_params;
}

// P3, the ReLU-flip probe: the so3 head's pre-activations of hidden layers
// 1-3 at n points, with K3's own forward (so3_encode, so3_layer) in either
// arm: each value is bitwise what passes 1b and 3 compute at that point.
// Replaces the Pallas kernel of samplenerfro_tpu's
// scripts/debug/probe_so3_relu.py. A block takes a tile of points. Bound
// by its multiply-adds (60 W + 2 W^2 a point), fp32 on CUDA cores or bf16
// on tensor cores.
template <typename A, typename T = typename A::T>
struct PreactSmem {
  static constexpr int R = kTileOf<A>;
  T x[R * kLdXOf<A>];
  T h[R * kLdHOf<A>];
  T ring[kRingOf<A>];
  float p[R][3];
  float win[kMaxDeg];
};

template <typename A>
__global__ void __launch_bounds__(kThreads)
    so3_preacts_kernel(const float* pts, const float* wfwd,
                       const void* wfwd_t, const float* window, float* pre,
                       int n, int max_deg, int width) {
  using T = typename A::T;
  using Seg = fused_mlp::ASeg<T>;
  constexpr int R = kTileOf<A>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PreactSmem<A>& m = *reinterpret_cast<PreactSmem<A>*>(smem_raw);
  const int I = 6 * max_deg;
  // Only the forward pack is read.
  const T* fwd_t = static_cast<const T*>(wfwd_t);
  const Net<T> net = make_net(wfwd, fwd_t, fwd_t, I);
  if (threadIdx.x < max_deg) m.win[threadIdx.x] = window[threadIdx.x];
  const long long row0 = (long long)blockIdx.x * R;
  const int rows = n - row0 < R ? (int)(n - row0) : R;
  for (int i = threadIdx.x; i < R * 3; i += kThreads) {
    const int r = i / 3, c = i % 3;
    m.p[r][c] = r < rows ? pts[3 * (row0 + r) + c] : 0.0f;
  }
  __syncthreads();
  so3_encode<A>(m.p, I, m.win, m.x, nullptr, nullptr);
  __syncthreads();
  const Seg none = {nullptr, 0, 0};
  const T* const w[3] = {net.w0t, net.w1t, net.w2t};
  const float* const b[3] = {net.b0, net.b1, net.b2};
  for (int l = 0; l < 3; ++l) {
    const Seg in = l == 0 ? Seg{m.x, kLdXOf<A>, I} : Seg{m.h, kLdHOf<A>, kW};
    so3_layer<A>(in, none, w[l], b[l], m.h, m.ring,
                 pre + (long long)l * n * width + row0 * width, rows, width);
  }
}

// ------------------------------------------------- the bf16 arm on Hopper
//
// Passes 1b and 3 and P3 in the bf16 arm: one persistent block of 8 warps
// an SM, the head's bf16 weights resident in its shared memory, the sums
// kept in the tensor core's accumulators (see the header note).
namespace bfa {

using namespace so3bf;

constexpr int kRows = 64;             // ray-steps a tile of 1b (and P3)
constexpr int kRowsP = 128;           // ray-steps a tile of pass 3
constexpr int kRange = kThreads;      // rows of traj a count covers

// The warps of a block in groups (so3_bf16.cuh's Geo): 1b and P3 two
// groups of 4 (tiles of 64), pass 3 four groups of 2 (tiles of 128).
using G1 = Geo<4>;
using G3 = Geo<2>;

// 4 bytes from src to dst (shared), asynchronously.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   fused_mlp::smem_addr(dst)),
               "l"(src)
               : "memory");
}

// load_a's fragments of A stored transposed, [k][m]: m0 .. m0 + 16 MT -
// 1, k rows k0 .. k0 + 15.
template <int MT>
__device__ __forceinline__ void load_at(unsigned (&af)[MT][4], const bf16* a,
                                        int lda, int m0, int k0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    fused_mlp::ldsm_x4_t(af[mt],
                         a + (k0 + (lane & 7) + ((lane >> 4) << 3)) * lda +
                             m0 + 16 * mt + ((lane >> 3) & 1) * 8);
}

// A's fragments with the values at columns k, k % 3 != axis, zeroed: the
// PE's tangent seeds along one axis of p, from its derivative's columns.
__device__ __forceinline__ void mask_axis(const unsigned (&af)[2][4],
                                          unsigned (&out)[2][4], int k0,
                                          int axis) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = k0 + 2 * t + 8 * (j >> 1);
    const unsigned m = (k % 3 == axis ? 0x0000ffffu : 0u) |
                       ((k + 1) % 3 == axis ? 0xffff0000u : 0u);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) out[mt][j] = af[mt][j] & m;
  }
}

// A bf16 pair's two values, each > 0.
__device__ __forceinline__ void positive(unsigned pair, bool& m0, bool& m1) {
  m0 = __uint_as_float(pair << 16) > 0.0f;
  m1 = __uint_as_float(pair & 0xffff0000u) > 0.0f;
}

// One segment of a layer of 1b: c[0] += F W and c[1 + q] += T_q W over k
// in [0, K), one pass over W's fragments. kPe: F is the PE's features x
// and every T_q the PE's derivative dco masked to axis q (layer 0, and
// layer 3's PE inputs); otherwise F is h and T_q the tangent t[q].
template <int K, bool kPe>
__device__ __forceinline__ void jac_seg(Acc<2, 4> (&c)[4], const bf16* f,
                                        const bf16* const (&t)[3], int lda,
                                        const bf16* w) {
  const int row0 = G1::row0();
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    unsigned bf[2][4], af[2][4];
    load_b<false, 2>(bf, w, kLdH, k0, G1::col0());
    load_a<2>(af, f, lda, row0, k0);
    mma_step(c[0], af, bf);
    if (kPe) {
      unsigned d[2][4];
      load_a<2>(d, t[0], lda, row0, k0);
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        mask_axis(d, af, k0, q);
        mma_step(c[1 + q], af, bf);
      }
    } else {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        load_a<2>(af, t[q], lda, row0, k0);
        mma_step(c[1 + q], af, bf);
      }
    }
  }
}

// Layer l of 1b on the group's rows in one pass over its weights: the
// forward h = bf16(ReLU(F W + b)) (as layer() sums it) and the three
// tangents t[q] = bf16(T_q W) where h > 0, zero elsewhere. Segment 0
// (K0, kPe0 as jac_seg) meets w0; with kSkip, layer 3's PE inputs (x, and
// dco masked) meet w1. in_place: the outputs overwrite segment 0's inputs.
template <int K0, bool kPe0, bool kSkip>
__device__ void jac_layer(const bf16* f, const bf16* const (&ta)[3], int lda,
                          const bf16* w0, const bf16* x, const bf16* dco,
                          const bf16* w1, const float* b, bf16* h,
                          bf16* const (&t)[3], bool in_place) {
  Acc<2, 4> c[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) c[q].zero();
  jac_seg<K0, kPe0>(c, f, ta, lda, w0);
  if (kSkip) {
    const bf16* const d3[3] = {dco, dco, dco};
    jac_seg<kIn, true>(c, x, d3, kLdX, w1);
  }
  if (in_place) G1::sync();
  c[0].each(G1::row0(), G1::col0(),
            [&](int mt, int nt, int hh, int r, int col, float v0, float v1) {
              v0 += __ldg(b + col);
              v1 += __ldg(b + col + 1);
              __nv_bfloat162 hv;
              hv.x = __float2bfloat16_rn(fmaxf(v0, 0.0f));
              hv.y = __float2bfloat16_rn(fmaxf(v1, 0.0f));
              *reinterpret_cast<__nv_bfloat162*>(h + r * kLdH + col) = hv;
              bool m0, m1;
              positive(*reinterpret_cast<unsigned*>(&hv), m0, m1);
#pragma unroll
              for (int q = 0; q < 3; ++q)
                fused_mlp::store_pair(
                    t[q] + r * kLdH + col,
                    m0 ? c[1 + q].v[mt][nt][2 * hh] : 0.0f,
                    m1 ? c[1 + q].v[mt][nt][2 * hh + 1] : 0.0f);
            });
  G1::sync();
}

// The annealed PE (so3_encode's arithmetic) of the group's rows: x =
// sin(arg) win, val the sine, dco the derivative along its coordinate.
template <typename G>
__device__ void encode(const float (*p)[3], int in_dim, const float* win,
                       bf16* x, bf16* val, bf16* dco) {
  for (int i = G::tid(); i < 32 * kIn; i += G::kThr) {
    const int r = G::row0() + i / kIn, f = i % kIn;
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
    if (x) x[r * kLdX + f] = __float2bfloat16_rn(xv);
    if (val) val[r * kLdX + f] = __float2bfloat16_rn(sv);
    if (dco) dco[r * kLdX + f] = __float2bfloat16_rn(dv);
  }
}

// Issues the cp.async copies of the head's weight rows [0, rows) into w.
__device__ void load_weights(bf16* w, const Net<bf16>& n, int rows) {
  const int I = n.in_dim;
  for (int x = threadIdx.x; x < rows * (kW / 8); x += kThreads) {
    const int r = x / (kW / 8), q = x % (kW / 8);
    const bf16* src = nullptr;
    if (r < kW1) {
      if (r < I) src = n.w0t + r * kW;
    } else if (r < kW2) {
      src = n.w1t + (r - kW1) * kW;
    } else if (r < kW3) {
      src = n.w2t + (r - kW2) * kW;
    } else if (r < kW3x) {
      src = n.w3t + (r - kW3) * kW;
    } else if (r - kW3x < I) {
      src = n.w3t + (kW + r - kW3x) * kW;
    }
    fused_mlp::cp_async16(w + r * kLdH + q * 8, src ? src + q * 8 : n.w0t,
                          src ? 16 : 0);
  }
  fused_mlp::cp_async_commit();
}

// s[o] = sum_k a[r][k] wo[k][o]: lane l sums k = 4 l .. 4 l + 3 in order,
// then the lanes by a butterfly; lane 0's sum is the result.
__device__ __forceinline__ void out_row(const bf16* a, int r,
                                        const float (&wo)[4][3],
                                        float (&s)[3]) {
  const int lane = threadIdx.x & 31;
  const float4 v4 = fused_mlp::load4(a + r * kLdH + 4 * lane);
  const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
  for (int o = 0; o < 3; ++o) {
    s[o] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) s[o] = __fmaf_rn(v[kk], wo[kk][o], s[o]);
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1)
      s[o] += __shfl_xor_sync(0xffffffffu, s[o], m);
  }
}

// The partition: a.counts holds the active rows of traj (ray-major) of
// each range of kRange; A of them in all make T = ceil(A / rows) tiles,
// and block b of G takes tiles [b T / G, (b + 1) T / G). With locate, j0
// is the range that holds the block's first active row and base0 the
// active rows before it.
struct Span {
  int active, tile0, tile1, j0, base0;
};

__device__ Span tile_span(const Args& a, int* sm, int rows, bool locate) {
  const long long total = (long long)a.batch * a.num_samples;
  const int nr = (int)((total + kRange - 1) / kRange);
  const int per = (nr + kThreads - 1) / kThreads;
  const int j_lo = min((int)threadIdx.x * per, nr);
  const int j_hi = min(j_lo + per, nr);
  int local = 0;
  for (int j = j_lo; j < j_hi; ++j) local += a.counts[j];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) sm[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < kThreads / 32; ++w) {
    if (w < warp) before += sm[w];
    all += sm[w];
  }
  const int excl = before + incl - local;
  const int tiles = (all + rows - 1) / rows;
  Span s;
  s.active = all;
  s.tile0 = (int)((long long)blockIdx.x * tiles / gridDim.x);
  s.tile1 = (int)((long long)(blockIdx.x + 1) * tiles / gridDim.x);
  s.j0 = 0;
  s.base0 = 0;
  if (locate) {
    const int p0 = s.tile0 * rows;
    if (s.tile0 < s.tile1 && excl <= p0 && p0 < excl + local) {
      int base = excl;
      for (int j = j_lo; j < j_hi; ++j) {
        const int n = a.counts[j];
        if (p0 < base + n) {
          sm[8] = j;
          sm[9] = base;
          break;
        }
        base += n;
      }
    }
    __syncthreads();
    s.j0 = sm[8];
    s.base0 = sm[9];
  }
  __syncthreads();
  return s;
}

// Writes a.list[q] = the row of the q-th active ray-step (ray-major) for
// the block's q in [tile0 rows, min(tile1 rows, A)), walking the ranges
// from j0 with a ballot a warp.
__device__ void compact(const Args& a, const Span& s, int* sm, int rows) {
  if (s.tile0 >= s.tile1) return;
  const long long total = (long long)a.batch * a.num_samples;
  const int p0 = s.tile0 * rows, p1 = min(s.tile1 * rows, s.active);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int base = s.base0;
  for (long long j = s.j0; base < p1; ++j) {
    const long long i = j * kRange + threadIdx.x;
    const bool f = i < total && active_g(a.traj + 11 * i);
    const unsigned ballot = __ballot_sync(0xffffffffu, f);
    if (lane == 0) sm[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, n = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      if (w < warp) before += sm[w];
      n += sm[w];
    }
    const int q = base + before + __popc(ballot & ((1u << lane) - 1u));
    if (f && q >= p0 && q < p1) a.list[q] = (int)i;
    base += n;
    __syncthreads();
  }
}

// Issues the cp.async copies of src[row * stride + off + c], c < 3, for
// the group's rows of tile `tile` (of `rows`) into dst (zeros past the
// tile's active rows, and past the block's tiles).
template <typename G>
__device__ void fetch(const Args& a, const Span& s, int tile, int rows,
                      const float* src, int stride, int off,
                      float (*dst)[3]) {
  const int nt = tile < s.tile1 ? min(rows, s.active - tile * rows) : 0;
  for (int i = G::tid(); i < 32 * 3; i += G::kThr) {
    const int r = G::row0() + i / 3, c = i % 3;
    if (r < nt) {
      cp_async4(&dst[r][c],
                src + (long long)stride * a.list[tile * rows + r] + off + c);
    } else {
      dst[r][c] = 0.0f;
    }
  }
}

// ------------------------------------------------------------- pass 1b

struct JacSmem {
  bf16 w[kWRows * kLdH];
  bf16 x[kRows * kLdX];
  bf16 dco[kRows * kLdX];  // then each group's scratch: raw, traw, rows of
                           // the Rodrigues Jacobians
  bf16 h[kRows * kLdH];
  bf16 t[3][kRows * kLdH];
  float p[kRows][3];
  float g[kRows][3];
  float win[kMaxDeg];
  int scan[12];
};

__device__ void jacobian_tile(const Args& a, const Net<bf16>& net,
                              JacSmem& m, const Span& s, int tile,
                              const float (&wo)[4][3]) {
  const int row0 = G1::row0(), I = net.in_dim;
  const int nt = min(kRows, s.active - tile * kRows);
  fused_mlp::cp_async_wait<1>();  // p of this tile (g may be in flight)
  G1::sync();
  encode<G1>(m.p, I, m.win, m.x, nullptr, m.dco);
  G1::sync();
  fetch<G1>(a, s, tile + 1, kRows, a.traj, 11, 0, m.p);
  fused_mlp::cp_async_commit();
  // Each layer's forward into h and the three tangents each over its own
  // input (the PE's derivative masked to the axis at layer 0 and in layer
  // 3's PE inputs), masked by h.
  const bf16* w = m.w;
  const bf16* const dco3[3] = {m.dco, m.dco, m.dco};
  const bf16* const tin[3] = {m.t[0], m.t[1], m.t[2]};
  bf16* const tout[3] = {m.t[0], m.t[1], m.t[2]};
  jac_layer<kIn, true, false>(m.x, dco3, kLdX, w + kW0 * kLdH, nullptr,
                              nullptr, nullptr, net.b0, m.h, tout, false);
  jac_layer<kW, false, false>(m.h, tin, kLdH, w + kW1 * kLdH, nullptr,
                              nullptr, nullptr, net.b1, m.h, tout, true);
  jac_layer<kW, false, false>(m.h, tin, kLdH, w + kW2 * kLdH, nullptr,
                              nullptr, nullptr, net.b2, m.h, tout, true);
  jac_layer<kW, false, true>(m.h, tin, kLdH, w + kW3 * kLdH, m.x, m.dco,
                             w + kW3x * kLdH, net.b3, m.h, tout, true);
  // The output layer: raw and its tangents, 8 rows a warp; into the
  // group's rows of dco (free now).
  float* sc = reinterpret_cast<float*>(m.dco + row0 * kLdX);
  float(*raw)[3] = reinterpret_cast<float(*)[3]>(sc);
  float(*traw)[32][3] = reinterpret_cast<float(*)[32][3]>(sc + 96);
  float(*jac)[3][6] = reinterpret_cast<float(*)[3][6]>(sc + 384);
  const int lane = threadIdx.x & 31;
  for (int i = 0; i < 8; ++i) {
    const int lr = 8 * ((threadIdx.x >> 5) & 3) + i, r = row0 + lr;
    float o3[3];
    out_row(m.h, r, wo, o3);
    if (lane == 0)
      for (int o = 0; o < 3; ++o) raw[lr][o] = o3[o] + __ldg(net.bo + o);
    for (int c = 0; c < 3; ++c) {
      out_row(m.t[c], r, wo, o3);
      if (lane == 0)
        for (int o = 0; o < 3; ++o) traw[c][lr][o] = o3[o];
    }
  }
  fused_mlp::cp_async_wait<1>();  // g of this tile
  G1::sync();
  // Row e of du/draw and du/dg (the adjoint at the unit cotangent e), a
  // thread each; then K, a thread a row.
  for (int i = G1::tid(); i < 32 * 3; i += G1::kThr) {
    const int lr = i / 3, e = i % 3, r = row0 + lr;
    if (r >= nt) continue;
    float3 rb, gb;
    rodrigues_bwd(make_float3(raw[lr][0], raw[lr][1], raw[lr][2]),
                  make_float3(m.g[r][0], m.g[r][1], m.g[r][2]),
                  make_float3(e == 0 ? 1.f : 0.f, e == 1 ? 1.f : 0.f,
                              e == 2 ? 1.f : 0.f),
                  &rb, &gb);
    for (int c = 0; c < 3; ++c)
      jac[lr][e][c] = (rb.x * traw[c][lr][0] + rb.y * traw[c][lr][1]) +
                      rb.z * traw[c][lr][2];
    jac[lr][e][3] = gb.x;
    jac[lr][e][4] = gb.y;
    jac[lr][e][5] = gb.z;
  }
  G1::sync();
  if (G1::tid() < 32 && row0 + G1::tid() < nt) {
    const int lr = G1::tid();
    const long long idx = a.list[tile * kRows + row0 + lr];
    const int ray = (int)(idx / a.num_samples);
    const int st = (int)(idx % a.num_samples);
    // K[c][k] = Jp[k][c] + sum_j B[j][c] Jg[k][j], B^T read from K.
    float bt[3][3];
    for (int c = 0; c < 3; ++c)
      for (int j = 0; j < 3; ++j) bt[c][j] = *piece(a, st, 3 * c + j, ray);
    for (int c = 0; c < 3; ++c)
      for (int k = 0; k < 3; ++k)
        *piece(a, st, 3 * c + k, ray) =
            jac[lr][k][c] + ((bt[c][0] * jac[lr][k][3] +
                              bt[c][1] * jac[lr][k][4]) +
                             bt[c][2] * jac[lr][k][5]);
  }
  fetch<G1>(a, s, tile + 1, kRows, a.traj, 11, 8, m.g);
  fused_mlp::cp_async_commit();
}

// ------------------------------------------------------------- pass 3

// Two activation buffers hold a 128-row tile's forward (x -> A -> B -> A
// -> B: h0 .. h3) and then its cotangents; each warp keeps its block of
// h0 and h1 in registers for the backward (their masks, and the operands
// of dW1 and dW2 staged back into a free buffer).
struct ParamSmem {
  bf16 w[kWRows * kLdH];
  bf16 x[kRowsP * kLdX];  // x, then each group's raw, then the sines
  bf16 ha[kRowsP * kLdH];
  bf16 hb[kRowsP * kLdH];
  float p[kRowsP][3];
  float g[kRowsP][3];
  float db[kRowsP][3];    // dbar, then rawbar
  float win[kMaxDeg];
  int scan[12];
};

// part[m * kW + n] += A^T Z over the tile's 128 rows for m < m_limit: A
// [128][lda], Z [128][kLdH], the sums in the tensor core over the rows in
// order. WM warps along m (32 rows each) and 8 / WM along n (32 columns
// each), from column n0. The partial's values are loaded before the
// products, so that their latency passes under them, then added and
// stored; each lane moves its two adjacent columns as one aligned pair, so
// a warp's store fills whole 32-byte sectors.
//
// Built with -DK3_TRIAL_NO_PARTIAL (debug/k3_partial_cost.py: a timing
// trial, its gradients wrong), the products run and the partial is
// neither read nor written, bar a store guarded by a value the products
// never give, which keeps the products alive.
#ifdef K3_TRIAL_NO_PARTIAL
constexpr bool kTrialNoPartial = true;
#else
constexpr bool kTrialNoPartial = false;
#endif

template <int WM>
__device__ void grad_chunk(const bf16* a, int lda, const bf16* z,
                           float* part, int m_limit, int n0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = 32 * (warp / (8 / WM));
  const int c0 = n0 + 32 * (warp % (8 / WM));
  float2 old[2][4][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int mm = m0 + 16 * mt + g + 8 * h;
        old[mt][nt][h] =
            mm < m_limit && !kTrialNoPartial
                ? *reinterpret_cast<const float2*>(
                      part + mm * kW + c0 + 8 * nt + 2 * t)
                : make_float2(0.0f, 0.0f);
      }
  // Every load is issued before the products (the compiler would
  // otherwise sink them under the products' registers).
  asm volatile("" ::: "memory");
  Acc<2, 4> c;
  c.zero();
#pragma unroll 4
  for (int k0 = 0; k0 < kRowsP; k0 += 16) {
    unsigned af[2][4], bf[2][4];
    load_at<2>(af, a, lda, m0, k0);
    load_b<false, 2>(bf, z, kLdH, k0, c0);
    mma_step(c, af, bf);
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int mm = m0 + 16 * mt + g + 8 * h;
        if (mm < m_limit) {
          const float2 v =
              make_float2(old[mt][nt][h].x + c.v[mt][nt][2 * h],
                          old[mt][nt][h].y + c.v[mt][nt][2 * h + 1]);
          if (!kTrialNoPartial || __float_as_uint(v.x) == 0x7fbadbadu)
            *reinterpret_cast<float2*>(part + mm * kW + c0 + 8 * nt + 2 * t) =
                v;
        }
      }
}

// dW of a hidden layer over the tile: rows [0, kW) against its hidden
// input a.
__device__ __forceinline__ void hidden_grad(const bf16* a, const bf16* z,
                                            float* part) {
  grad_chunk<4>(a, kLdH, z, part, kW, 0);
  grad_chunk<4>(a, kLdH, z, part, kW, kW / 2);
}

// The cotangent of a hidden layer's input on the group's rows: out =
// bf16(dz W^T) where the layer's input was > 0 (keep, or out's own values
// when keep is null), zero elsewhere; W is read transposed from the
// resident copy at row wrow. All groups meet at a block barrier between
// the products and the stores, since out (or, with keep, the buffer the
// caller stages next) is read by the weight gradients before.
__device__ __forceinline__ void cotangent(const bf16* dz, const bf16* w,
                                          bf16* out,
                                          const unsigned (*keep)[8][2]) {
  Acc<2, 8> c;
  c.zero();
  product<G3, kW, true>(c, dz, kLdH, w, kLdH);
  __syncthreads();
  c.each(G3::row0(), G3::col0(),
         [&](int mt, int nt, int h, int r, int col, float v0, float v1) {
           bool m0, m1;
           positive(keep ? keep[mt][nt][h]
                         : *reinterpret_cast<const unsigned*>(
                               out + r * kLdH + col),
                    m0, m1);
           fused_mlp::store_pair(out + r * kLdH + col, m0 ? v0 : 0.0f,
                                 m1 ? v1 : 0.0f);
         });
}

// Writes this warp's kept block of an activation into buf.
__device__ __forceinline__ void stage(const unsigned (&keep)[2][8][2],
                                      bf16* buf) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<unsigned*>(
            buf + (G3::row0() + 16 * mt + g + 8 * h) * kLdH + G3::col0() +
            8 * nt + 2 * t) = keep[mt][nt][h];
}

// What a block keeps over its tiles in registers, per thread of its group
// (c = G3::tid()): for the columns c and c + 64, dWout[col][o] and each
// layer's bias gradient; dbout[c] for c < 3.
struct Sums {
  float wo[2][3], b[4][2], bo;
};

// bias[j] += the group's rows of dz at the columns c + 64 j.
__device__ __forceinline__ void bias_sums(const bf16* dz, float (&bias)[2]) {
  for (int j = 0; j < 2; ++j) {
    float s = 0.0f;
    for (int lr = 0; lr < 32; ++lr)
      s += fused_mlp::load(dz + (G3::row0() + lr) * kLdH + G3::tid() +
                           64 * j);
    bias[j] += s;
  }
}

__device__ void param_tile(const Args& a, const Net<bf16>& net,
                           ParamSmem& m, const Span& s, int tile,
                           const float (&wo)[4][3], const float (&woc)[2][3],
                           float* part, Sums& sums) {
  const int row0 = G3::row0(), I = net.in_dim, c = G3::tid();
  const int nt = min(kRowsP, s.active - tile * kRowsP);
  const float h = a.step;
  fused_mlp::cp_async_wait<0>();
  __syncthreads();
  encode<G3>(m.p, I, m.win, m.x, nullptr, nullptr);
  G3::sync();
  const bf16* w = m.w;
  unsigned k0[2][8][2], k1[2][8][2];
  layer<G3, kIn, 0, true>(m.x, kLdX, w + kW0 * kLdH, nullptr, 0, nullptr,
                          net.b0, m.ha, false, k0);
  layer<G3, kW, 0, true>(m.ha, kLdH, w + kW1 * kLdH, nullptr, 0, nullptr,
                         net.b1, m.hb, false, k1);
  layer<G3, kW, 0>(m.hb, kLdH, w + kW2 * kLdH, nullptr, 0, nullptr, net.b2,
                   m.ha, false);
  layer<G3, kW, kIn>(m.ha, kLdH, w + kW3 * kLdH, m.x, kLdX, w + kW3x * kLdH,
                     net.b3, m.hb, false);
  // raw, 16 rows a warp, into the group's rows of x (free now); rawbar by
  // the Rodrigues adjoint at h dbar, a thread a row (zero past the tile's
  // rows), as the products' operand, over dbar.
  float(*raw)[3] = reinterpret_cast<float(*)[3]>(m.x + row0 * kLdX);
  const int lane = threadIdx.x & 31;
  for (int i = 0; i < 16; ++i) {
    const int lr = 16 * ((threadIdx.x >> 5) & 1) + i;
    float o3[3];
    out_row(m.hb, row0 + lr, wo, o3);
    if (lane == 0)
      for (int o = 0; o < 3; ++o) raw[lr][o] = o3[o] + __ldg(net.bo + o);
  }
  G3::sync();
  float(*rb)[3] = m.db;
  if (c < 32) {
    const int r = row0 + c;
    float3 rbv = make_float3(0.f, 0.f, 0.f), gb;
    if (r < nt) {
      rodrigues_bwd(make_float3(raw[c][0], raw[c][1], raw[c][2]),
                    make_float3(m.g[r][0], m.g[r][1], m.g[r][2]),
                    make_float3(h * m.db[r][0], h * m.db[r][1],
                                h * m.db[r][2]),
                    &rbv, &gb);
    }
    rb[r][0] = operand<bf16>(rbv.x);
    rb[r][1] = operand<bf16>(rbv.y);
    rb[r][2] = operand<bf16>(rbv.z);
  }
  G3::sync();
  // The sines over raw; then the next tile's p and g are in flight.
  encode<G3>(m.p, I, m.win, nullptr, m.x, nullptr);
  G3::sync();
  fetch<G3>(a, s, tile + 1, kRowsP, a.traj, 11, 0, m.p);
  fetch<G3>(a, s, tile + 1, kRowsP, a.traj, 11, 8, m.g);
  // The output layer's weight and bias gradients over the group's rows,
  // and the cotangent of h3 (masked by it) over h3's buffer: thread c owns
  // columns c and c + 64.
  for (int lr = 0; lr < 32; ++lr) {
    const int r = row0 + lr;
    if (c < 3) sums.bo += rb[r][c];
    for (int j = 0; j < 2; ++j) {
      bf16* q = m.hb + r * kLdH + c + 64 * j;
      const float hv = fused_mlp::load(q);
      for (int o = 0; o < 3; ++o)
        sums.wo[j][o] = __fmaf_rn(hv, rb[r][o], sums.wo[j][o]);
      float v = 0.0f;
      for (int o = 0; o < 3; ++o) v = __fmaf_rn(rb[r][o], woc[j][o], v);
      const bf16 dz = __float2bfloat16_rn(hv > 0.0f ? v : 0.0f);
      *q = dz;
      sums.b[3][j] += __bfloat162float(dz);
    }
  }
  G3::sync();
  fetch<G3>(a, s, tile + 1, kRowsP, a.dbar, 3, 0, m.db);
  fused_mlp::cp_async_commit();
  // Offsets of the forward pack in the partial.
  float* pw0 = part;
  float* pw1 = pw0 + I * kW + kW;
  float* pw2 = pw1 + kW * kW + kW;
  float* pw3 = pw2 + kW * kW + kW;
  // Layer 3: dW over [h2 | sines] (A, x), the cotangent of h2 over A.
  __syncthreads();
  hidden_grad(m.ha, m.hb, pw3);
  grad_chunk<2>(m.x, kLdX, m.hb, pw3 + kW * kW, I, 0);
  cotangent(m.hb, w + kW3 * kLdH, m.ha, nullptr);
  stage(k1, m.hb);
  G3::sync();
  bias_sums(m.ha, sums.b[2]);
  // Layer 2: dW over h1 (staged in B), the cotangent of h1 over B.
  __syncthreads();
  hidden_grad(m.hb, m.ha, pw2);
  cotangent(m.ha, w + kW2 * kLdH, m.hb, k1);
  stage(k0, m.ha);
  G3::sync();
  bias_sums(m.hb, sums.b[1]);
  // Layer 1: dW over h0 (staged in A), the cotangent of h0 over A.
  __syncthreads();
  hidden_grad(m.ha, m.hb, pw1);
  cotangent(m.hb, w + kW1 * kLdH, m.ha, k0);
  G3::sync();
  bias_sums(m.ha, sums.b[0]);
  // Layer 0: dW over the sines.
  __syncthreads();
  grad_chunk<2>(m.x, kLdX, m.ha, pw0, I, 0);
}

// P3's buffers: the weights of hidden layers 1-3 only.
struct PreactSmem {
  bf16 w[kW3 * kLdH];
  bf16 x[kRows * kLdX];
  bf16 h[kRows * kLdH];
  float p[kRows][3];
  float win[kMaxDeg];
};

}  // namespace bfa

template <>
__global__ void __launch_bounds__(kThreads, 1)
    k3_jacobians<Bf16Arm>(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bfa::JacSmem& m = *reinterpret_cast<bfa::JacSmem*>(smem_raw);
  const Net<bf16> net = args_net<bf16>(a);
  bfa::load_weights(m.w, net, bfa::kWRows);
  if (threadIdx.x < a.max_deg) m.win[threadIdx.x] = a.window[threadIdx.x];
  const bfa::Span s = bfa::tile_span(a, m.scan, bfa::kRows, true);
  bfa::compact(a, s, m.scan, bfa::kRows);
  fused_mlp::cp_async_wait<0>();
  __syncthreads();
  const int lane = threadIdx.x & 31;
  float wo[4][3];
  for (int kk = 0; kk < 4; ++kk)
    for (int o = 0; o < 3; ++o)
      wo[kk][o] = __ldg(net.wot + 3 * (4 * lane + kk) + o);
  bfa::fetch<bfa::G1>(a, s, s.tile0, bfa::kRows, a.traj, 11, 0, m.p);
  fused_mlp::cp_async_commit();
  bfa::fetch<bfa::G1>(a, s, s.tile0, bfa::kRows, a.traj, 11, 8, m.g);
  fused_mlp::cp_async_commit();
  for (int tile = s.tile0; tile < s.tile1; ++tile)
    bfa::jacobian_tile(a, net, m, s, tile, wo);
  fused_mlp::cp_async_wait<0>();
}

template <>
__global__ void __launch_bounds__(kThreads, 1)
    k3_params<Bf16Arm>(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bfa::ParamSmem& m = *reinterpret_cast<bfa::ParamSmem*>(smem_raw);
  const int I = 6 * a.max_deg, P = num_params(I);
  const Net<bf16> net = args_net<bf16>(a);
  float* part = a.partial + (long long)blockIdx.x * a.stride;
  bfa::load_weights(m.w, net, bfa::kWRows);
  for (int e = threadIdx.x; e < P; e += kThreads) part[e] = 0.0f;
  if (threadIdx.x < a.max_deg) m.win[threadIdx.x] = a.window[threadIdx.x];
  // 1b wrote the compacted list; this pass cuts it into tiles of 128.
  const bfa::Span s = bfa::tile_span(a, m.scan, bfa::kRowsP, false);
  const int lane = threadIdx.x & 31, c = bfa::G3::tid();
  float wo[4][3], woc[2][3];
  for (int kk = 0; kk < 4; ++kk)
    for (int o = 0; o < 3; ++o)
      wo[kk][o] = __ldg(net.wot + 3 * (4 * lane + kk) + o);
  for (int j = 0; j < 2; ++j)
    for (int o = 0; o < 3; ++o)
      woc[j][o] = __ldg(net.wot + 3 * (c + 64 * j) + o);
  bfa::Sums sums = {};
  // Tile tile0's p, g and dbar as one group (after the weights' group).
  bfa::fetch<bfa::G3>(a, s, s.tile0, bfa::kRowsP, a.traj, 11, 0, m.p);
  bfa::fetch<bfa::G3>(a, s, s.tile0, bfa::kRowsP, a.traj, 11, 8, m.g);
  bfa::fetch<bfa::G3>(a, s, s.tile0, bfa::kRowsP, a.dbar, 3, 0, m.db);
  fused_mlp::cp_async_commit();
  for (int tile = s.tile0; tile < s.tile1; ++tile)
    bfa::param_tile(a, net, m, s, tile, wo, woc, part, sums);
  fused_mlp::cp_async_wait<0>();
  __syncthreads();
  // The four groups' sums, in group order, written once a block.
  float* x = reinterpret_cast<float*>(m.ha);
  constexpr int kN = 2 * 3 + 4 * 2 + 1;
  const float* v = &sums.wo[0][0];
  const int grp = bfa::G3::group();
  if (grp > 0)
    for (int q = 0; q < kN; ++q) x[(grp * 64 + c) * kN + q] = v[q];
  __syncthreads();
  if (grp == 0) {
    float t[kN];
    for (int q = 0; q < kN; ++q) t[q] = v[q];
    for (int gi = 1; gi < 4; ++gi)
      for (int q = 0; q < kN; ++q) t[q] += x[(gi * 64 + c) * kN + q];
    float* pb0 = part + I * kW;
    float* pb1 = pb0 + kW + kW * kW;
    float* pb2 = pb1 + kW + kW * kW;
    float* pb3 = pb2 + kW + (kW + I) * kW;
    float* pwo = pb3 + kW;
    float* pbo = pwo + kW * 3;
    float* const pbs[4] = {pb0, pb1, pb2, pb3};
    for (int j = 0; j < 2; ++j) {
      for (int o = 0; o < 3; ++o) pwo[3 * (c + 64 * j) + o] = t[3 * j + o];
      for (int l = 0; l < 4; ++l) pbs[l][c + 64 * j] = t[6 + 2 * l + j];
    }
    if (c < 3) pbo[c] = t[kN - 1];
  }
}

template <>
__global__ void __launch_bounds__(kThreads, 1)
    so3_preacts_kernel<Bf16Arm>(const float* pts, const float* wfwd,
                                const void* wfwd_t, const float* window,
                                float* pre, int n, int max_deg, int width) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bfa::PreactSmem& m = *reinterpret_cast<bfa::PreactSmem*>(smem_raw);
  using bfa::G1;
  const int I = 6 * max_deg;
  const bf16* fwd_t = static_cast<const bf16*>(wfwd_t);
  const Net<bf16> net = make_net(wfwd, fwd_t, fwd_t, I);
  bfa::load_weights(m.w, net, bfa::kW3);
  if (threadIdx.x < max_deg) m.win[threadIdx.x] = window[threadIdx.x];
  const int tiles = (n + bfa::kRows - 1) / bfa::kRows;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = (long long)tile * bfa::kRows;
    const int rows = n - row0 < bfa::kRows ? (int)(n - row0) : bfa::kRows;
    __syncthreads();
    for (int i = threadIdx.x; i < bfa::kRows * 3; i += kThreads) {
      const int r = i / 3, c = i % 3;
      m.p[r][c] = r < rows ? pts[3 * (row0 + r) + c] : 0.0f;
    }
    fused_mlp::cp_async_wait<0>();
    __syncthreads();
    bfa::encode<G1>(m.p, I, m.win, m.x, nullptr, nullptr);
    G1::sync();
    float* const out = pre + row0 * width;
    const long long plane = (long long)n * width;
    bfa::layer<G1, kIn, 0>(m.x, bfa::kLdX, m.w + bfa::kW0 * bfa::kLdH,
                           nullptr, 0, nullptr, net.b0, m.h, false, nullptr,
                           out, rows, width);
    bfa::layer<G1, kW, 0>(m.h, bfa::kLdH, m.w + bfa::kW1 * bfa::kLdH,
                          nullptr, 0, nullptr, net.b1, m.h, true, nullptr,
                          out + plane, rows, width);
    bfa::layer<G1, kW, 0>(m.h, bfa::kLdH, m.w + bfa::kW2 * bfa::kLdH,
                          nullptr, 0, nullptr, net.b2, m.h, true, nullptr,
                          out + 2 * plane, rows, width);
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The shared memory of passes 1b and 3 in arm A.
template <typename A>
struct SmemOf {
  using Jac = JacSmem<A>;
  using Param = ParamSmem<A>;
};
template <>
struct SmemOf<Bf16Arm> {
  using Jac = bfa::JacSmem;
  using Param = bfa::ParamSmem;
};

// The five launches in arm A.
template <typename A>
cudaError_t launch_k3(const Args& a, int num_blocks, float* grads,
                      cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<typename A::T, bf16>::value;
  using Jac = typename SmemOf<A>::Jac;
  using Param = typename SmemOf<A>::Param;
  const long long total = (long long)a.batch * a.num_samples;
  k3_pieces<kBf16><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = set_smem(k3_jacobians<A>, sizeof(Jac));
  if (err != cudaSuccess) return err;
  k3_jacobians<A><<<num_blocks, kThreads, sizeof(Jac), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  k3_sweep<<<a.bp / 32, 32, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = set_smem(k3_params<A>, sizeof(Param));
  if (err != cudaSuccess) return err;
  k3_params<A><<<num_blocks, kThreads, sizeof(Param), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int P = num_params(6 * a.max_deg);
  k3_reduce<<<(P + 255) / 256, 256, 0, stream>>>(a.partial, num_blocks, P,
                                                  a.stride, grads);
  return cudaGetLastError();
}

template <typename A>
cudaError_t launch_preacts(const float* pts, const float* wfwd,
                           const void* wfwd_t, const float* window,
                           float* pre, int n, int max_deg, int width,
                           cudaStream_t stream) {
  constexpr int R = kTileOf<A>;
  const cudaError_t err = set_smem(so3_preacts_kernel<A>,
                                   sizeof(PreactSmem<A>));
  if (err != cudaSuccess) return err;
  so3_preacts_kernel<A><<<(n + R - 1) / R, kThreads, sizeof(PreactSmem<A>),
                          stream>>>(pts, wfwd, wfwd_t, window, pre, n,
                                    max_deg, width);
  return cudaGetLastError();
}

// P3 in the bf16 arm: two persistent blocks an SM over tiles of 64 points.
template <>
cudaError_t launch_preacts<Bf16Arm>(const float* pts, const float* wfwd,
                                    const void* wfwd_t, const float* window,
                                    float* pre, int n, int max_deg,
                                    int width, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = set_smem(so3_preacts_kernel<Bf16Arm>, sizeof(bfa::PreactSmem));
  if (err != cudaSuccess) return err;
  const int tiles = (n + bfa::kRows - 1) / bfa::kRows;
  const int grid = tiles < 2 * sms ? tiles : 2 * sms;
  so3_preacts_kernel<Bf16Arm><<<grid, kThreads, sizeof(bfa::PreactSmem),
                                stream>>>(pts, wfwd, wfwd_t, window, pre, n,
                                          max_deg, width);
  return cudaGetLastError();
}

}  // namespace

// traj, cts: [B, S, 11] (cts with segbar in channel 6); wfwd: the padded
// fp32 forward pack; wfwd_t, wbwd_t: the arm's forward and backward packs
// (see Net: fp32, or bf16 of the weights rounded by the caller); window:
// [max_deg]; pieces: [S, 22, bp] scratch (bp = B rounded up to 32); dbar:
// [B, S, 3] scratch; raybar: [B, 6]; partial: [num_blocks,
// partial_stride(P, bf16)]; grads: [P], P the padded forward pack's size;
// index (bf16 arm): [ceil(B S / 256) + B S] int32 scratch; bf16: 0 for the
// fp32 arm, 1 for the bf16 one. Returns a cudaError_t.
extern "C" int march_bwd_launch(
    const float* traj, const float* cts, const float* grid,
    const float* wfwd, const void* wfwd_t, const void* wbwd_t,
    const float* window, float* pieces, float* dbar, float* raybar,
    float* partial, float* grads, int* index, int batch, int num_samples,
    int max_deg,
    int num_blocks, int bf16, int nx, int ny, int nz, float step,
    float nmin_x, float nmin_y, float nmin_z, float nd_x, float nd_y,
    float nd_z, void* stream_ptr) {
  if (6 * max_deg > kIn - 4 || max_deg < 1 || max_deg > kMaxDeg ||
      batch < 1 || num_samples < 1 || num_blocks < 1 ||
      (bf16 != 0 && bf16 != 1) || (bf16 == 1 && index == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Args a;
  a.traj = traj;
  a.cts = cts;
  a.wfwd = wfwd;
  a.wfwd_t = wfwd_t;
  a.wbwd_t = wbwd_t;
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
  a.stride = partial_stride(num_params(6 * max_deg), bf16 == 1);
  a.counts = index;
  a.list = index ? index + (total + bfa::kRange - 1) / bfa::kRange : nullptr;
  return static_cast<int>(
      bf16 ? launch_k3<Bf16Arm>(a, num_blocks, grads, stream)
           : launch_k3<F32Arm>(a, num_blocks, grads, stream));
}

// Parameters of the padded forward pack for 6 * max_deg inputs.
extern "C" int march_bwd_num_params(int max_deg) {
  return num_params(6 * max_deg);
}

// pts: [n, 3]; wfwd, wfwd_t: as march_bwd_launch's; pre: [3, n, width].
extern "C" int so3_preacts_launch(const float* pts, const float* wfwd,
                                  const void* wfwd_t, const float* window,
                                  float* pre, int n, int max_deg, int width,
                                  int bf16, void* stream_ptr) {
  if (n < 0 || width < 1 || width > kW || max_deg < 1 ||
      max_deg > kMaxDeg || (bf16 != 0 && bf16 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return static_cast<int>(
      bf16 ? launch_preacts<Bf16Arm>(pts, wfwd, wfwd_t, window, pre, n,
                                     max_deg, width, stream)
           : launch_preacts<F32Arm>(pts, wfwd, wfwd_t, window, pre, n,
                                    max_deg, width, stream));
}
