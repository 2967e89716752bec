// What the forward marches K1 (march_lean.cu) and K2 (march_so3.cu) share:
// the grid, ops/grid.trilinear spread over the 8 lanes of a ray, and the
// Euler update of ops/eikonal.march.
//
// A ray's state (p, d, t) is held by 8 neighbouring lanes of a warp (an
// aligned group of 8), each with the same values. Lane c of the group
// fetches trilinear corner c (x = bit 0, y = bit 1, z = bit 2; corner8),
// so the 8 gathers of a step are 8 loads in flight at once, one per lane,
// and the group combines them with shuffles (combine8): along x, then y, then z, each level
// the same lerp4(lower, upper, t) that the one-thread trilinear calls, so
// every lane ends with that trilinear's value bit for bit. Every lane then
// runs the same update on the same values, and the state stays identical
// across the group without a broadcast. Each call below is made by all 32
// lanes of the warp together (the shuffles name the whole warp).
//
// The build turns off FMA contraction (-fmad=false, ops/cuda_build.py) and
// keeps IEEE division and square root, so each product and sum rounds as
// in the plain PyTorch version and as in the kernels' one-thread-a-ray
// predecessors.

#pragma once

#include <cuda_runtime.h>

namespace march {

constexpr int kLanes = 8;  // lanes a ray: one a trilinear corner

struct Grid {
  const float4* data;  // [nx*ny*nz] of (n, gx, gy, gz), x-major
  int nx, ny, nz;
  float nmin_x, nmin_y, nmin_z;
  float nd_x, nd_y, nd_z;
  float inv_x, inv_y, inv_z;  // 1 / nd, for guess8 only
};

__device__ __forceinline__ float4 lerp4(float4 a, float4 b, float t) {
  const float u = 1.0f - t;
  return make_float4(a.x * u + b.x * t, a.y * u + b.y * t,
                     a.z * u + b.z * t, a.w * u + b.w * t);
}

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// One level of the corner tree: the lane whose `bit` is clear holds the
// lower corner, its partner (lane ^ bit) the upper one; both compute
// lerp4(lower, upper, t).
__device__ __forceinline__ float4 combine(float4 v, float t, int bit,
                                          bool upper) {
  float4 o;
  o.x = __shfl_xor_sync(0xffffffffu, v.x, bit);
  o.y = __shfl_xor_sync(0xffffffffu, v.y, bit);
  o.z = __shfl_xor_sync(0xffffffffu, v.z, bit);
  o.w = __shfl_xor_sync(0xffffffffu, v.w, bit);
  return upper ? lerp4(o, v, t) : lerp4(v, o, t);
}

// Corner `corner` of the cell that holds p: its address in the grid and
// the cell's fractions (ops/grid.trilinear: clamped corner indices,
// unclamped fractions).
struct Corner {
  const float4* addr;
  float xd, yd, zd;
};

__device__ __forceinline__ Corner corner8(const Grid& g, float px, float py,
                                          float pz, int corner) {
  const float cx = (px - g.nmin_x) / g.nd_x;
  const float cy = (py - g.nmin_y) / g.nd_y;
  const float cz = (pz - g.nmin_z) / g.nd_z;
  const float fx0 = floorf(cx), fy0 = floorf(cy), fz0 = floorf(cz);
  const long long xi = clampi((int)fx0 + (corner & 1), g.nx - 1);
  const long long yi = clampi((int)fy0 + ((corner >> 1) & 1), g.ny - 1);
  const long long zi = clampi((int)fz0 + (corner >> 2), g.nz - 1);
  const long long sy = g.nz, sx = (long long)g.ny * g.nz;
  return {g.data + sx * xi + sy * yi + zi, cx - fx0, cy - fy0, cz - fz0};
}

// The trilinear value from this lane's corner value v: along x, then y,
// then z, every lane of the group ending with the same value.
__device__ __forceinline__ float4 combine8(float4 v, const Corner& c,
                                           int corner) {
  v = combine(v, c.xd, 1, corner & 1);
  v = combine(v, c.yd, 2, (corner >> 1) & 1);
  return combine(v, c.zd, 4, corner >> 2);
}

// A 16-byte load through the read-only path, issued where it stands (not
// moved to its use).
__device__ __forceinline__ float4 load_now(const float4* p) {
  float4 v;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

// The value at p where `need`, else v: the load is issued only where it is
// needed, so a step whose corner was loaded ahead does not wait on memory.
__device__ __forceinline__ float4 load_if(bool need, const float4* p,
                                          float4 v) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %4, 0;\n"
      " @q ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%5];\n}\n"
      : "+f"(v.x), "+f"(v.y), "+f"(v.z), "+f"(v.w)
      : "r"((int)need), "l"(p));
  return v;
}

// A guess of corner `corner`'s address for a point near p, with the
// reciprocal cell size: it only chooses what to load early. Whatever it
// loads is used only where the exact address (corner8) equals it, so the
// values the march uses are the grid's own, bit for bit.
__device__ __forceinline__ const float4* guess8(const Grid& g, float px,
                                                float py, float pz,
                                                int corner) {
  const long long xi = clampi(
      (int)floorf((px - g.nmin_x) * g.inv_x) + (corner & 1), g.nx - 1);
  const long long yi = clampi(
      (int)floorf((py - g.nmin_y) * g.inv_y) + ((corner >> 1) & 1),
      g.ny - 1);
  const long long zi = clampi(
      (int)floorf((pz - g.nmin_z) * g.inv_z) + (corner >> 2), g.nz - 1);
  return g.data + (long long)g.ny * g.nz * xi + g.nz * yi + zi;
}

// The Euler update in two halves: the new position, which needs only n
// and the old direction, and then the direction and the arclength.
// p' = p + (h / n) d;  d' = d + h u;  t' = t + |p - p'|.
__device__ __forceinline__ void next_position(float h, float n, float px,
                                              float py, float pz, float dx,
                                              float dy, float dz, float& qx,
                                              float& qy, float& qz) {
  const float hn = h / n;
  qx = px + hn * dx;
  qy = py + hn * dy;
  qz = pz + hn * dz;
}

__device__ __forceinline__ void finish_step(float h, float ux, float uy,
                                            float uz, float qx, float qy,
                                            float qz, float& px, float& py,
                                            float& pz, float& dx, float& dy,
                                            float& dz, float& t) {
  dx = dx + h * ux;
  dy = dy + h * uy;
  dz = dz + h * uz;
  const float ex = px - qx, ey = py - qy, ez = pz - qz;
  t = t + sqrtf(ex * ex + ey * ey + ez * ez);
  px = qx;
  py = qy;
  pz = qz;
}

}  // namespace march
