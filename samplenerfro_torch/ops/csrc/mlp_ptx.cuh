// The Hopper instructions K4 and K5 (mlp_fwd.cu, mlp_bwd.cu) are built
// from, each behind one inline function: asynchronous 16-byte copies from
// device to shared memory (cp.async, with zero fill), ldmatrix (plain and
// transposed), the bf16 tensor-core product mma.sync m16n8k16 with fp32
// accumulators, and the sm_90a pieces of the warpgroup engine: mbarriers,
// bulk copies by the copy engine (TMA) and wgmma m64n128k16.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fused_mlp {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to dst (shared), asynchronously; src_bytes 0 writes
// zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lane 8i + j gives row j of matrix i. Lane l gets,
// in r[i], the pair (row l / 4, columns 2 (l % 4), 2 (l % 4) + 1) of
// matrix i.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// As ldsm_x4, transposed: lane l gets (rows 2 (l % 4), 2 (l % 4) + 1,
// column l / 4) of matrix i.
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += A (16x16 bf16, row-major fragment a) x B (16x8 bf16, fragment
// b0, b1), in fp32. With g = lane / 4, t = lane % 4: a holds A(g, 2t..),
// A(g + 8, 2t..), A(g, 2t + 8..), A(g + 8, 2t + 8..); b0 B(2t.., g), b1
// B(2t + 8.., g); d holds D(g, 2t), D(g, 2t + 1), D(g + 8, 2t),
// D(g + 8, 2t + 1).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------ Hopper: TMA and wgmma

// An mbarrier: init (one thread), then fence_mbar_init before any other
// thread uses it.
__device__ __forceinline__ void mbar_init(void* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(void* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One arrival that also expects `bytes` of asynchronous copies.
__device__ __forceinline__ void mbar_expect_tx(void* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(void* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred done;\n"
      "WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16) from src (device, 16-byte aligned) to dst
// (shared, 16-byte aligned) by the copy engine; completes on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, void* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The descriptor of a K-major bf16 operand in shared memory in the 128-byte
// swizzle: rows of 64 k (128 bytes) whose 16-byte chunks are stored at
// chunk ^ (row % 8), 8-row groups 1024 bytes apart, the whole 1024-byte
// aligned; p points at the first row, advanced by 32 bytes a k16 step.
__device__ __forceinline__ unsigned long long desc_sw128(const void* p) {
  const unsigned long long a = smem_addr(p);
  return ((a & 0x3FFFFull) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// The descriptor of an MN-major bf16 operand in the 128-byte swizzle:
// atoms of 8 k-rows of 64 MN values (128 bytes; chunk c of k-row j stored
// at c ^ j), 8-k groups `kstep` bytes apart, 64-MN blocks `mnstep` apart,
// the whole 1024-byte aligned.
__device__ __forceinline__ unsigned long long desc_mn_sw128(const void* p,
                                                            unsigned mnstep,
                                                            unsigned kstep) {
  const unsigned long long a = smem_addr(p);
  return ((a & 0x3FFFFull) >> 4) |
         (static_cast<unsigned long long>(mnstep >> 4) << 16) |
         (static_cast<unsigned long long>(kstep >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of d across a wgmma fence or
// wait.
template <int R>
__device__ __forceinline__ void wg_pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A B on the tensor cores, one k16 step for the warpgroup's 64 rows
// and 128 columns: A from registers (each warp its 16 rows, the fragment
// of mma_bf16's a), B in shared memory, K-major (desc_sw128) or, with
// kTransB, MN-major (desc_mn_sw128). d holds, for n8 tile i, D(g, 8i +
// 2t), D(g, 8i + 2t + 1), D(g + 8, 8i + 2t), D(g + 8, 8i + 2t + 1) of the
// warp's rows, g = lane / 4, t = lane % 4.
// The fp32 sum stays in d over the whole k.
template <int kTransB = 0>
__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                           const unsigned (&a)[4],
                                           unsigned long long desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1),
        "n"(kTransB));
}

}  // namespace fused_mlp
