// The Hopper instructions K4 and K5 (mlp_fwd.cu, mlp_bwd.cu) are built
// from, each behind one inline function: asynchronous 16-byte copies from
// device to shared memory (cp.async, with zero fill), ldmatrix (plain and
// transposed) and the bf16 tensor-core product mma.sync m16n8k16 with fp32
// accumulators.

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

}  // namespace fused_mlp
