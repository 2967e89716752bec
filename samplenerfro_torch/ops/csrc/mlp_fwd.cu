// K4: the fused NerfMLP forward, hand-written for Hopper (sm_90a).
//
// Replaces samplenerfro_tpu/ops/pallas/mlp_kernel.py:_fwd_kernel (line
// 219), reached there through fused_nerf_mlp with --mlp_kernel=pallas or
// pallas_pe: the radiance MLPs of eval (fp32) and of radiance training
// (the configured mlp_dtype, bf16 in the ship config).
//
// What it computes, per row: the 8x256 ReLU trunk with the input skip
// concat, the sigma head, the bottleneck, the condition layer on
// [bottleneck, view encoding] and the rgb head, at the rounding points of
// the TPU kernel's _forward_tile (see mlp_common.cuh); output [n, 4]
// (raw rgb, sigma) in fp32. With pe, the inputs are raw [n, 3] points and
// view directions, encoded in the kernel (pe_col), so the [n, 63] and
// [n, 27] features never touch device memory.
//
// Design: one block of 256 threads per 64-row tile. The tile's activations
// live in shared memory, two [64, 256] buffers that alternate between a
// layer's input and output; nothing between layers goes to device memory.
// The weights (2.4 MB fp32, 1.2 MB bf16) are read from device memory by
// every block and stay in the 50 MB L2. Every product runs on CUDA cores:
// each warp holds an 8 x 256 tile of outputs in registers (64 fp32 sums a
// thread), reads the activations as shared-memory broadcasts and the
// weights as coalesced rows, the loads of the 8 warps overlapping one
// another (staging 64 weight rows at a time in shared memory, the whole
// block waiting for each copy, ran 1.5x slower). The same code serves
// fp32 and bf16, so the bf16 sums are those of the plain
// version in another order; tensor cores (mma/wgmma on bf16) are left to
// the redesign.
//
// What bounds it on the card: operations. One row is 593,408
// multiply-adds at the ship widths, so the render's fine call (1,572,864
// rows) is 1.87 TFLOP, 27.9 ms at the 67 TFLOP/s fp32 peak, against 25 MB
// of inputs and outputs; the bf16 train call (196,608 rows) would be
// 0.24 ms on bf16 tensor cores, which this version does not use.

#include "mlp_common.cuh"

namespace {

using fused_mlp::kRows;
using fused_mlp::kThreads;
using fused_mlp::Spec;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    mlp_fwd_kernel(Spec s, const float* x, const float* c, const T* wkn,
                   const float* bias, float* out, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int maxw = s.width > s.cond_width ? s.width : s.cond_width;
  T* buf0 = reinterpret_cast<T*>(smem);
  T* buf1 = buf0 + kRows * maxw;
  T* x0s = buf1 + kRows * maxw;
  T* conds = x0s + kRows * s.feat;
  const int row0 = blockIdx.x * kRows;
  fused_mlp::load_tile(s, x, c, row0, n, x0s, conds);
  __syncthreads();
  fused_mlp::forward_tile<T>(s, wkn, bias, x0s, conds, buf0, buf1, nullptr,
                             out, row0, n);
}

template <typename T>
int launch(const Spec& s, const float* x, const float* c, const void* wkn,
           const float* bias, float* out, int n, cudaStream_t stream) {
  const int maxw = s.width > s.cond_width ? s.width : s.cond_width;
  const size_t smem =
      sizeof(T) * (2 * kRows * maxw + kRows * (s.feat + s.cond));
  cudaError_t err = cudaFuncSetAttribute(
      mlp_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kRows - 1) / kRows;
  mlp_fwd_kernel<T><<<blocks, kThreads, smem, stream>>>(
      s, x, c, static_cast<const T*>(wkn), bias, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [n, feat] features, or [n, 3] raw points with pe; c: [n, cond]
// condition, or [n, 3] raw view directions with pe; wkn: the input-major
// weight pack in the compute type; bias: the fp32 bias pack; out:
// [n, num_rgb + num_sigma]. Returns a cudaError_t.
extern "C" int mlp_fwd_launch(const float* x, const float* c, const void* wkn,
                              const float* bias, float* out, int n, int bf16,
                              int depth, int width, int skip, int feat,
                              int cond, int cond_width, int num_rgb,
                              int num_sigma, int pe, long long num_weights,
                              void* stream) {
  Spec s;
  if (!fused_mlp::make_spec(&s, depth, width, skip, feat, cond, cond_width,
                            num_rgb, num_sigma, pe) ||
      s.num_weights != num_weights)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(s, x, c, wkn, bias, out, n, st)
              : launch<float>(s, x, c, wkn, bias, out, n, st);
}
