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
// Design: one block of 256 threads per row tile (128 rows in bf16, 64 in
// fp32). The tile's activations live in shared memory, two buffers that
// alternate between a layer's input and output; nothing between layers
// goes to device memory. Each layer's weights stream from L2 in k-slabs
// through a three-stage cp.async ring, so one fetch feeds all 8 warps and
// the next slabs are in flight while one is multiplied (mlp_common.cuh's
// engines): bf16 products on tensor cores (mma.sync m16n8k16 from
// ldmatrix, fp32 accumulators), fp32 products on CUDA cores in 8 x 8
// register tiles. The sigma and rgb heads (1 and 3 columns) are fp32 dot
// products a thread.
//
// What bounds it on the card: operations. One row is 593,408
// multiply-adds at the ship widths, so the render's fine call (1,572,864
// rows) is 1.87 TFLOP, 27.9 ms at the 67 TFLOP/s fp32 peak, against 25 MB
// of inputs and outputs; the bf16 train call (196,608 rows) 0.24 ms at the
// 989 TFLOP/s bf16 tensor-core peak. Weight traffic from L2 is what a tile
// pays besides: 2.37 MB (fp32) a 64-row tile, 1.19 MB (bf16) a 128-row one.

#include "mlp_common.cuh"

namespace {

using fused_mlp::kThreads;
using fused_mlp::Spec;

// bf16 on tensor cores, fp32 on CUDA cores.
template <typename T>
using Fwd = fused_mlp::Policy<T, std::is_same<T, __nv_bfloat16>::value>;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    mlp_fwd_kernel(Spec s, const float* x, const float* c, const T* wkn,
                   const float* bias, float* out, long long n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const fused_mlp::TileBufs<T> t = fused_mlp::tile_bufs<Fwd<T>>(s, smem);
  const long long row0 = static_cast<long long>(blockIdx.x) * Fwd<T>::kRows;
  fused_mlp::load_tile<Fwd<T>>(s, x, c, row0, n, t);
  __syncthreads();
  fused_mlp::forward_tile<Fwd<T>>(s, wkn, bias, t, out, row0, n,
                                  [](int, const T*, int) {});
}

template <typename T>
int launch(const Spec& s, const float* x, const float* c, const void* wkn,
           const float* bias, float* out, long long n, cudaStream_t stream) {
  const size_t smem = fused_mlp::tile_bytes<Fwd<T>>(s);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n + Fwd<T>::kRows - 1) / Fwd<T>::kRows;
  mlp_fwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem,
                      stream>>>(s, x, c, static_cast<const T*>(wkn), bias,
                                out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [n, feat] features, or [n, 3] raw points with pe; c: [n, cond]
// condition, or [n, 3] raw view directions with pe; wkn: the input-major
// weight pack in the compute type; bias: the fp32 bias pack; out:
// [n, num_rgb + num_sigma]. Returns a cudaError_t.
extern "C" int mlp_fwd_launch(const float* x, const float* c, const void* wkn,
                              const float* bias, float* out, long long n,
                              int bf16, int depth, int width, int skip,
                              int feat, int cond, int cond_width, int num_rgb,
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
