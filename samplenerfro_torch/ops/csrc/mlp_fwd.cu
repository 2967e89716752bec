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
// Design: one block of 256 threads per row tile (64 rows; 16 when the
// layers are wider than 256 or the inputs more than 128 columns, so that
// the tile's activations fit in shared memory). The tile's activations
// live in shared memory, two buffers that alternate between a layer's
// input and output; nothing between layers goes to device memory. Each
// layer's weights stream from L2 in k-slabs through a three-stage cp.async
// ring, so one fetch feeds all 8 warps and the next slabs are in flight
// while one is multiplied (mlp_common.cuh's engines), in column panels of
// at most 256. Every product, bf16 too, runs on CUDA cores in fp32 in
// k order, the arithmetic with which K5 recomputes the forward: the
// weight gradients of a training step then belong to the activations
// that made its loss, as the TPU kernels' shared _forward_tile makes
// them (bf16 on tensor cores summed in another order and rounded ~3e-5
// of the activations to the other bf16 neighbour; the trial switch
// FUSED_MLP_K4_TENSOR_FORWARD=1 restores that design for
// debug/mlp_rounding.py). The sigma and rgb heads (1 and 3 columns) are
// fp32 dot products a thread.
//
// What bounds it on the card: operations. One row is 593,408
// multiply-adds at the ship widths, so the render's fine call (1,572,864
// rows) is 1.87 TFLOP, 27.9 ms at the 67 TFLOP/s fp32 peak, against 25 MB
// of inputs and outputs; the bf16 train call (196,608 rows) 0.24 ms at the
// 989 TFLOP/s bf16 tensor-core peak, which this design leaves unused.
// Weight traffic from L2 is what a tile pays besides: 2.37 MB (fp32), 1.19
// MB (bf16) a 64-row tile.
//
// With acts, the kernel also writes every stored activation of each row
// (the trunk's, the bottleneck's and the condition layer's, in K5's
// scratch order, mlp_kernel.forward_activations) to acts, so that K5's
// recompute can be compared with it.

#include "mlp_common.cuh"

namespace {

using fused_mlp::kThreads;
using fused_mlp::Spec;

// Trial switch for debug/mlp_rounding.py, 0 in use: 1 runs the bf16
// forward on tensor cores (the first redesign's K4).
#ifndef FUSED_MLP_K4_TENSOR_FORWARD
#define FUSED_MLP_K4_TENSOR_FORWARD 0
#endif
template <typename T, bool kWide>
using Fwd = fused_mlp::Policy<
    T, std::is_same<T, __nv_bfloat16>::value && FUSED_MLP_K4_TENSOR_FORWARD,
    std::is_same<T, __nv_bfloat16>::value && FUSED_MLP_K4_TENSOR_FORWARD,
    kWide>;

template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads)
    mlp_fwd_kernel(Spec s, const float* x, const float* c, const T* wkn,
                   const float* bias, float* out, T* acts, long long n) {
  using P = Fwd<T, kWide>;
  extern __shared__ __align__(16) unsigned char smem[];
  const fused_mlp::TileBufs<T> t = fused_mlp::tile_bufs<P>(s, smem);
  const long long row0 = static_cast<long long>(blockIdx.x) * P::kRows;
  fused_mlp::load_tile<P>(s, x, c, row0, n, t);
  __syncthreads();
  // acts: per row, the trunk's activations, the bottleneck's, the
  // condition layer's (depth * width + width + cond_width values).
  const long long per_row =
      static_cast<long long>(s.depth + 1) * s.width + s.cond_width;
  fused_mlp::forward_tile<P>(
      s, wkn, bias, t, out, row0, n, [&](int id, const T* buf, int width) {
        if (!acts) return;
        const long long col = static_cast<long long>(id) * s.width;
        for (int e = threadIdx.x; e < P::kRows * width; e += kThreads) {
          const int r = e / width, j = e % width;
          if (row0 + r < n)
            acts[(row0 + r) * per_row + col + j] = buf[r * t.ld_act + j];
        }
      });
}

template <typename T, bool kWide>
int launch(const Spec& s, const float* x, const float* c, const void* wkn,
           const float* bias, float* out, void* acts, long long n,
           cudaStream_t stream) {
  using P = Fwd<T, kWide>;
  const size_t smem = fused_mlp::tile_bytes<P>(s);
  if (smem > fused_mlp::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_fwd_kernel<T, kWide>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n + P::kRows - 1) / P::kRows;
  mlp_fwd_kernel<T, kWide><<<static_cast<unsigned>(blocks), kThreads, smem,
                             stream>>>(s, x, c, static_cast<const T*>(wkn),
                                       bias, out, static_cast<T*>(acts), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_any(const Spec& s, const float* x, const float* c,
               const void* wkn, const float* bias, float* out, void* acts,
               long long n, cudaStream_t stream) {
  return s.wide ? launch<T, true>(s, x, c, wkn, bias, out, acts, n, stream)
                : launch<T, false>(s, x, c, wkn, bias, out, acts, n, stream);
}

}  // namespace

// x: [n, feat] features, or [n, 3] raw points with pe; c: [n, cond]
// condition, or [n, 3] raw view directions with pe; wkn: the input-major
// weight pack in the compute type; bias: the fp32 bias pack; out:
// [n, num_rgb + num_sigma]; acts: null, or [n, (depth + 1) * width +
// cond_width] in the compute type. Returns a cudaError_t.
extern "C" int mlp_fwd_launch(const float* x, const float* c, const void* wkn,
                              const float* bias, float* out, void* acts,
                              long long n,
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
  return bf16 ? launch_any<__nv_bfloat16>(s, x, c, wkn, bias, out, acts, n,
                                          st)
              : launch_any<float>(s, x, c, wkn, bias, out, acts, n, st);
}
