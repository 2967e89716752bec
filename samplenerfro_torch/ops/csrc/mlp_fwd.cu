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
// Design: one block per row tile (128 rows in bf16, 64 in fp32; a quarter
// of that when the layers are wider than 256 or the inputs more than 128
// columns, so that the tile's activations fit in shared memory). The
// tile's activations live in shared memory, two buffers that alternate
// between a layer's input and output; nothing between layers goes to
// device memory. In bf16 every layer runs on tensor cores: the warpgroup
// engine for 128-row tiles (two consumer warpgroups of 64 rows, wgmma with
// the fp32 sum in the accumulator over the whole k, weight slabs copied by
// the copy engine into a ring that a producer warpgroup keeps full), the
// mma.sync engine for the wide geometries' 32-row tiles; the outputs whose
// sum lands near a bf16 rounding midpoint are recomputed in the plain
// version's k order from the output-major pack wnk. K5 recomputes the
// forward through the same forward_tile and Policy, so its activations are
// K4's bit for bit. fp32 runs on CUDA cores in k order, the plain
// version's order, its weights streamed from L2 in k-slabs through a
// three-stage cp.async ring. The sigma and rgb heads (1 and 3 columns) are
// fp32 dot products a thread, their weights loaded 8 at a time.
//
// What bounds it on the card: operations. One row is 593,408
// multiply-adds at the ship widths, so the render's fine call (1,572,864
// rows) is 1.87 TFLOP, 27.9 ms at the 67 TFLOP/s fp32 peak, against 25 MB
// of inputs and outputs; the bf16 train call (196,608 rows) 0.24 ms at the
// 989 TFLOP/s bf16 tensor-core peak. Weight traffic from L2 is what a tile
// pays besides: 2.37 MB (fp32) a 64-row tile, 1.2 MB of slabs (bf16) a
// 128-row tile, shared by its two warpgroups.
//
// With acts, the kernel also writes every stored activation of each row
// (the trunk's, the bottleneck's and the condition layer's, in K5's
// scratch order, mlp_kernel.forward_activations) to acts, so that K5's
// recompute can be compared with it.

#include "mlp_common.cuh"

namespace {

using fused_mlp::kThreads;
using fused_mlp::Spec;

template <typename T, bool kWide>
using Fwd = fused_mlp::Policy<T, kWide>;

template <typename T, bool kWide>
__global__ void __launch_bounds__(fused_mlp::block_threads<Fwd<T, kWide>>())
    mlp_fwd_kernel(Spec s, const float* x, const float* c, const T* wkn,
                   const T* wnk, const void* slabs, const float* bias,
                   float* out, T* acts, long long n, int stages) {
  using P = Fwd<T, kWide>;
  extern __shared__ __align__(16) unsigned char smem[];
  const fused_mlp::TileBufs<T> t = fused_mlp::tile_bufs<P>(s, smem, stages);
  fused_mlp::Feed f{};
  if (P::kWarpgroup) {
    fused_mlp::feed_init(f, reinterpret_cast<unsigned char*>(t.ring), t.bars,
                         stages, slabs, s.fwd_slabs, s.fwd_slabs);
    if (!fused_mlp::feed_split(f)) return;
  }
  const long long row0 = static_cast<long long>(blockIdx.x) * P::kRows;
  fused_mlp::load_tile<P>(s, x, c, row0, n, t);
  fused_mlp::tile_sync();
  // acts: per row, the trunk's activations, the bottleneck's, the
  // condition layer's (depth * width + width + cond_width values).
  const long long per_row =
      static_cast<long long>(s.depth + 1) * s.width + s.cond_width;
  fused_mlp::forward_tile<P>(
      s, wkn, wnk, bias, t, f, out, row0, n,
      [&](int id, const T* buf, int width) {
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
           const void* wnk, const void* slabs, const float* bias, float* out,
           void* acts, long long n, cudaStream_t stream) {
  using P = Fwd<T, kWide>;
  // The feed's stages: as many as fit, up to kMaxFeedStages.
  int stages = 0;
  if (P::kWarpgroup) {
    stages = fused_mlp::kMaxFeedStages;
    while (stages > 2 &&
           fused_mlp::tile_bytes<P>(s, stages) > fused_mlp::kMaxSmem)
      --stages;
    if (slabs == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = fused_mlp::tile_bytes<P>(s, stages);
  if (smem > fused_mlp::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_fwd_kernel<T, kWide>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n + P::kRows - 1) / P::kRows;
  mlp_fwd_kernel<T, kWide>
      <<<static_cast<unsigned>(blocks), fused_mlp::block_threads<P>(), smem,
         stream>>>(s, x, c, static_cast<const T*>(wkn),
                   static_cast<const T*>(wnk), slabs, bias, out,
                   static_cast<T*>(acts), n, stages);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_any(const Spec& s, const float* x, const float* c,
               const void* wkn, const void* wnk, const void* slabs,
               const float* bias, float* out, void* acts, long long n,
               cudaStream_t stream) {
  return s.wide ? launch<T, true>(s, x, c, wkn, wnk, slabs, bias, out, acts,
                                  n, stream)
                : launch<T, false>(s, x, c, wkn, wnk, slabs, bias, out, acts,
                                   n, stream);
}

}  // namespace

// x: [n, feat] features, or [n, 3] raw points with pe; c: [n, cond]
// condition, or [n, 3] raw view directions with pe; wkn, wnk: the
// input-major and output-major weight packs in the compute type (wnk's
// rows recompute the bf16 outputs near a rounding midpoint); slabs: the slab pack (bf16 tiles that
// are not wide; num_slabs slabs of kSlabBytes, at least the forward's),
// else null and 0; bias: the fp32 bias pack; out: [n, num_rgb +
// num_sigma]; acts: null, or [n, (depth + 1) * width + cond_width] in the
// compute type. Returns a cudaError_t.
extern "C" int mlp_fwd_launch(const float* x, const float* c, const void* wkn,
                              const void* wnk, long long num_wnk,
                              const void* slabs, long long num_slabs,
                              const float* bias, float* out, void* acts,
                              long long n,
                              int bf16, int depth, int width, int skip,
                              int feat, int cond, int cond_width, int num_rgb,
                              int num_sigma, int pe, long long num_weights,
                              void* stream) {
  Spec s;
  if (!fused_mlp::make_spec(&s, depth, width, skip, feat, cond, cond_width,
                            num_rgb, num_sigma, pe) ||
      s.num_weights != num_weights || s.num_wnk != num_wnk ||
      (bf16 && !s.wide ? num_slabs < s.fwd_slabs : num_slabs != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_any<__nv_bfloat16>(s, x, c, wkn, wnk, slabs, bias,
                                          out, acts, n, st)
              : launch_any<float>(s, x, c, wkn, wnk, slabs, bias, out, acts,
                                  n, st);
}
