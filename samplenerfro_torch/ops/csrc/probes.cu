// P1 and P2: two toolchain probes, hand-written for Hopper (sm_90a).
//
// P1 replaces the kernel of samplenerfro_tpu/utils/mosaic_probe.py's
// _PROBE_SRC (line 39), y = x + 1 on an [8, 128] fp32 block, which told
// the JAX package whether its remote kernel compiler was alive. Here it is
// the first kernel chip_smoke.py launches after the build: it shows that
// nvcc's output loads, launches and returns exact results before any
// larger kernel runs.
//
// P2 replaces scripts/debug/dbg_sin.py:kern (line 16), sin on [8, 256]
// fp32, which compared the TPU kernel compiler's sin with XLA's at
// arguments scaled up to 2048. Here it is the precise sinf (no fast math)
// that K4 computes its in-kernel positional encoding with, held against
// float64 and against torch.sin on the same card at the arguments the
// encoding meets (up to |x| * 2^9).
//
// Both are bound by launch latency. P1 is launched as PyTorch launches
// its own elementwise kernel for a block this small: one block, each
// thread adding 1 to four values at a time with 16-byte loads and stores,
// then a scalar tail (and scalar throughout when a pointer is not 16-byte
// aligned). P2 is one thread per element.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kAddThreads = 256;

__global__ void __launch_bounds__(kAddThreads)
    probe_add_one_kernel(const float* x, float* y, int n, int vec) {
  const int q = vec ? n / 4 : 0;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* y4 = reinterpret_cast<float4*>(y);
  for (int i = threadIdx.x; i < q; i += kAddThreads) {
    const float4 v = x4[i];
    y4[i] = make_float4(v.x + 1.0f, v.y + 1.0f, v.z + 1.0f, v.w + 1.0f);
  }
  for (int i = 4 * q + threadIdx.x; i < n; i += kAddThreads) {
    y[i] = x[i] + 1.0f;
  }
}

__global__ void probe_sin_kernel(const float* x, float* y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = sinf(x[i]);
}

}  // namespace

extern "C" int probe_add_one_launch(const float* x, float* y, int n,
                                    void* stream) {
  const int vec = ((reinterpret_cast<std::uintptr_t>(x) |
                    reinterpret_cast<std::uintptr_t>(y)) % 16) == 0;
  probe_add_one_kernel<<<1, kAddThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(x, y, n, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_sin_launch(const float* x, float* y, int n,
                                void* stream) {
  probe_sin_kernel<<<(n + 255) / 256, 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(x, y, n);
  return static_cast<int>(cudaGetLastError());
}
