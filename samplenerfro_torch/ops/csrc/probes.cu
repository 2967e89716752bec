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
// Both are one thread per element and bound by launch latency.

#include <cuda_runtime.h>

namespace {

__global__ void probe_add_one_kernel(const float* x, float* y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] + 1.0f;
}

__global__ void probe_sin_kernel(const float* x, float* y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = sinf(x[i]);
}

}  // namespace

extern "C" int probe_add_one_launch(const float* x, float* y, int n,
                                    void* stream) {
  probe_add_one_kernel<<<(n + 255) / 256, 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(x, y, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_sin_launch(const float* x, float* y, int n,
                                void* stream) {
  probe_sin_kernel<<<(n + 255) / 256, 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(x, y, n);
  return static_cast<int>(cudaGetLastError());
}
