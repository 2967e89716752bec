"""Two toolchain probes of the port's CUDA build (csrc/probes.cu).

P1, `add_one`, is the counterpart of samplenerfro_tpu/utils/mosaic_probe.py:
where that module compiled a one-op Pallas kernel (x + 1 on [8, 128]) to
learn whether the TPU's remote compiler was alive, P1 is the first kernel
chip_smoke.py launches after the build, and must return x + 1 exactly. The
port has no relay, so there is no subprocess, timeout or cache here.

P2, `sin`, is the counterpart of scripts/debug/dbg_sin.py: sinf on
[8, 256] at argument scales 1 to 2048, held against float64 and against
torch.sin on the same card. K4 encodes its inputs with that sinf at
arguments up to |x| * 2^9 (mlp_kernel's pe mode), so P2 says how far the
kernel's encoding can stand from the plain version's.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version (`x + 1`, `torch.sin`) for CPU tensors.
"""

import ctypes

import numpy as np
import torch

from samplenerfro_torch.ops import cuda_build

SIN_SCALES = (1.0, 64.0, 512.0, 2048.0)


def probe_inputs(shape, seed=0):
  """dbg_sin.py's inputs: uniform(-4, 4) fp32 from numpy's RandomState."""
  return torch.from_numpy(
      np.random.RandomState(seed).uniform(-4, 4, shape).astype(np.float32))


def _launch(fn_name, x):
  dev = x.device
  if x.dtype != torch.float32 or not x.is_contiguous():
    raise ValueError(f"{fn_name}: x must be contiguous float32")
  lib = cuda_build.load("probes")
  fn = getattr(lib, f"{fn_name}_launch")
  if fn.restype is not ctypes.c_int or not fn.argtypes:
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
  y = torch.empty_like(x)
  with torch.cuda.device(dev):
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(x.data_ptr(), y.data_ptr(), x.numel(), stream)
  if err != 0:
    raise RuntimeError(f"{fn_name}: kernel launch failed with CUDA error "
                       f"{err}")
  return y


def add_one(x):
  """P1: x + 1."""
  if x.device.type == "cpu":
    return x + 1
  if x.device.type != "cuda":
    raise ValueError(f"add_one runs on CUDA or CPU tensors, not {x.device}")
  y = _launch("probe_add_one", x)
  add_one.launches += 1
  return y


add_one.launches = 0


def sin(x):
  """P2: sin(x) with the kernels' precise sinf."""
  if x.device.type == "cpu":
    return torch.sin(x)
  if x.device.type != "cuda":
    raise ValueError(f"sin runs on CUDA or CPU tensors, not {x.device}")
  y = _launch("probe_sin", x)
  sin.launches += 1
  return y


sin.launches = 0


def sin_errors(device, seed=0):
  """P2 at each of SIN_SCALES: [(scale, max abs err against float64,
  max abs err against torch.sin on the same device)]."""
  x = probe_inputs((8, 256), seed)
  out = []
  for scale in SIN_SCALES:
    xs = (x * np.float32(scale)).to(device)
    got = sin(xs)
    ref = torch.from_numpy(np.sin(xs.cpu().numpy().astype(np.float64)))
    e64 = float((got.cpu().double() - ref).abs().max())
    elib = float((got - torch.sin(xs)).abs().max())
    out.append((scale, e64, elib))
  return out
