"""K1, the lean eikonal march: CUDA kernel wrapper and its plain version.

Replaces samplenerfro_tpu/ops/pallas/march_kernel.py:_march_kernel in lean
mode (march_tiled_pallas_lean). The kernel is csrc/march_lean.cu; its
source comment says what bounds it on the card.

`march_lean` launches the kernel for CUDA tensors and uses
`march_lean_reference` only for CPU tensors. Unlike the TPU kernel it
marches straight out of the grid in device memory, so it takes no
window, refetch, interpolation-precision or skip settings and reports no
out-of-window count.
"""

import ctypes

import torch

from samplenerfro_torch.ops import cuda_build
from samplenerfro_torch.ops import eikonal as eik_ops
from samplenerfro_torch.ops import math as math_ops


def march_lean_reference(spec, data, origins, directions, near, step_size,
                         num_samples, jitter):
  """Plain PyTorch version of K1: ops/eikonal.march plus the jitter gather."""
  pos, dirs, dist, _, _ = eik_ops.march(spec, data, origins, directions, near,
                                        step_size, num_samples)
  jitter = jitter.to(device=pos.device, dtype=torch.int64)
  return pos, dirs, dist, pos[:, jitter], dirs[:, jitter], dist[:, jitter]


def _check_inputs(spec, data, origins, directions, num_samples, jitter):
  dev = origins.device
  nvox = spec.ndim[0] * spec.ndim[1] * spec.ndim[2]
  for name, t, shape in (("origins", origins, (origins.shape[0], 3)),
                         ("directions", directions, (origins.shape[0], 3)),
                         ("data", data, (nvox, 4))):
    if t.device != dev:
      raise ValueError(f"march_lean: {name} is on {t.device}, origins on {dev}")
    if t.dtype != torch.float32:
      raise ValueError(f"march_lean: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
      raise ValueError(f"march_lean: {name} has shape {tuple(t.shape)}, "
                       f"expected {shape}")
    if not t.is_contiguous():
      raise ValueError(f"march_lean: {name} must be contiguous")
  if data.data_ptr() % 16:
    raise ValueError("march_lean: data must be 16-byte aligned (float4 voxels)")
  if jitter.dim() != 1 or jitter.dtype not in (torch.int32, torch.int64):
    raise ValueError("march_lean: jitter must be a 1-D integer tensor")
  nc = jitter.shape[0]
  if nc == 0 or num_samples % nc:
    raise ValueError(f"march_lean: num_samples {num_samples} is not a "
                     f"multiple of the {nc} coarse bins")
  per = num_samples // nc
  lo = torch.arange(nc, device=jitter.device) * per
  if not bool(((jitter >= lo) & (jitter < lo + per)).all()):
    raise ValueError("march_lean: jitter[c] must lie in "
                     "[c*num_path, (c+1)*num_path)")


def march_lean(spec, data, origins, directions, near, step_size, num_samples,
               jitter):
  """March, emitting the dense path and the jittered coarse subsample.

  Args:
    spec: GridSpec of the IOR grid.
    data: [N^3, 4] float32 grid of [n, grad n], on the device of `origins`.
    origins, directions: [batch, 3] float32.
    near: distance to start marching at.
    step_size: Euler step h.
    num_samples: S, path vertices per ray.
    jitter: [Nc] integer indices, jitter[c] in [c*S/Nc, (c+1)*S/Nc).

  Returns:
    (pos [B, S, 3], unit dirs [B, S, 3], dist [B, S],
     sub_pos [B, Nc, 3], sub_dirs [B, Nc, 3], sub_dist [B, Nc]).
  """
  dev = origins.device
  if dev.type == "cpu":
    return march_lean_reference(spec, data, origins, directions, near,
                                step_size, num_samples, jitter)
  if dev.type != "cuda":
    raise ValueError(f"march_lean runs on CUDA or CPU tensors, not {dev}")
  _check_inputs(spec, data, origins, directions, num_samples, jitter)
  lib = _library()
  batch, nc = origins.shape[0], jitter.shape[0]
  dense = torch.empty((batch, num_samples, 7), dtype=torch.float32, device=dev)
  sub = torch.empty((batch, nc, 7), dtype=torch.float32, device=dev)
  jit32 = jitter.to(device=dev, dtype=torch.int32).contiguous()
  with torch.cuda.device(dev):
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.march_lean_launch(
        origins.data_ptr(), directions.data_ptr(), data.data_ptr(),
        jit32.data_ptr(), dense.data_ptr(), sub.data_ptr(), batch,
        num_samples, nc, *spec.ndim, near, step_size, *spec.nmin,
        *spec.ndelta, stream)
  if err != 0:
    raise RuntimeError(f"march_lean: kernel launch failed with CUDA error "
                       f"{err}")
  march_lean.launches += 1
  return (dense[..., 0:3], math_ops.safe_l2_normalize(dense[..., 3:6]),
          dense[..., 6], sub[..., 0:3],
          math_ops.safe_l2_normalize(sub[..., 3:6]), sub[..., 6])


march_lean.launches = 0


def _library():
  lib = cuda_build.load("march_lean")
  fn = lib.march_lean_launch
  if fn.restype is not ctypes.c_int or not fn.argtypes:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [vp] * 6 + [ci] * 6 + [cf] * 8 + [vp]
    fn.restype = ci
  return lib
