"""The port's probes: two of its CUDA build (csrc/probes.cu) and one of
the so3 head's ReLU masks (csrc/march_bwd.cu).

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

P3, `so3_preacts`, is the counterpart of the Pallas kernel of
scripts/debug/probe_so3_relu.py: the so3 head's pre-activations of hidden
layers 1-3, computed by K3's own forward (so3_encode and so3_layer, which
its passes 1b and 3 run), to be
held against `so3_preacts_reference`, which computes them as the plain
march and autograd do (annealed_pos_enc, then F.linear: cuBLAS on the
card). The two sum each product in another order; where a pre-activation
lies within that rounding of 0, its ReLU mask flips between them, and K3's
gradients then differ from autograd's in that unit's row and, through its
cotangent at that ray-step, in every layer below it.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version (`x + 1`, `torch.sin`, `so3_preacts_reference`) for CPU tensors.
"""

import collections
import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from samplenerfro_torch.ops import cuda_build
from samplenerfro_torch.ops import eikonal_vjp
from samplenerfro_torch.ops import march_kernel
from samplenerfro_torch.ops import math as math_ops
from samplenerfro_torch.ops import precision

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


def so3_preacts_reference(p, so3_params, alpha, max_deg=10,
                          dtype="float32"):
  """Plain version of P3: (pre1, pre2, pre3), each [N, width], of the so3
  head's first three layers at the points p [N, 3]; the PE window at
  alpha * max_deg, alpha rounded to float32 first as the kernels take it.
  dtype "bfloat16": the features, weights and activations rounded to bf16
  as operands (K3's bf16 arm), the sums fp32."""
  op = (lambda t: t) if precision.check_bwd_dtype(dtype) == "float32" else (
      precision.bf16)
  a = torch.as_tensor(alpha, dtype=torch.float32, device=p.device)
  h = op(math_ops.annealed_pos_enc(p, 0, max_deg, a * max_deg))
  pres = []
  for i in range(3):
    pres.append(F.linear(h, op(so3_params[2 * i]), so3_params[2 * i + 1]))
    h = op(torch.relu(pres[-1]))
  return tuple(pres)


def so3_preacts(p, so3_params, alpha, max_deg=10, dtype="float32"):
  """P3: the so3 head's pre-activations of layers 1-3 at p [N, 3], summed
  as K3 sums them in its arm `dtype` (march_bwd_dtype). Returns (pre1,
  pre2, pre3), each [N, width] float32."""
  precision.check_bwd_dtype(dtype)
  dev = p.device
  if dev.type == "cpu":
    return so3_preacts_reference(p, so3_params, alpha, max_deg, dtype)
  if dev.type != "cuda":
    raise ValueError(f"so3_preacts runs on CUDA or CPU tensors, not {dev}")
  if (p.dtype != torch.float32 or p.dim() != 2 or p.shape[1] != 3
      or not p.is_contiguous()):
    raise ValueError(f"so3_preacts: p must be contiguous float32 [N, 3], got "
                     f"{p.dtype} {tuple(p.shape)}")
  width = march_kernel.so3_width(so3_params, max_deg)
  for q in so3_params:
    if q.device != dev:
      raise ValueError(f"so3_preacts: so3 params on {q.device}, p on {dev}")
  wpack, _, wpack_t, _ = eikonal_vjp.arm_packs(so3_params, dtype)
  window = march_kernel.so3_window(torch.as_tensor(
      alpha, dtype=torch.float32, device=dev), max_deg).detach().contiguous()
  n = p.shape[0]
  pre = torch.empty((3, n, width), dtype=torch.float32, device=dev)
  lib = cuda_build.load("march_bwd")
  fn = lib.so3_preacts_launch
  if fn.restype is not ctypes.c_int or not fn.argtypes:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 5 + [ci] * 4 + [vp]
    fn.restype = ci
  with torch.cuda.device(dev):
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(p.data_ptr(), wpack.data_ptr(), wpack_t.data_ptr(),
             window.data_ptr(), pre.data_ptr(), n, max_deg, width,
             int(dtype == "bfloat16"), stream)
  if err != 0:
    raise RuntimeError(f"so3_preacts: kernel launch failed with CUDA error "
                       f"{err}")
  so3_preacts.launches += 1
  so3_preacts.arms[dtype] += 1
  return pre[0], pre[1], pre[2]


so3_preacts.launches = 0
so3_preacts.arms = collections.Counter()


def so3_preacts_by_step(pos, so3_params, alpha, max_deg=10,
                        dtype="float32"):
  """P3 and its plain version at the path vertices pos [B, S, 3]: P3 in
  one call, the plain version a step at a time on all B rays, as the plain
  march (and autograd through it) calls the head. cuBLAS picks its
  summation order by the shape of the call, so this is the order the
  plain 'all' march uses. Returns per layer 1-3 ([B, S, W] P3,
  [B, S, W] plain)."""
  b, steps = pos.shape[:2]
  got = so3_preacts(pos.reshape(-1, 3).contiguous(), so3_params, alpha,
                    max_deg, dtype)
  plain = [so3_preacts_reference(pos[:, i].contiguous(), so3_params, alpha,
                                 max_deg, dtype) for i in range(steps)]
  return [(g.reshape(b, steps, -1),
           torch.stack([x[layer] for x in plain], dim=1))
          for layer, g in enumerate(got)]


def relu_flips(got, want, mask=None):
  """P3's comparison of two sets of pre-activations, per layer: the max
  abs difference, the ReLU masks that differ ((a > 0) != (b > 0)), the
  element count and the smallest |want|; over the rows where `mask` (the
  pre-activations' shape but the last) holds, when given."""
  out = []
  for a, b in zip(got, want):
    if mask is not None:
      a, b = a[mask], b[mask]
    out.append({"max_dev": float((a - b).abs().max()),
                "flips": int(((a > 0) != (b > 0)).sum()),
                "elements": a.numel(), "min_abs": float(b.abs().min())})
  return out
