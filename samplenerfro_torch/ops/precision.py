"""The shipped configs' reduced-precision arms and their rounding points.

Two flags of the JAX package name arithmetic the card can do:

  march_interp (and march_interp_all for the 'all' stages): the precision
    of the forward march's interpolation, the TPU kernel's two one-hot
    contractions (samplenerfro_tpu/ops/pallas/march_kernel.py:395-412).
    "highest" is fp32 (the port's lerps, ops/grid.trilinear); "high" is
    bf16x3; "default" is one bf16 pass.
  march_bwd_dtype: "float32", or "bfloat16" for the 'all' stage's reverse
    sweep (K3) at the passes form's bf16 operands. The port ties the so3
    head's forward in K2 to it as well (the TPU ran that head at DEFAULT
    whatever the flags; the port keeps the default flags bit for bit the
    JAX package's fp32 on the CPU instead), so that K3 differentiates the
    head K2 ran.

`bf16` is the one rounding the plain versions and their tests use; each
kernel rounds at the same points (csrc/march_common.cuh, march_so3.cu,
march_bwd.cu).
"""

import torch

INTERPS = ("highest", "high", "default")
BWD_DTYPES = ("float32", "bfloat16")
# The kernels' codes of INTERPS (csrc/march_common.cuh: kHighest, kHigh,
# kDefault).
INTERP_CODES = {name: code for code, name in enumerate(INTERPS)}


def check_interp(value):
  """`value` if it names an interpolation precision; else ValueError, as
  the JAX kernels' _precision raises for an unknown name."""
  if value not in INTERPS:
    raise ValueError(f"march interpolation precision must be one of "
                     f"{INTERPS}, got {value!r}")
  return value


def check_bwd_dtype(value):
  """`value` if it names a reverse-sweep dtype; else ValueError."""
  if value not in BWD_DTYPES:
    raise ValueError(f"march_bwd_dtype must be one of {BWD_DTYPES}, got "
                     f"{value!r}")
  return value


def bf16(x):
  """x rounded to bfloat16 (to nearest even), in x's dtype. Under autograd
  the rounding passes the cotangent through unrounded (x + (r - x), which
  is r exactly), as the analytic sweeps differentiate these arms."""
  r = x.to(torch.bfloat16).to(x.dtype)
  if x.requires_grad:
    return x + (r - x).detach()
  return r


def mxu_mul(v, w, interp, rnd=bf16):
  """v * w as the TPU's matrix unit multiplies at `interp` ("high" or
  "default"): "default" rounds both to bf16, whose product is exact in
  fp32; "high" splits each into bf16 hi and lo and sums hi*hi + hi*lo +
  lo*hi (bf16x3). rnd is the rounding (a test may replace it)."""
  vh, wh = rnd(v), rnd(w)
  if interp == "default":
    return vh * wh
  vl, wl = rnd(v - vh), rnd(w - wh)
  return (vh * wh + vh * wl) + vl * wh
