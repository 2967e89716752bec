"""The operations and bytes a cell's work needs, from its shapes and inputs.

Each count is the least the work needs, whatever implements it: every
input byte read once and every output byte written once, the products at
the configured precision's peak, nothing recomputed. Where the work
depends on the data it is counted on the cell's own inputs: the active
ray-steps (|grad n| > 1e-3, where the so3 head runs) and the distinct grid
voxels the paths touch, as the reference's march of the same rays finds
them (portbench/reference).

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity), at
the card's full 700 W.
"""

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
PEAK = {"fp32": 67e12, "bf16": 989e12}
# fp32 operations of one Euler step of the march (interpolation, step,
# arclength; the K1/K2 design figure), of one step's adjoint (K3), and of
# the so3 head's encoding and Rodrigues rotation at an active step.
MARCH_STEP_OPS = 120
MARCH_ADJOINT_OPS = 200
HEAD_EXTRA_OPS = 6 * 10 + 60
ADAM_OPS = 12  # a trained parameter's update


def nerf_mlp_macs(f):
  """Multiply-adds of one NerfMLP row: trunk (the input joined after every
  skip_layer-th layer), sigma, bottleneck, condition layers, rgb.

  in = 3 + 6 max_deg_point, cond = 3 + 6 deg_view; at the shipped 8 x 256
  (skip 4) with a 128-wide view head: 63*256 + 6*256^2 + 319*256 + 256
  + 256^2 + 283*128 + 128*3 = 592,768."""
  fin = 3 + 6 * f["max_deg_point"]
  cond = 3 + 6 * f["deg_view"]
  w, wc = f["net_width"], f["net_width_condition"]
  macs, width = 0, fin
  for i in range(f["net_depth"]):
    macs += width * w
    width = w + (fin if i % f["skip_layer"] == 0 and i > 0 else 0)
  macs += width + width * w          # sigma, bottleneck
  width = w + cond
  for _ in range(f["net_depth_condition"]):
    macs += width * wc
    width = wc
  return macs + width * 3


def bkgd_macs(f):
  """Multiply-adds of one background-MLP row (4 x 128, the input joined
  after the third layer): 27*128 + 2*128^2 + 155*128 + 128*3 = 56,064."""
  cond = 3 + 6 * f["deg_view"]
  return cond * 128 + 2 * 128 * 128 + (128 + cond) * 128 + 128 * 3


def so3_macs(width=128, in_dim=60):
  """Multiply-adds of one so3-head evaluation (4 x width, the encoding
  joined after the third layer): 60*128 + 2*128^2 + 188*128 + 128*3."""
  return (in_dim * width + 2 * width * width + (width + in_dim) * width
          + width * 3)


def so3_params(width=128, in_dim=60):
  return so3_macs(width, in_dim) + 4 * width + 3


def _precision(f, key):
  return "bf16" if f.get(key) == "bfloat16" else "fp32"


def _ms(nbytes, ops):
  """(bound ms, "bytes" or "operations") of {class: operations} and
  bytes."""
  t_ops = 1e3 * sum(n / PEAK[c] for c, n in ops.items())
  t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
  return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops else "operations")


def k1(f, batch, distinct):
  """K1, the lean march: its dense path and coarse subsample written
  (7 floats a vertex), rays and jitter read, each voxel touched read once
  (16 bytes: n and grad n); MARCH_STEP_OPS a step."""
  s = f["num_coarse_samples"] * f["num_path_samples"]
  nc = f["num_coarse_samples"]
  nbytes = 4 * 7 * batch * (s + nc) + 4 * (6 * batch + nc) + 16 * distinct
  return _ms(nbytes, {"fp32": MARCH_STEP_OPS * batch * s})


def k2(f, batch, active, distinct):
  """K2, the march with the so3 head: the 11-float trajectory written, the
  voxels and the head's weights read once; the head's products at each
  active ray-step in march_bwd_dtype's class, the step and the head's
  encoding and rotation in fp32."""
  s = f["num_coarse_samples"] * f["num_path_samples"]
  nbytes = 44 * batch * s + 16 * distinct + 24 * batch + 4 * so3_params()
  ops = {_precision(f, "march_bwd_dtype"): 2 * so3_macs() * active,
         "fp32": MARCH_STEP_OPS * batch * s + HEAD_EXTRA_OPS * active}
  return _ms(nbytes, ops)


def k3(f, batch, active, distinct):
  """K3, the march's reverse sweep: the trajectory and its cotangent read,
  the voxels read once, the weights read and their gradients written;
  the head's backward to its input and its weight gradients (2x its
  forward; the forward it recomputes is not counted) at each active
  ray-step, MARCH_ADJOINT_OPS fp32 a ray-step."""
  s = f["num_coarse_samples"] * f["num_path_samples"]
  nbytes = 2 * 44 * batch * s + 16 * distinct + 24 * batch + 8 * so3_params()
  ops = {_precision(f, "march_bwd_dtype"): 4 * so3_macs() * active,
         "fp32": MARCH_ADJOINT_OPS * batch * s}
  return _ms(nbytes, ops)


def mlp_ops(f, batch, env_rows, train, render_fp32=False):
  """{class: operations} of the radiance MLPs' products for `batch` rays:
  coarse (Nc rows a ray) and fine (Nc + Nf), forward, and when `train`
  backward (to the input and the weights, 2x), plus the background MLP
  on one row a ray and `env_rows` env rays, in fp32."""
  nc, nf = f["num_coarse_samples"], f["num_fine_samples"]
  rows = batch * (2 * nc + nf)
  mult = 6 if train else 2
  cls = "fp32" if render_fp32 else _precision(f, "mlp_dtype")
  out = {"fp32": mult * bkgd_macs(f) * (batch + env_rows)}
  out[cls] = out.get(cls, 0) + mult * nerf_mlp_macs(f) * rows
  return out


def mlp_bound(f, batch, env_rows, train, render_fp32=False):
  """The MLPs' GEMMs: their operations, and their weights read (and their
  gradients written when training) and each row's input and output moved
  once."""
  ops = mlp_ops(f, batch, env_rows, train, render_fp32)
  nc, nf = f["num_coarse_samples"], f["num_fine_samples"]
  rows = batch * (2 * nc + nf)
  fin, cond = 3 + 6 * f["max_deg_point"], 3 + 6 * f["deg_view"]
  weights = 2 * nerf_mlp_macs(f) + bkgd_macs(f)
  nbytes = (4 * (1 + int(train)) * weights
            + 4 * rows * (fin + cond + 4) * (1 + int(train)))
  return _ms(nbytes, ops)


def train_step_ops(f, stage, batch, env_rows, active, trained):
  """{class: operations} a train step needs: the MLPs forward and
  backward, the march (and in 'all' the head forward and backward and the
  sweep), Adam over the `trained` parameters. Compositing, encodings and
  losses are not counted."""
  s = f["num_coarse_samples"] * f["num_path_samples"]
  ops = mlp_ops(f, batch, env_rows, True)
  add = lambda c, n: ops.__setitem__(c, ops.get(c, 0) + n)
  add("fp32", MARCH_STEP_OPS * batch * s + ADAM_OPS * trained)
  if stage == "all":
    add(_precision(f, "march_bwd_dtype"), 6 * so3_macs() * active)
    add("fp32", HEAD_EXTRA_OPS * active + MARCH_ADJOINT_OPS * batch * s)
  return ops


def render_ops(f, rays, active):
  """{class: operations} of rendering `rays` rays with the 'all' model:
  the march with the head at `active` ray-steps, the MLPs forward in
  fp32."""
  s = f["num_coarse_samples"] * f["num_path_samples"]
  ops = mlp_ops(f, rays, 0, False, render_fp32=True)
  add = lambda c, n: ops.__setitem__(c, ops.get(c, 0) + n)
  add("fp32", MARCH_STEP_OPS * rays * s + HEAD_EXTRA_OPS * active)
  add(_precision(f, "march_bwd_dtype"), 2 * so3_macs() * active)
  return ops


def ideal_seconds(ops):
  """Seconds the operations take with each class at its peak."""
  return sum(n / PEAK[c] for c, n in ops.items())


def distinct_voxels(spec, pos):
  """Grid voxels the trilinear gathers at these path vertices touch
  (pos [..., 3]; spec with ndim, nmin, ndelta)."""
  nmin = torch.tensor(spec.nmin, device=pos.device)
  ndelta = torch.tensor(spec.ndelta, device=pos.device)
  hi = torch.tensor(spec.ndim, device=pos.device) - 1
  c0 = torch.floor((pos.reshape(-1, 3) - nmin) / ndelta).long()
  ny, nz = spec.ndim[1], spec.ndim[2]
  seen = []
  for dx in (0, 1):
    for dy in (0, 1):
      for dz in (0, 1):
        c = torch.minimum(torch.clamp(
            c0 + torch.tensor([dx, dy, dz], device=pos.device), min=0), hi)
        seen.append((c[:, 0] * ny + c[:, 1]) * nz + c[:, 2])
  return int(torch.unique(torch.cat(seen)).numel())


def tile_order(height, width, tile=16):
  """The render's pixel order: row-major tile x tile blocks, partial edge
  tiles last."""
  idx = np.arange(height * width).reshape(height, width)
  full, partial = [], []
  for ty in range(0, height, tile):
    for tx in range(0, width, tile):
      blk = idx[ty:ty + tile, tx:tx + tile].reshape(-1)
      (full if blk.size == tile * tile else partial).append(blk)
  return np.concatenate(full + partial)
