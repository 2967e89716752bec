"""Depth and normal false-colour images, in PyTorch.

Counterpart of samplenerfro_tpu/utils/vis.py: sinebow, depth_to_normals,
visualize_depth, visualize_normals and visualize_suite, eval's depth,
depth_mod and depth_normals images. Inputs are [H, W] arrays or tensors
(on any device); outputs are [H, W, 3] float32 tensors on that device.
The default colormap is turbo from the port's own table (turbo_table.py).
"""

import math

import torch
import torch.nn.functional as F

from samplenerfro_torch.utils.turbo_table import TURBO

EPS = float(torch.finfo(torch.float32).eps)


def _tensor(x):
  return torch.as_tensor(x, dtype=torch.float32)


def turbo(value):
  """[...] values in [0, 1] -> [..., 3] turbo colours, with matplotlib's
  lookup of a float: entry int(x * 256), clipped to 255."""
  table = torch.tensor(TURBO, dtype=torch.float32, device=value.device)
  idx = torch.clamp((value * len(TURBO)).to(torch.int64), 0, len(TURBO) - 1)
  return table[idx]


def sinebow(h):
  """Cyclic uniform colormap (rnerf/vis.py:23-26)."""
  f = lambda x: torch.sin(math.pi * x)**2
  return torch.stack([f(3 / 6 - h), f(5 / 6 - h), f(7 / 6 - h)], -1)


def _convolve2d(z, kernel):
  """A true 2-D convolution, zero-padded to z's shape (mode "same"), as
  jax.scipy.signal.convolve2d computes it: conv2d correlates, so the
  kernel is flipped."""
  k = torch.flip(kernel, (0, 1)).to(z)[None, None]
  return F.conv2d(z[None, None], k, padding=1)[0, 0]


def depth_to_normals(depth):
  """Linearize an orthographic depth map into normals (rnerf/vis.py:34-42)."""
  f_blur = torch.tensor([1.0, 2.0, 1.0]) / 4
  f_edge = torch.tensor([-1.0, 0.0, 1.0]) / 2
  dy = _convolve2d(depth, f_blur[None, :] * f_edge[:, None])
  dx = _convolve2d(depth, f_blur[:, None] * f_edge[None, :])
  inv_denom = 1 / torch.sqrt(1 + dx**2 + dy**2)
  return torch.stack([dx * inv_denom, dy * inv_denom, inv_denom], -1)


def visualize_depth(depth, acc=None, near=None, far=None, ignore_frac=0,
                    curve_fn=lambda x: -torch.log(x + EPS), modulus=0,
                    colormap=None):
  """False-colour a depth map (rnerf/vis.py:45-111). As in the JAX
  function, a near or far of 0 counts as unset."""
  depth = _tensor(depth)
  acc = torch.ones_like(depth) if acc is None else _tensor(acc).to(depth)
  acc = torch.where(torch.isnan(depth), torch.zeros_like(acc), acc)

  sortidx = torch.argsort(depth.reshape(-1), stable=True)
  depth_sorted = depth.reshape(-1)[sortidx]
  acc_sorted = acc.reshape(-1)[sortidx]
  cum_acc_sorted = torch.cumsum(acc_sorted, 0)
  mask = ((cum_acc_sorted >= cum_acc_sorted[-1] * ignore_frac) &
          (cum_acc_sorted <= cum_acc_sorted[-1] * (1 - ignore_frac)))
  depth_keep = depth_sorted[mask]

  near = near or depth_keep[0] - EPS
  far = far or depth_keep[-1] + EPS
  depth, near, far = [curve_fn(_tensor(x).to(depth.device))
                      for x in (depth, near, far)]

  if modulus > 0:
    value = torch.remainder(depth, modulus) / modulus
    colormap = colormap or sinebow
  else:
    value = torch.nan_to_num(torch.clamp(
        (depth - torch.minimum(near, far)) / torch.abs(far - near), 0, 1))
    colormap = colormap or turbo

  vis = colormap(value)[:, :, :3]
  return vis * acc[:, :, None] + (1 - acc)[:, :, None]


def visualize_normals(depth, acc, scaling=None):
  """Fake normals of a depth map (rnerf/vis.py:114-132)."""
  depth = _tensor(depth)
  if scaling is None:
    mask = ~torch.isnan(depth)
    y, x = torch.meshgrid(
        torch.arange(depth.shape[0], dtype=torch.float32,
                     device=depth.device),
        torch.arange(depth.shape[1], dtype=torch.float32,
                     device=depth.device), indexing="ij")
    var = lambda v: torch.var(v, correction=0)
    xy_var = (var(x[mask]) + var(y[mask])) / 2
    z_var = var(depth[mask])
    scaling = torch.sqrt(xy_var / z_var)

  normals = depth_to_normals(scaling * depth)
  vis = (torch.isnan(normals).to(normals.dtype)
         + torch.nan_to_num((normals + 1) / 2, nan=0.0))
  if acc is not None:
    acc = _tensor(acc).to(depth)
    vis = vis * acc[:, :, None] + (1 - acc)[:, :, None]
  return vis


def visualize_suite(depth, acc):
  """eval's visualization bundle (rnerf/vis.py:135-142)."""
  return {
      "depth": visualize_depth(depth, acc),
      "depth_mod": visualize_depth(depth, acc, modulus=0.1),
      "depth_normals": visualize_normals(depth, acc),
  }
