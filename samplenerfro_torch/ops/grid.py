"""Voxel-grid primitives: trilinear interpolation, gradients, prefiltering.

Counterpart of samplenerfro_tpu/ops/grid.py. Grids are flat [Nx*Ny*Nz, C]
tensors in x-major order: idx = (x*Ny + y)*Nz + z.
"""

import numpy as np
import torch
import torch.nn.functional as F

from samplenerfro_torch.ops import math as math_ops


class GridSpec:
  """Static description of a voxel grid's domain."""

  __slots__ = ("ndim", "nmin", "nmax", "ndelta")

  def __init__(self, ndim, nmin, nmax):
    self.ndim = tuple(int(n) for n in ndim)
    self.nmin = tuple(float(v) for v in nmin)
    self.nmax = tuple(float(v) for v in nmax)
    self.ndelta = tuple(
        (self.nmax[i] - self.nmin[i]) / (self.ndim[i] - 1.0) for i in range(3))

  def __hash__(self):
    return hash((self.ndim, self.nmin, self.nmax))

  def __eq__(self, other):
    return (isinstance(other, GridSpec) and self.ndim == other.ndim
            and self.nmin == other.nmin and self.nmax == other.nmax)

  def axis_tensors(self, device):
    """(nmin, ndelta) as float32 [3] tensors on `device`.

    Dividing by a tensor keeps true division; a Python-scalar divisor may be
    turned into a multiply by its reciprocal, which rounds differently from
    the CUDA kernels and the JAX package.
    """
    return (math_ops.constant(self.nmin, torch.float32, device),
            math_ops.constant(self.ndelta, torch.float32, device))


def trilinear(spec, data, pts):
  """Clamp-to-edge trilinear interpolation.

  Args:
    spec: GridSpec.
    data: [Nx*Ny*Nz, C] flattened grid values.
    pts: [..., 3] world-space query points.

  Returns:
    [..., C], lerped x first, then y, then z (samplenerfro_tpu/ops/grid.py:
    50-102); corner indices clamped to [0, N-1], fractions unclamped.
  """
  nx, ny, nz = spec.ndim
  nmin, ndelta = spec.axis_tensors(pts.device)
  c = (pts - nmin) / ndelta
  c0f = torch.floor(c)
  frac = c - c0f
  xd, yd, zd = frac[..., 0:1], frac[..., 1:2], frac[..., 2:3]
  c0 = c0f.to(torch.int64)
  hi = math_ops.constant((nx - 1, ny - 1, nz - 1), torch.int64, pts.device)
  i0 = torch.minimum(torch.clamp(c0, min=0), hi)
  i1 = torch.minimum(torch.clamp(c0 + 1, min=0), hi)
  x0, y0, z0 = i0.unbind(-1)
  x1, y1, z1 = i1.unbind(-1)

  sy, sx = nz, ny * nz
  b0 = sx * x0
  b1 = sx * x1
  c000 = data[b0 + sy * y0 + z0]
  c100 = data[b1 + sy * y0 + z0]
  c001 = data[b0 + sy * y0 + z1]
  c101 = data[b1 + sy * y0 + z1]
  c010 = data[b0 + sy * y1 + z0]
  c110 = data[b1 + sy * y1 + z0]
  c011 = data[b0 + sy * y1 + z1]
  c111 = data[b1 + sy * y1 + z1]
  c00 = c000 * (1 - xd) + c100 * xd
  c01 = c001 * (1 - xd) + c101 * xd
  c10 = c010 * (1 - xd) + c110 * xd
  c11 = c011 * (1 - xd) + c111 * xd
  c0_ = c00 * (1 - yd) + c10 * yd
  c1_ = c01 * (1 - yd) + c11 * yd
  return c0_ * (1 - zd) + c1_ * zd


def central_difference_grad(spec, values):
  """Gradient grid by edge-replicated central differences.

  Args:
    spec: GridSpec.
    values: [Nx*Ny*Nz, 1] (or [Nx*Ny*Nz]) scalar field, torch tensor.

  Returns:
    [Nx*Ny*Nz, 3] float32 on the device of `values`
    (samplenerfro_tpu/ops/grid.py:165-178).
  """
  nx, ny, nz = spec.ndim
  v = values.reshape(1, 1, nx, ny, nz).to(torch.float32)
  p = F.pad(v, (1, 1, 1, 1, 1, 1), mode="replicate")[0, 0]
  dx = (p[2:, 1:-1, 1:-1] - p[:-2, 1:-1, 1:-1]) / (2 * spec.ndelta[0])
  dy = (p[1:-1, 2:, 1:-1] - p[1:-1, :-2, 1:-1]) / (2 * spec.ndelta[1])
  dz = (p[1:-1, 1:-1, 2:] - p[1:-1, 1:-1, :-2]) / (2 * spec.ndelta[2])
  return torch.stack([dx, dy, dz], dim=-1).reshape(-1, 3)


def central_difference_grad_numpy(spec, values):
  """NumPy twin of central_difference_grad for host-side preprocessing."""
  nx, ny, nz = spec.ndim
  v = np.asarray(values, np.float32).reshape(nx, ny, nz)
  padded = np.pad(v, ((1, 1), (1, 1), (1, 1)), mode="edge")
  dx = (padded[2:, 1:-1, 1:-1] - padded[:-2, 1:-1, 1:-1]) / (2 * spec.ndelta[0])
  dy = (padded[1:-1, 2:, 1:-1] - padded[1:-1, :-2, 1:-1]) / (2 * spec.ndelta[1])
  dz = (padded[1:-1, 1:-1, 2:] - padded[1:-1, 1:-1, :-2]) / (2 * spec.ndelta[2])
  return np.stack([dx, dy, dz], axis=-1).reshape(-1, 3)


def trilinear_numpy(spec, data, pts):
  """NumPy twin of `trilinear` for host-side dataset code (the boundary-
  point batches' gradient targets, data/datasets.Grid); the same numpy
  expressions as samplenerfro_tpu/ops/grid.py:181-212, so float64 points
  interpolate a float32 grid in float64."""
  nx, ny, nz = spec.ndim
  data = np.asarray(data)
  pts = np.asarray(pts)
  x = (pts[..., 0] - spec.nmin[0]) / spec.ndelta[0]
  y = (pts[..., 1] - spec.nmin[1]) / spec.ndelta[1]
  z = (pts[..., 2] - spec.nmin[2]) / spec.ndelta[2]
  x0f, y0f, z0f = np.floor(x), np.floor(y), np.floor(z)
  xd, yd, zd = (x - x0f)[..., None], (y - y0f)[..., None], (z - z0f)[..., None]
  x0 = np.clip(x0f.astype(int), 0, nx - 1)
  x1 = np.clip(x0f.astype(int) + 1, 0, nx - 1)
  y0 = np.clip(y0f.astype(int), 0, ny - 1)
  y1 = np.clip(y0f.astype(int) + 1, 0, ny - 1)
  z0 = np.clip(z0f.astype(int), 0, nz - 1)
  z1 = np.clip(z0f.astype(int) + 1, 0, nz - 1)
  sy, sx = nz, ny * nz
  c000 = data[sx * x0 + sy * y0 + z0]
  c100 = data[sx * x1 + sy * y0 + z0]
  c001 = data[sx * x0 + sy * y0 + z1]
  c101 = data[sx * x1 + sy * y0 + z1]
  c010 = data[sx * x0 + sy * y1 + z0]
  c110 = data[sx * x1 + sy * y1 + z0]
  c011 = data[sx * x0 + sy * y1 + z1]
  c111 = data[sx * x1 + sy * y1 + z1]
  c00 = c000 * (1 - xd) + c100 * xd
  c01 = c001 * (1 - xd) + c101 * xd
  c10 = c010 * (1 - xd) + c110 * xd
  c11 = c011 * (1 - xd) + c111 * xd
  c0 = c00 * (1 - yd) + c10 * yd
  c1 = c01 * (1 - yd) + c11 * yd
  return c0 * (1 - zd) + c1 * zd


def gaussian_prefilter(grid, ndim, ws, sigma):
  """Blur a scalar voxel grid with an isotropic 3D Gaussian, edge-padded.

  Args:
    grid: [N^3, 1] (or any shape of N^3 elements) torch tensor.
    ndim: (Nx, Ny, Nz).
    ws: odd kernel size.
    sigma: Gaussian standard deviation in voxels.

  Returns:
    [N^3, 1] float32 on the device of `grid`
    (samplenerfro_tpu/ops/grid.py:134-162). The JAX package convolves at
    Precision.HIGHEST; cuDNN would run this fp32 convolution in TF32 unless
    told otherwise, so TF32 is switched off for the call.
  """
  hws = ws // 2
  dev = grid.device
  data = grid.reshape(1, 1, *ndim).to(torch.float32)
  data = F.pad(data, (hws,) * 6, mode="replicate")
  a = torch.linspace(-hws, hws, ws, dtype=torch.float32, device=dev)
  r2 = a[:, None, None]**2 + a[None, :, None]**2 + a[None, None, :]**2
  kernel = torch.exp(-r2 / (2.0 * sigma**2))
  kernel = (kernel / kernel.sum())[None, None]
  prev = torch.backends.cudnn.allow_tf32
  torch.backends.cudnn.allow_tf32 = False
  try:
    out = F.conv3d(data, kernel)
  finally:
    torch.backends.cudnn.allow_tf32 = prev
  return out.reshape(-1, 1)
