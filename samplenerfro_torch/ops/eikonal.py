"""Eikonal curved-ray marching through a voxelized IOR field.

Counterpart of samplenerfro_tpu/ops/eikonal.py:22-107: the grid gradient
bends the ray and, in the 'all' stage, the learned head refines it (the
shipped so3 rotation, or the spherical residual).
A Python loop over steps, differentiable by autograd; it is the plain
version of the CUDA march kernels (ops/march_kernel.py) and of the
reverse sweep (ops/eikonal_vjp.py).
"""

import math

import torch
import torch.nn.functional as F

from samplenerfro_torch.ops import grid as grid_ops
from samplenerfro_torch.ops import math as math_ops


def rodrigues_rotate(raw_out, condition):
  """Rotate `condition` by the axis-angle vector `raw_out`.

  theta = |raw_out|, axis e = raw_out / theta; returns
  |condition| * R(e, theta) condition_hat with the norms floored at 1e-3
  (samplenerfro_tpu/ops/eikonal.py:22-35).
  """
  theta = math_ops.safe_l2_norm(raw_out)
  e = raw_out / theta
  a = math_ops.safe_l2_norm(condition)
  v = condition / a
  cos_t = torch.cos(theta)
  return a * (cos_t * v + torch.sin(theta) * torch.cross(e, v, dim=-1)
              + (1 - cos_t) * (e * v).sum(dim=-1, keepdim=True) * e)


def spherical_residual(raw_out, condition):
  """The residual head without direct output: condition plus an offset of
  radius softplus(raw_2 - 1) in the direction of spherical angles
  theta = pi tanh(raw_0), phi = pi tanh(raw_1)
  (samplenerfro_tpu/ops/eikonal.py:38-51)."""
  theta = torch.tanh(raw_out[..., 0:1]) * math.pi
  phi = torch.tanh(raw_out[..., 1:2]) * math.pi
  r = F.softplus(raw_out[..., 2:3] - 1.0)
  offset = torch.cat([torch.sin(phi) * torch.cos(theta),
                      torch.sin(phi) * torch.sin(theta),
                      torch.cos(phi)], dim=-1) * r
  return offset + condition


def march(spec, data, origins, directions, near, step_size, num_samples,
          pred_grad_fn=None, use_pred_grad=False, normalize_dirs=True,
          interp="highest"):
  """March curved eikonal paths for a batch of rays.

  Args:
    spec: grid_ops.GridSpec for the IOR grid.
    data: [N^3, 4] flattened grid holding [n, grad n] per voxel.
    origins: [batch, 3] ray origins.
    directions: [batch, 3] ray directions.
    near: distance to start marching at.
    step_size: h = (far - near) / (num_samples - 1).
    num_samples: S, number of path vertices.
    pred_grad_fn: (pos [batch, 3], grid grad [batch, 3]) -> refined
      gradient [batch, 3]; required when use_pred_grad.
    use_pred_grad: the 'all' stage: step with the refined gradient where
      |grid grad| > 1e-3 (samplenerfro_tpu/ops/eikonal.py:89-94).
    normalize_dirs: emit unit directions; False emits them raw.
    interp: the interpolation's precision (grid_ops.trilinear).

  Returns:
    (pos [batch, S, 3], dirs [batch, S, 3], arclength [batch, S],
     n [batch, S, 1], grad n [batch, S, 3]); each vertex is the state
    before that step's Euler update.
  """
  if use_pred_grad and pred_grad_fn is None:
    raise ValueError("use_pred_grad needs a pred_grad_fn")
  rp = origins + near * directions
  rd = directions
  rt = torch.full(origins.shape[:-1], near, dtype=origins.dtype,
                  device=origins.device)
  # `float / tensor` would compute step_size * reciprocal(n); a tensor
  # numerator keeps the true division the kernel and JAX do. A fill, not a
  # copy from the host, so that a CUDA graph can capture the march.
  h = torch.full((), step_size, dtype=origins.dtype, device=origins.device)
  outs = []
  for _ in range(num_samples):
    n, g = grid_n_and_grad(spec, data, rp, interp)
    next_rp, next_rd, next_rt = euler_step(rp, rd, rt, n, g, h, step_size,
                                           pred_grad_fn if use_pred_grad
                                           else None)
    outs.append((rp, math_ops.safe_l2_normalize(rd) if normalize_dirs else rd,
                 rt, n, g))
    rp, rd, rt = next_rp, next_rd, next_rt
  pos, dirs, dist, n, g = (torch.stack(cols, dim=1) for cols in zip(*outs))
  return pos, dirs, dist, n, g


def grid_n_and_grad(spec, data, rp, interp="highest"):
  """(n [..., 1], grad n [..., 3]) interpolated at rp at `interp`."""
  ng = grid_ops.trilinear(spec, data, rp, interp)
  return ng[..., :1], ng[..., 1:]


def euler_step(rp, rd, rt, n, g, h, step_size, pred_grad_fn=None):
  """One step of march from the state (rp, rd, rt) with (n, g) there: the
  next (rp, rd, rt). h: step_size as a 0-d tensor (true division); with
  pred_grad_fn, the step uses the refined gradient where |g| > 1e-3."""
  grad = g
  if pred_grad_fn is not None:
    active = torch.linalg.norm(g, dim=-1, keepdim=True) > 1e-3
    grad = torch.where(active, pred_grad_fn(rp, g), g)
  next_rp = rp + h / n * rd
  next_rd = rd + step_size * grad
  next_rt = rt + torch.sqrt(((rp - next_rp)**2).sum(dim=-1))
  return next_rp, next_rd, next_rt
