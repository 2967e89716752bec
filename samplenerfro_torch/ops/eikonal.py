"""Eikonal curved-ray marching through a voxelized IOR field.

Counterpart of samplenerfro_tpu/ops/eikonal.py:54-107 (radiance stage:
the grid gradient bends the ray, no learned refinement). A Python loop
over steps; it is the plain version of the CUDA march kernel
(ops/march_kernel.py).
"""

import torch

from samplenerfro_torch.ops import grid as grid_ops
from samplenerfro_torch.ops import math as math_ops


def march(spec, data, origins, directions, near, step_size, num_samples,
          use_pred_grad=False):
  """March curved eikonal paths for a batch of rays.

  Args:
    spec: grid_ops.GridSpec for the IOR grid.
    data: [N^3, 4] flattened grid holding [n, grad n] per voxel.
    origins: [batch, 3] ray origins.
    directions: [batch, 3] ray directions.
    near: distance to start marching at.
    step_size: h = (far - near) / (num_samples - 1).
    num_samples: S, number of path vertices.
    use_pred_grad: the 'all' stage's so3-refined gradient; not ported yet.

  Returns:
    (pos [batch, S, 3], unit dirs [batch, S, 3], arclength [batch, S],
     n [batch, S, 1], grad n [batch, S, 3]); each vertex is the state
    before that step's Euler update.
  """
  if use_pred_grad:
    raise NotImplementedError(
        "the so3-refined march of the 'all' stage is not ported yet")
  rp = origins + near * directions
  rd = directions
  rt = torch.full(origins.shape[:-1], near, dtype=origins.dtype,
                  device=origins.device)
  # `float / tensor` would compute step_size * reciprocal(n); a tensor
  # numerator keeps the true division the kernel and JAX do.
  h = torch.tensor(step_size, dtype=origins.dtype, device=origins.device)
  outs = []
  for _ in range(num_samples):
    interp = grid_ops.trilinear(spec, data, rp)
    n = interp[..., :1]
    g = interp[..., 1:]
    next_rp = rp + h / n * rd
    next_rd = rd + step_size * g
    next_rt = rt + torch.sqrt(((rp - next_rp)**2).sum(dim=-1))
    outs.append((rp, math_ops.safe_l2_normalize(rd), rt, n, g))
    rp, rd, rt = next_rp, next_rd, next_rt
  pos, dirs, dist, n, g = (torch.stack(cols, dim=1) for cols in zip(*outs))
  return pos, dirs, dist, n, g
