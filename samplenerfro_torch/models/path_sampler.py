"""Eikonal path sampler with the learnable residual-gradient (so3) head.

Counterpart of samplenerfro_tpu/models/path_sampler.py for the shipped
VoxMLP branch (annealed PE from degree 0, Rodrigues residual head). The
[N^3, 4] grid of [n, grad n] is a registered buffer, so it follows the
module across devices; it is never trained. The so3 head's weights exist
in every stage, as in the JAX model, and only the 'all' stage marches with
them.
"""

import torch
from torch import nn

from samplenerfro_torch.ops import eikonal_vjp
from samplenerfro_torch.ops import march_kernel
from samplenerfro_torch.ops import math as math_ops
from samplenerfro_torch.ops import mlp as mlp_ops

SO3_MAX_DEG = 10  # PathSampler.max_deg_point, not bound by any shipped gin


class PathSampler(nn.Module):
  """Marches curved eikonal ray paths: K1 in radiance, K2/K3 in 'all'."""

  def __init__(self, spec, grid_data, near, far, num_samples, stage,
               generator=None):
    super().__init__()
    self.spec = spec
    self.near = float(near)
    self.far = float(far)
    self.num_samples = int(num_samples)
    self.step_size = (self.far - self.near) / (self.num_samples - 1)
    self.use_pred_grad = stage.startswith("all")
    nvox = spec.ndim[0] * spec.ndim[1] * spec.ndim[2]
    if tuple(grid_data.shape) != (nvox, 4):
      raise ValueError(f"grid_data must be [{nvox}, 4], got "
                       f"{tuple(grid_data.shape)}")
    self.register_buffer("grid", grid_data.to(torch.float32).contiguous())
    self.so3_mlp = mlp_ops.So3MLP(6 * SO3_MAX_DEG, generator=generator)
    self.march_cfg = eikonal_vjp.MarchConfig(
        spec, self.near, self.step_size, self.num_samples, SO3_MAX_DEG)

  def forward(self, origins, directions, jitter, annealed_alpha=1.0):
    """March paths.

    Radiance stages: K1 (ops/march_kernel.march_lean); returns
    (pos, dirs, dist, None, None, (sub_pos, sub_dir, sub_dist)), the lean
    return of path_sampler.py:237-249. Without a jitter (a path dump,
    extract_mesh) K2 with the head off (march_full_plain), as the JAX
    sampler runs march_tiled_pallas(so3_params=None) there
    (path_sampler.py:317-323): (pos, unit dirs, dist, n, grad n, None).
    'all' stages: K2 forward and K3 backward (ops/eikonal_vjp), the march
    differentiable in the so3 weights and the ray inputs; returns
    (pos, unit dirs, dist, n, grad n, None) and the caller gathers the
    coarse subsample. Arclength carries no gradient in either stage
    (path_sampler.py:305).
    """
    origins, directions = origins.contiguous(), directions.contiguous()
    if not self.use_pred_grad and jitter is None:
      traj = march_kernel.march_full_plain(
          self.spec, self.grid, origins, directions, self.near,
          self.step_size, self.num_samples)
      pos, dirs_raw, dist, n, g = march_kernel.split_trajectory(traj)
      return (pos, math_ops.safe_l2_normalize(dirs_raw), dist.detach(), n, g,
              None)
    if not self.use_pred_grad:
      pos, dirs, dist, sub_pos, sub_dir, sub_dist = march_kernel.march_lean(
          self.spec, self.grid, origins, directions, self.near,
          self.step_size, self.num_samples, jitter)
      return (pos, dirs, dist.detach(), None, None,
              (sub_pos, sub_dir, sub_dist.detach()))
    traj = eikonal_vjp.march_allstage(self.march_cfg, self.grid, origins,
                                      directions, annealed_alpha,
                                      self.so3_mlp.params())
    pos, dirs_raw, dist, n, g = march_kernel.split_trajectory(traj)
    return (pos, math_ops.safe_l2_normalize(dirs_raw), dist.detach(), n, g,
            None)
