"""Eikonal path sampler, radiance stage.

Counterpart of samplenerfro_tpu/models/path_sampler.py for the stages that
march with the plain grid gradient (no learned so3 refinement, which the
'all' stage adds). The [N^3, 4] grid of [n, grad n] is a registered buffer,
so it follows the module across devices and into its state_dict.
"""

import torch
from torch import nn

from samplenerfro_torch.ops import march_kernel


class PathSampler(nn.Module):
  """Marches curved eikonal ray paths through the IOR grid with K1."""

  def __init__(self, spec, grid_data, near, far, num_samples, stage):
    super().__init__()
    if stage.startswith("all"):
      raise NotImplementedError(
          "the 'all' stage's so3-refined march is not ported yet")
    self.spec = spec
    self.near = float(near)
    self.far = float(far)
    self.num_samples = int(num_samples)
    self.step_size = (self.far - self.near) / (self.num_samples - 1)
    nvox = spec.ndim[0] * spec.ndim[1] * spec.ndim[2]
    if tuple(grid_data.shape) != (nvox, 4):
      raise ValueError(f"grid_data must be [{nvox}, 4], got "
                       f"{tuple(grid_data.shape)}")
    self.register_buffer("grid", grid_data.to(torch.float32).contiguous())

  def forward(self, origins, directions, jitter):
    """March paths through K1 (ops/march_kernel.march_lean).

    Returns (pos, dirs, dist, None, None, (sub_pos, sub_dir, sub_dist)),
    the shape of the JAX path sampler's lean-emit return
    (path_sampler.py:237-249): the dense path and the jittered coarse
    subsample; n and grad n are not emitted.
    """
    pos, dirs, dist, sub_pos, sub_dir, sub_dist = march_kernel.march_lean(
        self.spec, self.grid, origins.contiguous(), directions.contiguous(),
        self.near, self.step_size, self.num_samples, jitter)
    return pos, dirs, dist, None, None, (sub_pos, sub_dir, sub_dist)
