"""Eikonal path sampler with the learnable residual-gradient (so3) head.

Counterpart of samplenerfro_tpu/models/path_sampler.py. The [N^3, 4]
grid of [n, grad n] is a registered buffer, so it follows the module
across devices; it is never trained. The so3 head's weights exist in every
stage, as in the JAX model, and only the 'all' stage marches with them;
the `ior` stage trains them on the smoothness of the refined gradient at
the boundary points (compute_normal_loss_and_smooth). The head's
configuration (gin VoxMLP.*: its PE, residual and output branches) is a
march_kernel.So3Head; K2 and K3 compute the shipped one. Every march runs
at the stage's interpolation precision (`interp`: models/nerf.py's
effective_march_interp of march_interp and march_interp_all), and K2 and
K3 in the arm of march_bwd_dtype (`bwd_dtype`; ops/precision.py).
"""

import torch
from torch import nn

from samplenerfro_torch.ops import eikonal as eik_ops
from samplenerfro_torch.ops import eikonal_vjp
from samplenerfro_torch.ops import march_kernel
from samplenerfro_torch.ops import math as math_ops
from samplenerfro_torch.ops import mlp as mlp_ops
from samplenerfro_torch.ops import precision

SO3_MAX_DEG = 10  # PathSampler.max_deg_point, not bound by any shipped gin


class PathSampler(nn.Module):
  """Marches curved eikonal ray paths: K1 (or K2 with the head off) in
  radiance, K2/K3 (or the plain march under autograd) in 'all'."""

  def __init__(self, spec, grid_data, near, far, num_samples, stage,
               normal_radius_scale=0.1, head=march_kernel.SHIPPED_HEAD,
               interp_method="linear3", emit_grad=False, generator=None,
               interp="highest", bwd_dtype="float32"):
    super().__init__()
    if interp_method != "linear3":
      raise NotImplementedError(f"VoxMLP.interp_method = {interp_method!r}")
    self.normal_radius_scale = float(normal_radius_scale)
    self.spec = spec
    self.near = float(near)
    self.far = float(far)
    self.num_samples = int(num_samples)
    self.step_size = (self.far - self.near) / (self.num_samples - 1)
    self.use_pred_grad = stage.startswith("all")
    self.head = head
    if self.use_pred_grad:
      # The JAX model applies the head while its 'all' stage initialises.
      head.check()
    # How the 'all' stage marches, decided here from the head: K2 forward
    # and K3 backward compute the shipped head; the JAX package has no
    # kernel for another (samplenerfro_tpu/ops/eikonal_vjp.py:157-159) and
    # differentiates its plain march, as "plain" does here.
    self.march_all = "kernels" if head == march_kernel.SHIPPED_HEAD else (
        "plain")
    # The radiance march emits n and grad n along the dense path (K2 with
    # the head off) where the caller reads them (online sparsity), as the
    # JAX model turns march_emit to "full" (models/nerf.py:161-165).
    self.emit_grad = bool(emit_grad)
    nvox = spec.ndim[0] * spec.ndim[1] * spec.ndim[2]
    if tuple(grid_data.shape) != (nvox, 4):
      raise ValueError(f"grid_data must be [{nvox}, 4], got "
                       f"{tuple(grid_data.shape)}")
    self.register_buffer("grid", grid_data.to(torch.float32).contiguous())
    # The voxel extent on the module's device, for the smoothness offsets
    # (a CUDA graph cannot capture the copy from the host that makes it).
    self.register_buffer("ndelta", torch.tensor(spec.ndelta,
                                                dtype=torch.float32),
                         persistent=False)
    self.so3_mlp = mlp_ops.So3MLP(
        head.in_dim(SO3_MAX_DEG),
        output_init_std=1e-5 if head.use_residual else None,
        generator=generator)
    # The arm lives in march_cfg alone: every march reads it there, so that
    # one assignment to `interp` or `bwd_dtype` reaches K1, K2 and K3.
    self.march_cfg = eikonal_vjp.MarchConfig(
        spec, self.near, self.step_size, self.num_samples, SO3_MAX_DEG,
        precision.check_interp(interp), precision.check_bwd_dtype(bwd_dtype))

  @property
  def interp(self):
    """The forward interpolation's precision (march_cfg.interp)."""
    return self.march_cfg.interp

  @interp.setter
  def interp(self, value):
    self.march_cfg = self.march_cfg._replace(
        interp=precision.check_interp(value))

  @property
  def bwd_dtype(self):
    """The so3 head's and K3's arm (march_cfg.bwd_dtype)."""
    return self.march_cfg.bwd_dtype

  @bwd_dtype.setter
  def bwd_dtype(self, value):
    self.march_cfg = self.march_cfg._replace(
        bwd_dtype=precision.check_bwd_dtype(value))

  def wrapper_grad_mlp(self, x, condition, annealed_alpha=1.0):
    """The refined IOR gradient at points x [..., 3] with grid gradient
    `condition` [..., 3]: the so3 head's PE, skip-MLP and output head
    (samplenerfro_tpu/models/path_sampler.py:180-183), the head forward the
    plain marches call (march_kernel.so3_refine_fn)."""
    return march_kernel.so3_refine_fn(self.so3_mlp.params(), annealed_alpha,
                                      SO3_MAX_DEG, self.head)(x, condition)

  def compute_normal_loss_and_smooth(self, ray_pos, idx_grad, annealed_alpha,
                                     noise):
    """(normal loss, smoothness) of the refined gradient field at boundary
    points (samplenerfro_tpu/models/path_sampler.py:185-204).

    The normal loss is 0.0, as in the JAX package. The smoothness is the
    mean over points of sum |pred(p) - pred(p + offset)| / |grad n| with
    offset = noise * normal_radius_scale * the voxel extent.

    Args:
      ray_pos: [B, 1, 3] points; idx_grad: [B, 1, 3] grid gradients there.
      annealed_alpha: PE annealing progress, a float or a 0-d tensor.
      noise: [B, 1, 3] standard normal draws (the JAX package draws them
        from its key inside; the caller draws them here).
    """
    pred_grad = self.wrapper_grad_mlp(ray_pos, idx_grad, annealed_alpha)
    factor = math_ops.safe_l2_norm(idx_grad)
    offsets = noise * self.normal_radius_scale * self.ndelta[None, None]
    pred_grad_rand = self.wrapper_grad_mlp(ray_pos + offsets, idx_grad,
                                           annealed_alpha)
    smoothness = torch.sum(torch.abs((pred_grad - pred_grad_rand) / factor),
                           dim=-1, keepdim=True).mean()
    return 0.0, smoothness

  def forward(self, origins, directions, jitter, annealed_alpha=1.0):
    """March paths.

    Radiance stages: K1 (ops/march_kernel.march_lean); returns
    (pos, dirs, dist, None, None, (sub_pos, sub_dir, sub_dist)), the lean
    return of path_sampler.py:237-249. Without a jitter (a path dump,
    extract_mesh), or with emit_grad (online sparsity), K2 with the head
    off (march_full_plain), as the JAX sampler runs
    march_tiled_pallas(so3_params=None) there (path_sampler.py:317-323):
    (pos, unit dirs, dist, n, grad n, None), and the caller gathers the
    coarse subsample. 'all' stages: K2 forward and K3 backward
    (ops/eikonal_vjp) for the shipped head, the plain march
    (ops/eikonal.march) under autograd for another (march_all; its head in
    fp32: the JAX package's sweep for such a head, stepvjp, ignores
    bwd_dtype); either is
    differentiable in the so3 weights and the ray inputs and returns
    (pos, unit dirs, dist, n, grad n, None). Arclength carries no gradient
    in any stage (path_sampler.py:305).
    """
    origins, directions = origins.contiguous(), directions.contiguous()
    if not self.use_pred_grad and (jitter is None or self.emit_grad):
      traj = march_kernel.march_full_plain(
          self.spec, self.grid, origins, directions, self.near,
          self.step_size, self.num_samples, self.interp)
      pos, dirs_raw, dist, n, g = march_kernel.split_trajectory(traj)
      return (pos, math_ops.safe_l2_normalize(dirs_raw), dist.detach(), n, g,
              None)
    if not self.use_pred_grad:
      pos, dirs, dist, sub_pos, sub_dir, sub_dist = march_kernel.march_lean(
          self.spec, self.grid, origins, directions, self.near,
          self.step_size, self.num_samples, jitter, self.interp)
      return (pos, dirs, dist.detach(), None, None,
              (sub_pos, sub_dir, sub_dist.detach()))
    if self.march_all == "plain":
      alpha = torch.as_tensor(annealed_alpha, dtype=torch.float32,
                              device=origins.device)
      pos, dirs, dist, n, g = eik_ops.march(
          self.spec, self.grid, origins, directions, self.near,
          self.step_size, self.num_samples,
          pred_grad_fn=march_kernel.so3_refine_fn(
              self.so3_mlp.params(), alpha, SO3_MAX_DEG, self.head),
          use_pred_grad=True, interp=self.interp)
      return pos, dirs, dist.detach(), n, g, None
    traj = eikonal_vjp.march_allstage(self.march_cfg, self.grid, origins,
                                      directions, annealed_alpha,
                                      self.so3_mlp.params())
    pos, dirs_raw, dist, n, g = march_kernel.split_trajectory(traj)
    return (pos, math_ops.safe_l2_normalize(dirs_raw), dist.detach(), n, g,
            None)
