"""The refractive NeRF model: curved-path sampling + coarse/fine radiance.

Counterpart of samplenerfro_tpu/models/nerf.py:367-482 (NerfModel.__call__)
and :513-651 (construct_nerf) for the radiance-stage forward pass. The
march runs in K1 (ops/march_kernel.py); the MLPs are nn.Linear stacks in
fp32. Options the JAX model has and this one does not yet (SH colour,
online sparsity, the proxy-bbox mask, the boundary cut, IPE and the 'all'
stage) raise NotImplementedError.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from samplenerfro_torch.models import mlp as mlp_modules
from samplenerfro_torch.models import path_sampler as ps_module
from samplenerfro_torch.ops import grid as grid_ops
from samplenerfro_torch.ops import math as math_ops
from samplenerfro_torch.ops import render as render_ops


def activation(name):
  """torch counterpart of a flax.linen activation name."""
  fn = getattr(torch, name, None) or getattr(F, name, None)
  if fn is None:
    raise ValueError(f"unknown activation {name!r}")
  return fn


def make_jitter(num_coarse_samples, num_path_samples, generator=None,
                device=None):
  """The jittered 1-of-num_path dense index of each coarse bin.

  jitter[c] = c*num_path + U{0..num_path-1}, as models/nerf.py:387-392
  draws it, but from a torch.Generator.
  """
  base = torch.arange(0, num_coarse_samples * num_path_samples,
                      num_path_samples)
  off = torch.randint(0, num_path_samples, (num_coarse_samples,),
                      generator=generator)
  return (base + off).to(device)


class NerfModel(nn.Module):
  """Coarse/fine refractive NeRF with a learned directional background."""

  def __init__(self, spec, grid_data, *, stage, num_coarse_samples,
               num_fine_samples, num_path_samples, use_viewdirs, near, far,
               noise_std, net_depth, net_width, net_depth_condition,
               net_width_condition, net_activation, skip_layer,
               num_rgb_channels, num_sigma_channels, white_bkgd,
               min_deg_point, max_deg_point, deg_view, rgb_activation,
               sigma_activation, legacy_posenc_order, rgb_padding=0.001,
               sigma_bias=-1.0, generator=None):
    super().__init__()
    self.num_coarse_samples = num_coarse_samples
    self.num_fine_samples = num_fine_samples
    self.num_path_samples = num_path_samples
    self.use_viewdirs = use_viewdirs
    self.near, self.far = near, far
    self.noise_std = noise_std
    self.white_bkgd = white_bkgd
    self.min_deg_point, self.max_deg_point = min_deg_point, max_deg_point
    self.deg_view = deg_view
    self.legacy_posenc_order = legacy_posenc_order
    self.rgb_activation = rgb_activation
    self.sigma_activation = sigma_activation
    self.rgb_padding = rgb_padding
    self.sigma_bias = sigma_bias

    pts_dim = 3 + 6 * (max_deg_point - min_deg_point)
    dir_dim = 3 + 6 * deg_view
    mk_nerf_mlp = lambda: mlp_modules.NerfMLP(
        pts_dim, dir_dim if use_viewdirs else None, net_depth=net_depth,
        net_width=net_width, net_depth_condition=net_depth_condition,
        net_width_condition=net_width_condition,
        net_activation=net_activation, skip_layer=skip_layer,
        num_rgb_channels=num_rgb_channels,
        num_sigma_channels=num_sigma_channels, generator=generator)
    self.coarse_mlp = mk_nerf_mlp()
    self.fine_mlp = mk_nerf_mlp() if num_fine_samples > 0 else None
    self.bkgd_mlp = mlp_modules.MLP(
        dir_dim, net_depth=4, net_width=128, skip_layer=2,
        num_out_channels=num_rgb_channels, generator=generator)
    self.path_sampler = ps_module.PathSampler(
        spec, grid_data, near, far, num_coarse_samples * num_path_samples,
        stage)

  def _encode_dirs(self, dirs):
    return math_ops.pos_enc(dirs, 0, self.deg_view, self.legacy_posenc_order)

  def _encode_points(self, pts):
    return math_ops.pos_enc(pts, self.min_deg_point, self.max_deg_point,
                            self.legacy_posenc_order)

  def _decode(self, mlp, samples_enc, viewdirs_enc, randomized, generator):
    """MLP eval + noise + activations -> (rgb, sigma)."""
    if self.use_viewdirs:
      raw_rgb, raw_sigma = mlp(samples_enc, viewdirs_enc)
    else:
      raw_rgb, raw_sigma = mlp(samples_enc)
    raw_sigma = render_ops.add_gaussian_noise(raw_sigma, self.noise_std,
                                              randomized, generator)
    rgb = self.rgb_activation(raw_rgb)
    rgb = rgb * (1 + 2 * self.rgb_padding) - self.rgb_padding
    sigma = self.sigma_activation(raw_sigma + self.sigma_bias)
    return rgb, sigma

  def forward(self, rays, jitter, randomized=False, generator=None):
    """Render a batch of rays.

    Args:
      rays: Rays (data/rays.py) of [batch, ...] tensors on the model's device.
      jitter: [num_coarse] dense indices of the coarse subsample
        (make_jitter).
      randomized: stratified fine sampling and density noise.
      generator: torch.Generator on the model's device for that noise.

    Returns:
      ret: list of per-level tuples (comp_rgb [B, 3], distance [B],
      acc [B], trans [B, 1], trans_rgb_bkgd [B, 3]), coarse then fine.
    """
    ray_pos, ray_dir, ray_dist, _, _, sub = self.path_sampler(
        rays.origins, rays.viewdirs, jitter)
    ray_pos_c, ray_dir_c, ray_dist_c = sub

    samples_enc = self._encode_points(ray_pos_c)
    viewdirs_enc = self._encode_dirs(ray_dir_c)

    # Background colour from the exit direction of each path.
    raw_bkgd = self.bkgd_mlp(viewdirs_enc[:, -1:])[:, 0]
    bkgd = self.rgb_activation(raw_bkgd)
    bkgd = bkgd * (1 + 2 * self.rgb_padding) - self.rgb_padding

    rgb, sigma = self._decode(self.coarse_mlp, samples_enc, viewdirs_enc,
                              randomized, generator)
    comp_rgb, disp, acc, weights, _, trans, trans_rgb_bkgd = (
        render_ops.volumetric_rendering(rgb, sigma, ray_dist_c, ray_dir_c,
                                        self.white_bkgd, bkgd))
    ret = [(comp_rgb, disp, acc, trans, trans_rgb_bkgd)]

    if self.num_fine_samples > 0:
      mid = 0.5 * (ray_dist_c[..., 1:] + ray_dist_c[..., :-1])
      ray_dist_c, ray_pos_c, ray_dir_c, _ = render_ops.sample_pdf(
          mid, weights[..., 1:-1], ray_pos, ray_dir, ray_dist, None,
          self.num_fine_samples, randomized, jitter, self.near,
          z_coarse=ray_dist_c, generator=generator)
      samples_enc = self._encode_points(ray_pos_c)
      viewdirs_enc = self._encode_dirs(ray_dir_c)
      rgb, sigma = self._decode(self.fine_mlp, samples_enc, viewdirs_enc,
                                randomized, generator)
      comp_rgb, disp, acc, _, _, trans, trans_rgb_bkgd = (
          render_ops.volumetric_rendering(rgb, sigma, ray_dist_c, ray_dir_c,
                                          self.white_bkgd, bkgd))
      ret.append((comp_rgb, disp, acc, trans, trans_rgb_bkgd))
    return ret


def _check_activations(rgb_activation, sigma_activation, names):
  """The range checks of models/nerf.py:537-549."""
  x = torch.exp(torch.linspace(-90, 90, 1024))
  x = torch.cat([-x.flip(0), x])
  rgb = rgb_activation(x)
  if bool((rgb < 0).any() or (rgb > 1).any()):
    raise NotImplementedError(
        f"Choice of rgb_activation `{names[0]}` produces colors outside of "
        "[0, 1]")
  if bool((sigma_activation(x) < 0).any()):
    raise NotImplementedError(
        f"Choice of sigma_activation `{names[1]}` produces negative densities")


def construct_nerf(args, ndim, nmin, nmax, grid, gin_overrides=None,
                   device=None, seed=0):
  """Build the radiance-stage NerfModel.

  Args:
    args: flags namespace (utils/config.py).
    ndim/nmin/nmax: grid dims and bounds.
    grid: [N^3, 1] prefiltered IOR values, numpy array or torch tensor; the
      gradient grid is derived on the tensor's device.
    gin_overrides: dict of gin bindings ("NerfModel.x", "VoxMLP.x", ...).
    device: torch device of the model (resolve_device picks it).
    seed: seed of the weight initialisation.

  Returns:
    NerfModel on `device`, in eval mode.
  """
  g = dict(gin_overrides or {})
  unsupported = {
      "sh_deg >= 0": args.sh_deg >= 0,
      "sh_direnc_deg > 0": args.sh_direnc_deg > 0,
      "use_online_sparsity": bool(args.use_online_sparsity),
      "NerfModel.use_mask_bbox": bool(g.get("NerfModel.use_mask_bbox", False)),
      "NerfModel.bd_cut_dist": g.get("NerfModel.bd_cut_dist") is not None,
      "NerfModel.use_ipe": bool(g.get("NerfModel.use_ipe", False)),
      "mlp_kernel != xla": getattr(args, "mlp_kernel", "xla") != "xla",
  }
  for what, on in unsupported.items():
    if on:
      raise NotImplementedError(f"{what} is not ported yet")
  if g.get("VoxMLP.interp_method", "linear3") != "linear3":
    raise NotImplementedError(g["VoxMLP.interp_method"])

  net_activation = activation(args.net_activation)
  rgb_activation = activation(args.rgb_activation)
  sigma_activation = activation(args.sigma_activation)
  _check_activations(rgb_activation, sigma_activation,
                     (args.rgb_activation, args.sigma_activation))

  spec = grid_ops.GridSpec(ndim, nmin, nmax)
  values = torch.as_tensor(np.asarray(grid, np.float32) if isinstance(
      grid, np.ndarray) else grid, dtype=torch.float32)
  values = values.to(device).reshape(-1, 1)
  grid_data = torch.cat([values, grid_ops.central_difference_grad(spec, values)],
                        dim=-1)
  del values

  generator = torch.Generator().manual_seed(int(seed))
  model = NerfModel(
      spec, grid_data, stage=args.stage,
      num_coarse_samples=args.num_coarse_samples,
      num_fine_samples=args.num_fine_samples,
      num_path_samples=args.num_path_samples,
      use_viewdirs=args.use_viewdirs, near=args.near, far=args.far,
      noise_std=args.noise_std, net_depth=args.net_depth,
      net_width=args.net_width, net_depth_condition=args.net_depth_condition,
      net_width_condition=args.net_width_condition,
      net_activation=net_activation, skip_layer=args.skip_layer,
      num_rgb_channels=args.num_rgb_channels,
      num_sigma_channels=args.num_sigma_channels,
      white_bkgd=args.white_bkgd, min_deg_point=args.min_deg_point,
      max_deg_point=args.max_deg_point, deg_view=args.deg_view,
      rgb_activation=rgb_activation, sigma_activation=sigma_activation,
      legacy_posenc_order=args.legacy_posenc_order, generator=generator)
  return model.to(device).eval()
