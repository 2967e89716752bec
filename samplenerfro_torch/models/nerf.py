"""The refractive NeRF model: curved-path sampling + coarse/fine radiance.

Counterpart of samplenerfro_tpu/models/nerf.py:182-482 (the encodings,
the boundary-point losses, forward_envmap, sample_points and
NerfModel.__call__) and :513-651 (construct_nerf) for the radiance, `ior`
and 'all' stages, with every model option of the JAX model: mip-NeRF's
IPE featurization (`NerfModel.use_ipe`, ops/mip.py), SH colour
(`sh_deg`) and SH direction encoding (`sh_direnc_deg`, ops/sh.py), the
proxy-bbox mask (`NerfModel.use_mask_bbox`), online sparsity, the real
scenes' boundary cut (`NerfModel.bd_cut_dist`, :256-275 and :463-476) and
the so3 head's VoxMLP variants (models/path_sampler.py). The march runs in
K1 (radiance), in K2 with the head off (radiance with online sparsity,
which reads the dense grad n) or in K2 with K3 as its backward ('all'
with the shipped head; the plain march under autograd for another head);
the MLPs are nn.Linear stacks in fp32 or, with `mlp_dtype=bfloat16`, bf16.
With `mlp_kernel=pallas` or `pallas_pe` the coarse and fine NerfMLPs of a
non-'all' stage without SH colour run fused, K4 forward and K5 backward
(ops/mlp_kernel.py), under the gates of :277-306.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from samplenerfro_torch.models import mlp as mlp_modules
from samplenerfro_torch.models import path_sampler as ps_module
from samplenerfro_torch.ops import grid as grid_ops
from samplenerfro_torch.ops import march_kernel
from samplenerfro_torch.ops import math as math_ops
from samplenerfro_torch.ops import mip as mip_ops
from samplenerfro_torch.ops import mlp_kernel as fused_ops
from samplenerfro_torch.ops import render as render_ops
from samplenerfro_torch.ops import sh as sh_ops
from samplenerfro_torch.parallel import mesh
from samplenerfro_torch.utils.config import MLP_KERNELS


def activation(name):
  """torch counterpart of a flax.linen activation name."""
  fn = getattr(torch, name, None) or getattr(F, name, None)
  if fn is None:
    raise ValueError(f"unknown activation {name!r}")
  return fn


def bd_cut_box(cfg_name, nmin, nmax):
  """The boundary-cut box of a real scene, chosen by substring of the
  config path in this order (samplenerfro_tpu/models/nerf.py:256-268):
  `pen` lowers the grid's top by 0.6, `ball` is an absolute box, `glass`
  lowers the top by 0.7. Returns (box min, box max)."""
  nmin, nmax = list(nmin), list(nmax)
  name = cfg_name or ""
  if "pen" in name:
    nmax[1] -= 0.6
  elif "ball" in name:
    nmin = [-1, 0.03597, -1]
    nmax = [1, 2.03597, 1]
  elif "glass" in name:
    nmax[1] -= 0.7
  else:
    raise NotImplementedError(
        f"the boundary cut has no box for config {cfg_name!r} (pen, ball or "
        "glass)")
  return nmin, nmax


def make_jitter(num_coarse_samples, num_path_samples, generator=None):
  """The jittered 1-of-num_path dense index of each coarse bin.

  jitter[c] = c*num_path + U{0..num_path-1}, as models/nerf.py:387-392
  draws it, but from a torch.Generator on the host (None: torch's default
  one). It stays on the host, where march_lean checks it, and goes to the
  card with the rays without a wait; the train loop checks it there
  itself (march_kernel.checked_jitter) and copies it with its batch.
  """
  if generator is not None and generator.device.type != "cpu":
    raise ValueError(f"make_jitter draws on the host: pass a CPU generator, "
                     f"not one on {generator.device}")
  base = torch.arange(0, num_coarse_samples * num_path_samples,
                      num_path_samples)
  off = torch.randint(0, num_path_samples, (num_coarse_samples,),
                      generator=generator)
  return base + off


class NerfModel(nn.Module):
  """Coarse/fine refractive NeRF with a learned directional background."""

  def __init__(self, spec, grid_data, *, stage, num_coarse_samples,
               num_fine_samples, num_path_samples, use_viewdirs, near, far,
               noise_std, net_depth, net_width, net_depth_condition,
               net_width_condition, net_activation, skip_layer,
               num_rgb_channels, num_sigma_channels, white_bkgd,
               min_deg_point, max_deg_point, deg_view, rgb_activation,
               sigma_activation, legacy_posenc_order, rgb_padding=0.001,
               sigma_bias=-1.0, mlp_dtype=torch.float32, mlp_kernel="xla",
               cfg_name=None, bd_cut_dist=None, use_fine_sparsity=False,
               use_online_sparsity=False, sh_deg=-1, sh_direnc_deg=-1,
               use_ipe=False, use_mask_bbox=False,
               head=march_kernel.SHIPPED_HEAD, interp_method="linear3",
               normal_radius_scale=0.1, generator=None):
    super().__init__()
    # The cut applies at the fine level only, as in the JAX model.
    cut = bd_cut_dist is not None and num_fine_samples > 0
    if cut and use_mask_bbox:
      # samplenerfro_tpu/models/nerf.py:466 asserts it.
      raise ValueError("'use_mask_bbox' is true: the boundary cut "
                       "(NerfModel.bd_cut_dist) needs it off")
    self.cut_box = bd_cut_box(cfg_name, spec.nmin, spec.nmax) if cut else None
    self.spec = spec
    self.stage = stage
    self.mlp_dtype = mlp_dtype
    self.mlp_kernel = mlp_kernel
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
    self.use_fine_sparsity = use_fine_sparsity
    self.use_online_sparsity = use_online_sparsity
    self.sh_deg = sh_deg
    self.sh_direnc_deg = sh_direnc_deg
    self.use_ipe = use_ipe
    self.use_mask_bbox = use_mask_bbox
    self.coarse_step_size = (far - near) / num_coarse_samples
    self.fine_step_size = (far - near) / (num_coarse_samples
                                          + num_fine_samples)

    # The MLPs' input widths: IPE's 6 per degree or pos_enc's 3 + 6 per
    # degree; SH direction encoding's deg^2 or pos_enc's 3 + 6 per degree.
    # The classic point and view encodings' widths are kept too, for the
    # JAX methods that call them whatever the options.
    self.classic_dims = (3 + 6 * (max_deg_point - min_deg_point),
                         3 + 6 * deg_view)
    pts_dim = (6 * (max_deg_point - min_deg_point) if use_ipe
               else self.classic_dims[0])
    dir_dim = (sh_direnc_deg**2 if sh_direnc_deg > 0
               else self.classic_dims[1])
    self.mlp_dims = (pts_dim, dir_dim, net_depth, net_width, skip_layer,
                     net_depth_condition, net_width_condition,
                     num_rgb_channels, num_sigma_channels)
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
        stage, normal_radius_scale=normal_radius_scale, head=head,
        interp_method=interp_method, emit_grad=use_online_sparsity,
        generator=generator)

  def _encode_dirs(self, dirs):
    """The view encoding (_encode_dirs, models/nerf.py:182-185): SH with
    sh_direnc_deg > 0 bands, else pos_enc."""
    if self.sh_direnc_deg > 0:
      return sh_ops.dir_enc(dirs, self.sh_direnc_deg)
    return math_ops.pos_enc(dirs, 0, self.deg_view, self.legacy_posenc_order)

  def _encode_points(self, pts, who):
    """The classic point encoding, which the JAX model's boundary-point
    loss and point probe use whatever the options (models/nerf.py:187-189):
    under use_ipe its width is not the MLPs', and flax fails there on the
    shape; so does this, naming the option."""
    if self.use_ipe:
      raise ValueError(f"{who} encodes its points with pos_enc "
                       f"({self.classic_dims[0]} wide); with "
                       f"NerfModel.use_ipe the MLPs take "
                       f"{self.mlp_dims[0]}, as in the JAX model, where "
                       "flax fails on the shape")
    return math_ops.pos_enc(pts, self.min_deg_point, self.max_deg_point,
                            self.legacy_posenc_order)

  def _featurize(self, pos, dirs, dists, radii):
    """Point features (models/nerf.py:308-317): the classic pos_enc, or
    with use_ipe the IPE of the cone Gaussians along the curved path
    (ops/mip.cast_rays, the sample positions as origins, as there)."""
    if not self.use_ipe:
      return math_ops.pos_enc(pos, self.min_deg_point, self.max_deg_point,
                              self.legacy_posenc_order)
    t_vals = torch.cat([dists, dists[..., -1:] + 1e-3], dim=-1)
    samples = mip_ops.cast_rays(t_vals, pos, dirs, radii, "cone", self.near)
    return mip_ops.integrated_pos_enc(samples, self.min_deg_point,
                                      self.max_deg_point)

  def wrapper_compute_normal_loss_and_smooth(self, ray_pos, idx_grad,
                                             annealed_alpha, noise):
    """PathSampler.compute_normal_loss_and_smooth (models/nerf.py:175-181)."""
    return self.path_sampler.compute_normal_loss_and_smooth(
        ray_pos, idx_grad, annealed_alpha, noise)

  def compute_sparsity_loss(self, ray_pos, coarse_alpha_target,
                            fine_alpha_target):
    """Offline sparsity of the density at boundary points [B, 1, 3] seen
    along a zero direction (samplenerfro_tpu/models/nerf.py:192-217):
    mean |alpha - target| of the coarse MLP, plus the fine MLP's with
    use_fine_sparsity; returns (loss, the coarse alpha's mean, the fine
    alpha's mean or 0.0). The MLPs run in nn.Linear at the model's dtype,
    as the JAX method calls its flax modules."""
    samples_enc = self._encode_points(ray_pos, "compute_sparsity_loss")
    viewdirs_enc = self._encode_dirs(torch.zeros_like(ray_pos))
    levels = [(self.coarse_mlp, self.coarse_step_size, coarse_alpha_target)]
    if self.num_fine_samples > 0 and self.use_fine_sparsity:
      levels.append((self.fine_mlp, self.fine_step_size, fine_alpha_target))
    loss_sp, means = 0.0, [0.0, 0.0]
    for i, (mlp, step_size, target) in enumerate(levels):
      if self.use_viewdirs:
        _, raw_sigma = mlp(samples_enc, viewdirs_enc, dtype=self.mlp_dtype)
      else:
        _, raw_sigma = mlp(samples_enc, dtype=self.mlp_dtype)
      sigma = self.sigma_activation(raw_sigma + self.sigma_bias)
      alpha = 1 - torch.exp(-step_size * sigma)
      loss_sp = loss_sp + (alpha - target).abs().mean()
      means[i] = alpha.mean()
    return loss_sp, means[0], means[1]

  def forward_envmap(self, viewdirs):
    """Background colour of [N, 3] directions (models/nerf.py:219-225),
    their classic pos_enc through the background MLP, whatever
    sh_direnc_deg (flax then fails on the shape: so does this) and
    sh_deg (the raw SH channels are activated as colours, as there)."""
    if self.sh_direnc_deg > 0:
      raise ValueError(f"forward_envmap encodes directions with pos_enc "
                       f"({self.classic_dims[1]} wide); with sh_direnc_deg "
                       f"{self.sh_direnc_deg} the background MLP takes "
                       f"{self.mlp_dims[1]}, as in the JAX model, where flax "
                       "fails on the shape")
    viewdirs_enc = math_ops.pos_enc(viewdirs, 0, self.deg_view,
                                    self.legacy_posenc_order)
    raw_bkgd = self.bkgd_mlp(viewdirs_enc[:, None])[:, 0]
    bkgd = self.rgb_activation(raw_bkgd)
    return bkgd * (1 + 2 * self.rgb_padding) - self.rgb_padding

  def sample_points(self, pts, viewdirs):
    """(rgb, alpha) of the fine MLP (the coarse one without fine samples)
    at arbitrary [..., 3] points seen along [..., 3] directions
    (samplenerfro_tpu/models/nerf.py:227-242); nn.Linear, or K4 under
    --mlp_kernel. alpha is 1 - exp(-step * sigma) at that level's step;
    with sh_deg >= 0 rgb holds the activated SH channels, as there."""
    use_fine = self.num_fine_samples > 0
    mlp = self.fine_mlp if use_fine else self.coarse_mlp
    step_size = (self.far - self.near) / (
        self.num_coarse_samples + (self.num_fine_samples if use_fine else 0))
    encode = not (self._use_fused_mlp() and self._fused_pe() is not None)
    samples_enc = (self._encode_points(pts, "sample_points") if encode
                   else None)
    viewdirs_enc = self._encode_dirs(viewdirs) if encode else None
    rgb, sigma = self._decode(mlp, samples_enc, viewdirs_enc, False, None,
                              self.mlp_dtype, pts, viewdirs, decode_sh=False)
    return rgb, 1 - torch.exp(-step_size * sigma)

  def _use_fused_mlp(self):
    """Whether _decode takes the fused MLP (K4/K5): the gate of
    samplenerfro_tpu/models/nerf.py:277-289 on the MLPs' real input
    widths. Its TPU-backend test has no counterpart: on CPU tensors the
    fused path runs the plain versions."""
    return (self.mlp_kernel in ("pallas", "pallas_pe") and self.use_viewdirs
            and self.sh_deg < 0 and not self.stage.startswith("all")
            and fused_ops.supports(*self.mlp_dims))

  def _fused_pe(self):
    """(pts_deg, dirs_deg) to encode the raw samples in the kernel, or None
    (samplenerfro_tpu/models/nerf.py:291-306): only for mlp_kernel
    pallas_pe with the plain non-legacy encodings from degree 0 (no IPE,
    no SH direction encoding)."""
    if (self.mlp_kernel == "pallas_pe" and not self.use_ipe
        and not self.legacy_posenc_order and self.min_deg_point == 0
        and self.sh_direnc_deg <= 0 and self.deg_view > 0
        and self.max_deg_point > 0):
      return (self.max_deg_point, self.deg_view)
    return None

  def _sh_decode(self, raw_rgb, dirs):
    """Raw SH coefficients [..., C (sh_deg + 1)^2] -> [..., C] at unit
    directions dirs [..., 3] (models/nerf.py:357-361)."""
    return sh_ops.eval_sh(
        self.sh_deg,
        raw_rgb.reshape(*raw_rgb.shape[:-1], -1, (self.sh_deg + 1)**2), dirs)

  def _decode(self, mlp, samples_enc, viewdirs_enc, randomized, generator,
              dtype, raw_pts=None, raw_dirs=None, decode_sh=True):
    """MLP eval + noise + SH decode + activations -> (rgb, sigma).

    raw_pts, raw_dirs: the raw [B, S, 3] samples and their directions, which
    the fused MLP encodes itself when _fused_pe() is set (samples_enc is
    then None); with sh_deg >= 0 the SH colour is decoded at raw_dirs
    unless decode_sh is False.
    """
    if self._use_fused_mlp():
      # Gradients reach the MLP's weights only, as in the JAX package: the
      # radiance stage's samples come from the frozen path sampler.
      pe = self._fused_pe()
      lead = raw_pts.shape[:-1]
      if pe is not None:
        x_in, c_in = raw_pts.reshape(-1, 3), raw_dirs.reshape(-1, 3)
      else:
        x_in = samples_enc.reshape(-1, samples_enc.shape[-1])
        c_in = viewdirs_enc.reshape(-1, viewdirs_enc.shape[-1])
      raw_rgb, raw_sigma = fused_ops.fused_nerf_mlp(mlp, x_in, c_in,
                                                    dtype=dtype, pe=pe)
      raw_rgb = raw_rgb.reshape(*lead, -1)
      raw_sigma = raw_sigma.reshape(*lead, -1)
    elif self.use_viewdirs:
      raw_rgb, raw_sigma = mlp(samples_enc, viewdirs_enc, dtype=dtype)
    else:
      raw_rgb, raw_sigma = mlp(samples_enc, dtype=dtype)
    raw_sigma = render_ops.add_gaussian_noise(raw_sigma, self.noise_std,
                                              randomized, generator)
    if self.sh_deg >= 0 and decode_sh:
      raw_rgb = self._sh_decode(raw_rgb, raw_dirs)
    rgb = self.rgb_activation(raw_rgb)
    rgb = rgb * (1 + 2 * self.rgb_padding) - self.rgb_padding
    sigma = self.sigma_activation(raw_sigma + self.sigma_bias)
    return rgb, sigma

  def _mask_bbox(self, pos):
    """[B, S] float mask of the samples inside the grid's box
    (samplenerfro_tpu/models/nerf.py:248-254)."""
    inside = torch.ones(pos.shape[:-1], dtype=torch.bool, device=pos.device)
    for a in range(3):
      inside = (inside & (pos[..., a] >= self.spec.nmin[a])
                & (pos[..., a] <= self.spec.nmax[a]))
    return inside.to(pos.dtype)

  def _bd_cut_mask(self, pos):
    """[B, S] float mask of the cut: 1 from a path's first sample inside
    cut_box to its end (a cumsum from the far side,
    samplenerfro_tpu/models/nerf.py:269-275)."""
    lo, hi = self.cut_box
    inside = torch.ones(pos.shape[:-1], dtype=torch.bool, device=pos.device)
    for a in range(3):
      inside = inside & (pos[..., a] >= lo[a]) & (pos[..., a] <= hi[a])
    kept = torch.cumsum(inside.flip(-1).to(torch.int32), dim=-1) > 0
    return kept.flip(-1).to(pos.dtype)

  @staticmethod
  def _online_sparsity(idx_grad, alpha):
    """The online sparsity term of one level: the mean of log alpha over
    the samples where |grad n| > 1e-6 (models/nerf.py:431-435). Under
    ranks, this rank's share of the global batch's term: its sum over
    the count of every rank's samples (parallel/mesh.global_sum)."""
    mask = torch.linalg.norm(idx_grad, dim=-1) > 1e-6
    return ((mask * math_ops.safe_log(alpha)).sum()
            / (mesh.global_sum(mask.sum()) + 1))

  def forward(self, rays, jitter, randomized=False, generator=None,
              annealed_alpha=1.0, mlp_dtype=None):
    """Render a batch of rays.

    Args:
      rays: Rays (data/rays.py) of [batch, ...] tensors on the model's device.
      jitter: [num_coarse] dense indices of the coarse subsample
        (make_jitter, on the host), or a march_kernel.CheckedJitter on the
        model's device.
      randomized: stratified fine sampling and density noise.
      generator: torch.Generator on the model's device for that noise.
      annealed_alpha: PE annealing progress of the so3 head ('all' stage),
        a float or a 0-d float32 tensor on the model's device.
      mlp_dtype: the radiance MLPs' compute type; None is the model's.

    Returns:
      (ret, loss_sp): ret is the list of per-level tuples (comp_rgb [B, 3],
      distance [B], acc [B], trans [B, 1], trans_rgb_bkgd [B, 3]), coarse
      then fine; loss_sp the online sparsity term (0.0 without
      use_online_sparsity), as the JAX model returns them.
    """
    dtype = self.mlp_dtype if mlp_dtype is None else mlp_dtype
    ray_pos, ray_dir, ray_dist, _, idx_grad, sub = self.path_sampler(
        rays.origins, rays.viewdirs, jitter, annealed_alpha)
    if sub is not None:
      ray_pos_c, ray_dir_c, ray_dist_c = sub
      idx_grad_c = None
    else:
      jitter = (jitter.indices
                if isinstance(jitter, march_kernel.CheckedJitter) else
                jitter.to(device=ray_pos.device, dtype=torch.int64,
                          non_blocking=True))
      ray_pos_c, ray_dir_c, ray_dist_c = (ray_pos[:, jitter],
                                          ray_dir[:, jitter],
                                          ray_dist[:, jitter])
      idx_grad_c = (idx_grad[:, jitter] if self.use_online_sparsity
                    else None)

    # With the in-kernel encoding the MLP takes the raw samples; the view
    # encoding still feeds the background MLP.
    encode = not (self._use_fused_mlp() and self._fused_pe() is not None)
    samples_enc = (self._featurize(ray_pos_c, ray_dir_c, ray_dist_c,
                                   rays.radii) if encode else None)
    mask_bbox = self._mask_bbox(ray_pos_c) if self.use_mask_bbox else None
    viewdirs_enc = self._encode_dirs(ray_dir_c)

    # Background colour from the exit direction of each path.
    raw_bkgd = self.bkgd_mlp(viewdirs_enc[:, -1:])[:, 0]
    if self.sh_deg >= 0:
      raw_bkgd = self._sh_decode(raw_bkgd[:, None], ray_dir_c[:, -1:])[:, 0]
    bkgd = self.rgb_activation(raw_bkgd)
    bkgd = bkgd * (1 + 2 * self.rgb_padding) - self.rgb_padding

    rgb, sigma = self._decode(self.coarse_mlp, samples_enc, viewdirs_enc,
                              randomized, generator, dtype, ray_pos_c,
                              ray_dir_c)
    comp_rgb, disp, acc, weights, alpha, trans, trans_rgb_bkgd = (
        render_ops.volumetric_rendering(rgb, sigma, ray_dist_c, ray_dir_c,
                                        self.white_bkgd, bkgd, mask_bbox))
    loss_sp = (self._online_sparsity(idx_grad_c, alpha)
               if self.use_online_sparsity else 0.0)
    ret = [(comp_rgb, disp, acc, trans, trans_rgb_bkgd)]

    if self.num_fine_samples > 0:
      mid = 0.5 * (ray_dist_c[..., 1:] + ray_dist_c[..., :-1])
      ray_dist_c, ray_pos_c, ray_dir_c, idx_grad_c = render_ops.sample_pdf(
          mid, weights[..., 1:-1], ray_pos, ray_dir, ray_dist,
          idx_grad if self.use_online_sparsity else None,
          self.num_fine_samples, randomized, jitter, self.near,
          z_coarse=ray_dist_c, generator=generator)
      samples_enc = (self._featurize(ray_pos_c, ray_dir_c, ray_dist_c,
                                     rays.radii) if encode else None)
      mask_bbox = self._mask_bbox(ray_pos_c) if self.use_mask_bbox else None
      viewdirs_enc = self._encode_dirs(ray_dir_c) if encode else None
      rgb, sigma = self._decode(self.fine_mlp, samples_enc, viewdirs_enc,
                                randomized, generator, dtype, ray_pos_c,
                                ray_dir_c)
      comp_rgb, disp, acc, _, alpha, trans, trans_rgb_bkgd = (
          render_ops.volumetric_rendering(rgb, sigma, ray_dist_c, ray_dir_c,
                                          self.white_bkgd, bkgd, mask_bbox))
      if self.cut_box is not None:
        # The boundary cut: transmittance through the cut's part of the
        # path alone, times the colour (with the background) of the part
        # before it; comp_rgb stays uncut.
        cut = self._bd_cut_mask(ray_pos_c)
        trans = render_ops.volumetric_rendering(
            rgb, sigma, ray_dist_c, ray_dir_c, self.white_bkgd, None,
            cut)[5]
        trans_rgb_bkgd = trans * render_ops.volumetric_rendering(
            rgb, sigma, ray_dist_c, ray_dir_c, self.white_bkgd, bkgd,
            1.0 - cut)[0]
      if self.use_online_sparsity and self.use_fine_sparsity:
        loss_sp = loss_sp + self._online_sparsity(idx_grad_c, alpha)
      ret.append((comp_rgb, disp, acc, trans, trans_rgb_bkgd))
    return ret, loss_sp


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
  """Build the NerfModel of args.stage.

  Builds what samplenerfro_tpu's construct_nerf builds and raises where it
  raises (its model init runs the forward, so a fault there raises while
  it constructs): SH colour with use_viewdirs, an SH degree past eval_sh's
  4 or dir_enc's 8, a VoxMLP interp_method other than linear3, an 'all'
  stage whose VoxMLP head has no branch, the boundary cut with
  use_mask_bbox. It raises ValueError for an unknown mlp_kernel or
  mlp_dtype, and NotImplementedError for a fused MLP with an activation
  other than ReLU (the fused kernels compute ReLU).

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
  mlp_kernel = getattr(args, "mlp_kernel", "xla")
  if mlp_kernel not in MLP_KERNELS:
    raise ValueError(f"mlp_kernel must be one of {MLP_KERNELS}, got "
                     f"{mlp_kernel!r}")
  if mlp_kernel != "xla" and args.net_activation != "relu":
    # The fused kernels, like the JAX package's, hard-code ReLU; the JAX
    # model would silently compute ReLU for another activation.
    raise NotImplementedError(f"mlp_kernel={mlp_kernel} computes ReLU; "
                              f"net_activation={args.net_activation!r} "
                              "needs mlp_kernel=xla")
  mlp_dtype = getattr(args, "mlp_dtype", "float32")
  if mlp_dtype not in ("float32", "bfloat16"):
    raise ValueError(f"mlp_dtype must be float32 or bfloat16, got "
                     f"{mlp_dtype!r}")

  net_activation = activation(args.net_activation)
  rgb_activation = activation(args.rgb_activation)
  sigma_activation = activation(args.sigma_activation)
  _check_activations(rgb_activation, sigma_activation,
                     (args.rgb_activation, args.sigma_activation))
  num_rgb_channels = args.num_rgb_channels
  if args.sh_deg >= 0:
    if args.use_viewdirs:
      raise ValueError("You can only use up to one of: SH or use_viewdirs.")
    if args.sh_deg > 4:
      raise ValueError(f"sh_deg {args.sh_deg}: SH colour is decoded up to "
                       "degree 4")
    num_rgb_channels *= (args.sh_deg + 1)**2
  if args.sh_direnc_deg > 8:
    raise ValueError(f"sh_direnc_deg {args.sh_direnc_deg}: the SH direction "
                     "encoding takes up to 8 bands")
  head = march_kernel.So3Head(
      annealed=bool(g.get("VoxMLP.annealed", True)),
      use_residual=bool(g.get("VoxMLP.use_residual", True)),
      use_direct_output=bool(g.get("VoxMLP.use_direct_output", True)),
      normalized=bool(g.get("VoxMLP.normalized", False)))

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
      num_rgb_channels=num_rgb_channels,
      num_sigma_channels=args.num_sigma_channels,
      white_bkgd=args.white_bkgd, min_deg_point=args.min_deg_point,
      max_deg_point=args.max_deg_point, deg_view=args.deg_view,
      rgb_activation=rgb_activation, sigma_activation=sigma_activation,
      legacy_posenc_order=args.legacy_posenc_order,
      mlp_dtype=getattr(torch, mlp_dtype), mlp_kernel=mlp_kernel,
      cfg_name=args.config, bd_cut_dist=g.get("NerfModel.bd_cut_dist"),
      use_fine_sparsity=bool(args.use_fine_sparsity),
      use_online_sparsity=bool(args.use_online_sparsity),
      sh_deg=args.sh_deg, sh_direnc_deg=args.sh_direnc_deg,
      use_ipe=bool(g.get("NerfModel.use_ipe", False)),
      use_mask_bbox=bool(g.get("NerfModel.use_mask_bbox", False)),
      head=head, interp_method=g.get("VoxMLP.interp_method", "linear3"),
      normal_radius_scale=float(g.get("PathSampler.normal_radius_scale",
                                      0.1)),
      generator=generator)
  return model.to(device).eval()
