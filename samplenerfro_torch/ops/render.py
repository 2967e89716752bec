"""Volume rendering and hierarchical sampling along curved ray paths.

Counterpart of samplenerfro_tpu/ops/render.py. The re-anchor on the dense
path is the `method="gather"` form: a batched searchsorted plus a row
gather (the JAX package's `two_level` form is a TPU matrix-unit workaround
with the same result).
"""

import torch


def volumetric_rendering(rgb, density, t_vals, dirs, white_bkgd, rgb_bkgd,
                         mask_bbox=None):
  """Exponential-transmittance compositing along (possibly curved) rays.

  Args:
    rgb: [batch, S, 3] sample colors.
    density: [batch, S, 1] sample densities.
    t_vals: [batch, S] arclength parameters along the path.
    dirs: [batch, S, 3] per-sample ray directions.
    white_bkgd: composite white behind everything.
    rgb_bkgd: [batch, 3] background color or None.
    mask_bbox: optional [batch, S] multiplicative density mask.

  Returns:
    (comp_rgb, distance, acc, weights, alpha, trans_last,
     trans_last * bkgd), as samplenerfro_tpu/ops/render.py:20-68.
  """
  t_dists = torch.cat([
      t_vals[..., 1:] - t_vals[..., :-1],
      torch.full_like(t_vals[..., :1], 1e-3),
  ], dim=-1)
  delta = t_dists * torch.linalg.norm(dirs, dim=-1)
  density_delta = density[..., 0] * delta
  if mask_bbox is not None:
    density_delta = density_delta * mask_bbox

  alpha = 1 - torch.exp(-density_delta)
  trans = torch.exp(-torch.cat([
      torch.zeros_like(density_delta[..., :1]),
      torch.cumsum(density_delta, dim=-1),
  ], dim=-1))
  weights = alpha * trans[..., :-1]

  if rgb_bkgd is not None:
    comp_rgb = (weights[..., None] * rgb).sum(dim=-2) + trans[..., -1:] * rgb_bkgd
  else:
    comp_rgb = (weights[..., None] * rgb).sum(dim=-2)
    rgb_bkgd = torch.ones(list(trans.shape[:-1]) + [3], dtype=rgb.dtype,
                          device=rgb.device)
  acc = weights.sum(dim=-1)
  distance = (weights * t_vals).sum(dim=-1) / acc
  distance = torch.clamp(torch.nan_to_num(distance, nan=float("inf")),
                         t_vals[:, 0], t_vals[:, -1])
  if white_bkgd:
    comp_rgb = comp_rgb + (1.0 - acc[..., None])
  return (comp_rgb, distance, acc, weights, alpha, trans[..., -1:],
          trans[..., -1:] * rgb_bkgd.detach())


def sorted_piecewise_constant_pdf(bins, weights, num_samples, randomized,
                                  generator=None):
  """Inverse-CDF sampling from a piecewise-constant PDF over sorted bins.

  As samplenerfro_tpu/ops/render.py:71-112; `generator` (a
  torch.Generator on the device of `bins`) draws the stratified offsets
  when `randomized`.
  """
  eps = 1e-5
  f32_eps = torch.finfo(torch.float32).eps
  weight_sum = weights.sum(dim=-1, keepdim=True)
  padding = torch.clamp(eps - weight_sum, min=0)
  weights = weights + padding / weights.shape[-1]
  weight_sum = weight_sum + padding

  pdf = weights / weight_sum
  cdf = torch.clamp(torch.cumsum(pdf[..., :-1], dim=-1), max=1)
  lead = list(cdf.shape[:-1])
  cdf = torch.cat([
      torch.zeros(lead + [1], dtype=cdf.dtype, device=cdf.device), cdf,
      torch.ones(lead + [1], dtype=cdf.dtype, device=cdf.device),
  ], dim=-1)

  if randomized:
    s = 1 / num_samples
    u = torch.arange(num_samples, dtype=cdf.dtype, device=cdf.device) * s
    u = u + torch.rand(lead + [num_samples], generator=generator,
                       dtype=cdf.dtype, device=cdf.device) * (s - f32_eps)
    u = torch.clamp(u, max=1.0 - f32_eps)
  else:
    u = torch.linspace(0.0, 1.0 - f32_eps, num_samples, dtype=cdf.dtype,
                       device=cdf.device)
    u = u.expand(lead + [num_samples])

  mask = u[..., None, :] >= cdf[..., :, None]

  def find_interval(x):
    x0 = torch.where(mask, x[..., None], x[..., :1, None]).amax(dim=-2)
    x1 = torch.where(~mask, x[..., None], x[..., -1:, None]).amin(dim=-2)
    return x0, x1

  bins_g0, bins_g1 = find_interval(bins)
  cdf_g0, cdf_g1 = find_interval(cdf)

  t = torch.clamp(torch.nan_to_num((u - cdf_g0) / (cdf_g1 - cdf_g0), nan=0.0),
                  0, 1)
  return bins_g0 + t * (bins_g1 - bins_g0)


def reanchor_on_path(z_samples, path_pos, path_dir, path_dist, path_grad):
  """Re-anchor arclength samples onto a densely marched curved path.

  For each sample arclength z, take the last path vertex k with
  path_dist[k] < z (clipped to [0, S-1]) and extrapolate along its
  direction: pos = path_pos[k] + path_dir[k] * (z - path_dist[k])
  (samplenerfro_tpu/ops/render.py:194-209, method="gather").

  Args:
    z_samples: [batch, M] sorted arclengths.
    path_pos, path_dir: [batch, S, 3] dense path vertices and directions.
    path_dist: [batch, S] per-vertex cumulative arclength.
    path_grad: [batch, S, 3] per-vertex IOR gradients, or None.

  Returns:
    (pos, dirs, grads): [batch, M, 3] each; grads is None when path_grad is.
  """
  s = path_dist.shape[-1]
  idx = torch.searchsorted(path_dist.contiguous(), z_samples.contiguous(),
                           side="left")
  idx = torch.clamp(idx - 1, 0, s - 1)
  take = lambda a: torch.gather(
      a, 1, idx[..., None].expand(-1, -1, a.shape[-1]))
  anchor, rd = take(path_pos), take(path_dir)
  anchor_t = torch.gather(path_dist, 1, idx)
  grads = take(path_grad) if path_grad is not None else None
  pos = anchor + rd * (z_samples - anchor_t)[..., None]
  return pos, rd, grads


def sample_pdf(bins, weights, path_pos, path_dir, path_dist, path_grad,
               num_samples, randomized, jitter, near, z_coarse=None,
               generator=None):
  """Hierarchical sampling along a curved path.

  Draws `num_samples` fine arclengths from the coarse weight PDF, merges
  them with the coarse arclengths, sorts, and re-anchors every sample on
  the dense path (samplenerfro_tpu/ops/render.py:212-250). The result
  carries no gradient, as there.

  Returns:
    (z_vals, pos, dirs, grads): [batch, Nc+num_samples(, 3)].
  """
  del near
  with torch.no_grad():
    z_samples = sorted_piecewise_constant_pdf(bins, weights, num_samples,
                                              randomized, generator)
    if z_coarse is None:
      z_coarse = path_dist[:, jitter]
    z_samples = torch.sort(torch.cat([z_coarse, z_samples], dim=-1),
                           dim=-1).values
    pos, dirs, grads = reanchor_on_path(z_samples, path_pos, path_dir,
                                        path_dist, path_grad)
  return z_samples, pos, dirs, grads


def add_gaussian_noise(raw, noise_std, randomized, generator=None):
  """Optional density-noise regularizer (ops/render.py:253-257)."""
  if (noise_std is not None) and randomized:
    return raw + torch.randn(raw.shape, generator=generator, dtype=raw.dtype,
                             device=raw.device) * noise_std
  return raw
