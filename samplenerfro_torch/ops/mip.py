"""mip-NeRF integrated positional encoding along curved rays.

Counterpart of samplenerfro_tpu/ops/mip.py:19-108: each sample section of
a curved path is a Gaussian whose mean is the cumulative sum of direction
times arclength step (the refraction ray cone), encoded by the expected
sinusoids under it. `NerfModel.use_ipe` featurizes the radiance MLPs'
samples with it (models/nerf.py).
"""

import math

import torch

from samplenerfro_torch.ops import math as math_ops


def expected_sin(x, x_var):
  """Mean and variance of sin(z) for z ~ N(x, x_var)."""
  y = torch.exp(-0.5 * x_var) * math_ops.safe_sin(x)
  y_var = torch.clamp(
      0.5 * (1 - torch.exp(-2 * x_var) * math_ops.safe_cos(2 * x)) - y**2,
      min=0)
  return y, y_var


def lift_gaussian(d, t_mean, t_var, r_var, diag, near):
  """Lift per-section Gaussians onto a curved path.

  The mean is the cumulative sum along the path of each section's
  direction d [B, S, 3] times its arclength step (the first measured from
  `near`); the covariance spans t_var along d and r_var across it, as its
  diagonal [B, S, 3] (diag) or in full [B, S, 3, 3]. The full form
  broadcasts as the JAX package's does (d[..., :, None] * d), which
  takes one direction d [3] shared by every section and raises on a
  [B, S, 3] path.
  """
  t = torch.cat([t_mean[:, 0:1] - near, t_mean[:, 1:] - t_mean[:, :-1]],
                dim=-1)[..., None]
  mean = torch.cumsum(d * t, dim=1)
  d_mag_sq = torch.clamp((d**2).sum(dim=-1, keepdim=True), min=1e-10)
  if diag:
    d_outer_diag = d**2
    null_outer_diag = 1 - d_outer_diag / d_mag_sq
    return mean, (t_var[..., None] * d_outer_diag
                  + r_var[..., None] * null_outer_diag)
  d_outer = d[..., :, None] * d
  eye = torch.eye(d.shape[-1], dtype=d.dtype, device=d.device)
  null_outer = eye - d[..., :, None] * (d / d_mag_sq)
  cov = (t_var[..., None, None] * d_outer[..., None, :, :]
         + r_var[..., None, None] * null_outer[..., None, :, :])
  return mean, cov


def conical_frustum_to_gaussian(d, t0, t1, base_radius, diag, near,
                                stable=True):
  """Gaussian of the conical frustum between arclengths t0 and t1 of a
  cone of `base_radius` per unit length (mip-NeRF's stable or direct
  moments)."""
  if stable:
    mu = (t0 + t1) / 2
    hw = (t1 - t0) / 2
    t_mean = mu + (2 * mu * hw**2) / (3 * mu**2 + hw**2)
    t_var = (hw**2) / 3 - (4 / 15) * ((hw**4 * (12 * mu**2 - hw**2))
                                      / (3 * mu**2 + hw**2)**2)
    r_var = base_radius**2 * ((mu**2) / 4 + (5 / 12) * hw**2
                              - 4 / 15 * (hw**4) / (3 * mu**2 + hw**2))
  else:
    t_mean = (3 * (t1**4 - t0**4)) / (4 * (t1**3 - t0**3))
    r_var = base_radius**2 * (3 / 20 * (t1**5 - t0**5) / (t1**3 - t0**3))
    t_mosq = 3 / 5 * (t1**5 - t0**5) / (t1**3 - t0**3)
    t_var = t_mosq - t_mean**2
  return lift_gaussian(d, t_mean, t_var, r_var, diag, near)


def cylinder_to_gaussian(d, t0, t1, radius, diag, near):
  """Gaussian of the cylinder section between arclengths t0 and t1."""
  t_mean = (t0 + t1) / 2
  r_var = radius**2 / 4
  t_var = (t1 - t0)**2 / 12
  return lift_gaussian(d, t_mean, t_var, r_var, diag, near)


def cast_rays(t_vals, origins, directions, radii, ray_shape, near,
              diag=True):
  """The Gaussians of the sections between consecutive t_vals [B, S + 1].

  As the JAX package calls it (models/nerf.py:_featurize), `origins` is
  the [B, S, 3] sample positions, and only its first sample anchors the
  means (origins[:, 0:1] is added to the cumulative sum).
  """
  t0 = t_vals[..., :-1]
  t1 = t_vals[..., 1:]
  if ray_shape == "cone":
    gaussian_fn = conical_frustum_to_gaussian
  elif ray_shape == "cylinder":
    gaussian_fn = cylinder_to_gaussian
  else:
    raise ValueError(f"unknown ray_shape {ray_shape}")
  means, covs = gaussian_fn(directions, t0, t1, radii, diag, near)
  return means + origins[:, 0:1], covs


def integrated_pos_enc(x_coord, min_deg, max_deg, diag=True):
  """Expected [sin(y), sin(y + pi/2)] of the scaled means under their
  Gaussians, y = 2^[min_deg, max_deg) x: [..., 6 (max_deg - min_deg)]."""
  x, cov = x_coord
  if diag:
    scales = math_ops.pe_scales(min_deg, max_deg, x.dtype, x.device)
    shape = list(x.shape[:-1]) + [-1]
    y = (x[..., None, :] * scales[:, None]).reshape(shape)
    y_var = (cov[..., None, :] * scales[:, None]**2).reshape(shape)
  else:
    num_dims = x.shape[-1]
    basis = torch.cat([2.0**i * torch.eye(num_dims, dtype=x.dtype,
                                          device=x.device)
                       for i in range(min_deg, max_deg)], dim=1)
    y = x @ basis
    y_var = ((cov @ basis) * basis).sum(dim=-2)
  return expected_sin(torch.cat([y, y + 0.5 * math.pi], dim=-1),
                      torch.cat([y_var] * 2, dim=-1))[0]
