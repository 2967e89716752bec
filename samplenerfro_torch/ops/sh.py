"""Real spherical harmonics: radiance decoding and direction encoding.

Counterpart of samplenerfro_tpu/ops/sh.py:22-122. The basis comes from
the semi-normalized associated-Legendre recurrence with the
Condon-Shortley phase, ordered (l, m = -l..l); `eval_sh` decodes SH
radiance coefficients (`sh_deg >= 0`), `dir_enc` encodes view directions
(`sh_direnc_deg > 0`), both on unit directions.
"""

import math

import numpy as np
import torch


def _k_norm(l, m):
  """SH normalization K(l, m) = sqrt((2l+1)/(4pi) * (l-m)!/(l+m)!)."""
  return math.sqrt((2 * l + 1) / (4 * math.pi)
                   * math.factorial(l - m) / math.factorial(l + m))


def sh_basis(num_bands, dirs):
  """The real SH basis of bands l = 0..num_bands-1 at dirs [..., 3]:
  [..., num_bands**2], ordered (l, m = -l..l)."""
  x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]

  # Azimuthal polynomials: A_m = Re((x+iy)^m), B_m = Im((x+iy)^m).
  a = [torch.ones_like(x)]
  b = [torch.zeros_like(x)]
  for m in range(1, num_bands):
    a.append(x * a[m - 1] - y * b[m - 1])
    b.append(x * b[m - 1] + y * a[m - 1])

  # Semi-normalized associated Legendre p[l][m] = P_l^m(z) / (1-z^2)^(m/2),
  # the Condon-Shortley phase included: p[m][m] = (-1)^m (2m-1)!!.
  p = [[None] * num_bands for _ in range(num_bands)]
  for m in range(num_bands):
    pmm = ((-1.0)**m) * float(np.prod(np.arange(1, 2 * m, 2),
                                      dtype=np.float64) or 1.0)
    p[m][m] = torch.full_like(z, pmm)
    if m + 1 < num_bands:
      p[m + 1][m] = (2 * m + 1) * z * p[m][m]
    for l in range(m + 2, num_bands):
      p[l][m] = ((2 * l - 1) * z * p[l - 1][m]
                 - (l + m - 1) * p[l - 2][m]) / (l - m)

  out = []
  sqrt2 = math.sqrt(2.0)
  for l in range(num_bands):
    for m in range(-l, l + 1):
      am = abs(m)
      k = _k_norm(l, am)
      if m == 0:
        out.append(k * p[l][0])
      elif m < 0:
        out.append(sqrt2 * k * p[l][am] * b[am])
      else:
        out.append(sqrt2 * k * p[l][am] * a[am])
  return torch.stack(out, dim=-1)


def eval_sh(deg, sh, dirs):
  """Decode SH coefficients sh [..., C, (deg+1)**2] (0 <= deg <= 4) at
  unit directions dirs [..., 3]: [..., C]."""
  if not 0 <= deg <= 4:
    raise ValueError(f"eval_sh takes degrees 0 to 4, got {deg}")
  if (deg + 1)**2 != sh.shape[-1]:
    raise ValueError(f"eval_sh: degree {deg} needs {(deg + 1)**2} "
                     f"coefficients, got {sh.shape[-1]}")
  basis = sh_basis(deg + 1, dirs)
  return torch.einsum("...ck,...k->...c", sh, basis)


def dir_enc(data_in, sh_degree):
  """SH encoding of unit view directions [..., 3] with sh_degree bands
  (1 to 8): [..., sh_degree**2]."""
  if not 1 <= sh_degree <= 8:
    raise ValueError(f"dir_enc takes 1 to 8 bands, got {sh_degree}")
  return sh_basis(sh_degree, data_in)


def cosine_easing_factor(band, alpha):
  """Per-band annealing factor 0.5 (1 + cos(pi clip(alpha - band, 0, 1)
  + pi))."""
  x = torch.clamp(torch.as_tensor(alpha) - band, 0.0, 1.0)
  return 0.5 * (1 + torch.cos(math.pi * x + math.pi))


def annealed_dir_enc(data_in, sh_degree, alpha):
  """dir_enc with band l scaled by cosine_easing_factor(l, alpha), the
  factor on the whole basis term (samplenerfro_tpu/ops/sh.py:110-122)."""
  basis = dir_enc(data_in, sh_degree)
  bands = np.concatenate([np.full(2 * l + 1, l) for l in range(sh_degree)])
  factors = cosine_easing_factor(
      torch.as_tensor(bands, dtype=basis.dtype, device=basis.device), alpha)
  return basis * factors
