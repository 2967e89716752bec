"""The port's ops (samplenerfro_torch.ops) against samplenerfro_tpu.ops.

Same numpy inputs into both; fp32 on the CPU. Tolerance 1e-5 absolute:
the two frameworks round transcendental functions and sums differently by
a few ulp, which stays far below it at these magnitudes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samplenerfro_torch.ops import grid as t_grid
from samplenerfro_torch.ops import math as t_math
from samplenerfro_torch.ops import render as t_render
from samplenerfro_tpu.ops import grid as j_grid
from samplenerfro_tpu.ops import math as j_math
from samplenerfro_tpu.ops import render as j_render

ATOL = 1e-5


def _close(t, j, atol=ATOL):
  np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


@pytest.mark.parametrize("legacy", [False, True])
def test_pos_enc(legacy):
  x = np.random.RandomState(0).randn(4, 7, 3).astype(np.float32)
  _close(t_math.pos_enc(torch.from_numpy(x), 0, 10, legacy),
         j_math.pos_enc(jnp.asarray(x), 0, 10, legacy_posenc_order=legacy))
  _close(t_math.pos_enc(torch.from_numpy(x), 2, 4, legacy),
         j_math.pos_enc(jnp.asarray(x), 2, 4, legacy_posenc_order=legacy))


def test_safe_ops():
  x = np.random.RandomState(1).randn(5, 3).astype(np.float32)
  x[0] = 0.0
  _close(t_math.safe_l2_normalize(torch.from_numpy(x)),
         j_math.safe_l2_normalize(jnp.asarray(x)))
  _close(t_math.safe_log(torch.from_numpy(x)), j_math.safe_log(jnp.asarray(x)))


def _spec_and_values(n=9):
  spec_args = ([n, n + 1, n + 2], [-1.0, -1.5, -0.5], [1.0, 1.5, 2.0])
  vals = np.random.RandomState(2).rand(n * (n + 1) * (n + 2), 4)
  return spec_args, vals.astype(np.float32)


def test_trilinear_clamp_to_edge():
  spec_args, vals = _spec_and_values()
  # Points inside, on the faces and well outside the box.
  pts = np.random.RandomState(3).uniform(-3, 3, (64, 5, 3)).astype(np.float32)
  got = t_grid.trilinear(t_grid.GridSpec(*spec_args), torch.from_numpy(vals),
                         torch.from_numpy(pts))
  want = j_grid.trilinear(j_grid.GridSpec(*spec_args), jnp.asarray(vals),
                          jnp.asarray(pts))
  assert got.shape == (64, 5, 4)
  _close(got, want)


def test_central_difference_grad():
  spec_args, vals = _spec_and_values()
  got = t_grid.central_difference_grad(t_grid.GridSpec(*spec_args),
                                       torch.from_numpy(vals[:, :1]))
  want = j_grid.central_difference_grad_numpy(j_grid.GridSpec(*spec_args),
                                              vals[:, :1])
  _close(got, want)
  np.testing.assert_array_equal(
      t_grid.central_difference_grad_numpy(t_grid.GridSpec(*spec_args),
                                           vals[:, :1]), want)


def test_gaussian_prefilter():
  n = 12
  vals = np.random.RandomState(4).rand(n**3, 1).astype(np.float32)
  got = t_grid.gaussian_prefilter(torch.from_numpy(vals), (n, n, n), 5, 1.5)
  want = j_grid.gaussian_prefilter(jnp.asarray(vals), (n, n, n), 5, 1.5)
  assert got.shape == (n**3, 1)
  _close(got, want)


def test_volumetric_rendering():
  rng = np.random.RandomState(5)
  b, s = 16, 24
  rgb = rng.rand(b, s, 3).astype(np.float32)
  density = (rng.rand(b, s, 1) * 3).astype(np.float32)
  density[0] = 0.0  # acc = 0: distance goes through nan -> clipped
  t_vals = np.sort(rng.uniform(2, 6, (b, s)), axis=-1).astype(np.float32)
  dirs = rng.randn(b, s, 3).astype(np.float32)
  bkgd = rng.rand(b, 3).astype(np.float32)
  for white, bg in ((False, bkgd), (True, None)):
    got = t_render.volumetric_rendering(
        *map(torch.from_numpy, (rgb, density, t_vals, dirs)), white,
        None if bg is None else torch.from_numpy(bg))
    want = j_render.volumetric_rendering(
        *map(jnp.asarray, (rgb, density, t_vals, dirs)), white,
        None if bg is None else jnp.asarray(bg))
    for g, w in zip(got, want):
      _close(g, w)


def test_sorted_piecewise_constant_pdf_deterministic():
  rng = np.random.RandomState(6)
  bins = np.sort(rng.uniform(2, 6, (8, 17)), axis=-1).astype(np.float32)
  weights = rng.rand(8, 16).astype(np.float32)
  weights[0] = 0.0  # degenerate pdf: eps padding
  got = t_render.sorted_piecewise_constant_pdf(
      torch.from_numpy(bins), torch.from_numpy(weights), 32, False)
  want = j_render.sorted_piecewise_constant_pdf(
      None, jnp.asarray(bins), jnp.asarray(weights), 32, False)
  _close(got, want)


def _path(b=6, s=40, m=20, seed=7):
  rng = np.random.RandomState(seed)
  dist = np.cumsum(rng.uniform(0.05, 0.2, (b, s)), axis=-1) + 2.0
  pos = rng.randn(b, s, 3)
  dirs = rng.randn(b, s, 3)
  grad = rng.randn(b, s, 3)
  # Samples below, inside and beyond the path, some exactly on vertices.
  z = np.sort(rng.uniform(1.5, dist[:, -1:] + 0.5, (b, m)), axis=-1)
  z[:, 3] = dist[:, 5]
  return [a.astype(np.float32) for a in (z, pos, dirs, dist, grad)]


@pytest.mark.parametrize("method", ["gather", "two_level"])
def test_reanchor_on_path(method):
  z, pos, dirs, dist, grad = _path()
  got = t_render.reanchor_on_path(*map(torch.from_numpy,
                                       (z, pos, dirs, dist, grad)))
  want = j_render.reanchor_on_path(*map(jnp.asarray,
                                        (z, pos, dirs, dist, grad)),
                                   method=method)
  for g, w in zip(got, want):
    _close(g, w)
  got_lean = t_render.reanchor_on_path(
      *map(torch.from_numpy, (z, pos, dirs, dist)), None)
  assert got_lean[2] is None
  _close(got_lean[0], want[0])


def test_sample_pdf():
  rng = np.random.RandomState(8)
  b, s, nc, nf = 5, 48, 12, 16
  _, pos, dirs, dist, _ = _path(b, s)
  jitter = (np.arange(0, s, s // nc) + rng.randint(0, s // nc, nc))
  z_coarse = dist[:, jitter]
  mid = 0.5 * (z_coarse[:, 1:] + z_coarse[:, :-1])
  weights = rng.rand(b, nc - 2).astype(np.float32)
  got = t_render.sample_pdf(
      torch.from_numpy(mid), torch.from_numpy(weights),
      *map(torch.from_numpy, (pos, dirs, dist)), None, nf, False,
      torch.from_numpy(jitter), 2.0)
  want = j_render.sample_pdf(
      None, jnp.asarray(mid), jnp.asarray(weights),
      *map(jnp.asarray, (pos, dirs, dist)), None, nf, False,
      jnp.asarray(jitter), 2.0)
  assert got[0].shape == (b, nc + nf)
  for g, w in zip(got[:3], want[:3]):
    _close(g, w)


def test_randomized_draws_use_the_generator():
  bins = torch.linspace(2, 6, 9).expand(3, 9).contiguous()
  weights = torch.ones(3, 8)
  draw = lambda seed: t_render.sorted_piecewise_constant_pdf(
      bins, weights, 16, True, torch.Generator().manual_seed(seed))
  torch.testing.assert_close(draw(1), draw(1), rtol=0, atol=0)
  assert not torch.equal(draw(1), draw(2))
  raw = torch.zeros(4, 1)
  noisy = t_render.add_gaussian_noise(raw, 1.0, True,
                                      torch.Generator().manual_seed(0))
  assert noisy.abs().sum() > 0
  assert torch.equal(t_render.add_gaussian_noise(raw, 1.0, False), raw)
