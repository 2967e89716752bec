"""K1 (samplenerfro_torch.ops.march_kernel) against the JAX marchers.

The plain version runs here on the CPU; it is held against the fused
Pallas march in interpret mode and against ops/eikonal.march plus the
jitter gather, on a 64^3 blob grid with 256 coherent rays, 32 steps and
4 path samples per coarse bin (the shapes of tests/test_pallas_march.py).
The two JAX paths agree to ~2e-6 here; atol 1e-5 leaves room for the
frameworks' different rounding of the same fp32 arithmetic.
The CUDA kernel itself runs only on a card (tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samplenerfro_torch.ops import eikonal as t_eik
from samplenerfro_torch.ops import grid as t_grid
from samplenerfro_torch.ops import march_kernel as t_march
from samplenerfro_torch.utils import grid_io
from samplenerfro_tpu.ops import eikonal as j_eik
from samplenerfro_tpu.ops import grid as j_grid
from samplenerfro_tpu.ops.pallas import march_kernel as j_march

ATOL = 1e-5
S, NUM_PATH, NEAR, FAR = 32, 4, 2.0, 6.0
H = (FAR - NEAR) / (S - 1)


def _setup(nrays=256, n=64):
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(n, 1.5, 0.33)
  spec = j_grid.GridSpec(ndim, nmin, nmax)
  data = np.concatenate(
      [values, j_grid.central_difference_grad_numpy(spec, values)], axis=-1)
  side = int(np.sqrt(nrays))
  d = np.array([[0.004 * (i % side), 0.003 * (i // side), 1.0]
                for i in range(nrays)], np.float32)
  d /= np.linalg.norm(d, axis=-1, keepdims=True)
  o = np.broadcast_to(np.array([0.1, -0.05, -4.0], np.float32), d.shape).copy()
  rng = np.random.RandomState(1)
  jitter = (np.arange(0, S, NUM_PATH)
            + rng.randint(0, NUM_PATH, S // NUM_PATH)).astype(np.int32)
  tspec = t_grid.GridSpec(ndim, nmin, nmax)
  return spec, tspec, data.astype(np.float32), o, d, jitter


def _port(tspec, data, o, d, jitter):
  return t_march.march_lean(tspec, torch.from_numpy(data), torch.from_numpy(o),
                            torch.from_numpy(d), NEAR, H, S,
                            torch.from_numpy(jitter))


def _assert_close(got, want):
  names = ("pos", "dir", "dist", "sub_pos", "sub_dir", "sub_dist")
  for name, g, w in zip(names, got, want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0,
                               err_msg=name)


def test_plain_k1_matches_pallas_lean_interpret():
  spec, tspec, data, o, d, jitter = _setup()
  want = j_march.march_tiled_pallas_lean(
      spec, jnp.asarray(data), jnp.asarray(o), jnp.asarray(d), NEAR, H, S,
      jnp.asarray(jitter), block_size=256, window=16, refetch_every=8,
      interpret=True)
  assert int(want[6]) == 0, "the Pallas window clamped; results inexact"
  _assert_close(_port(tspec, data, o, d, jitter), want[:6])


def test_plain_k1_matches_eikonal_march():
  spec, tspec, data, o, d, jitter = _setup()
  pos, dirs, dist, n, g = j_eik.march(spec, jnp.asarray(data),
                                      jnp.asarray(o), jnp.asarray(d), NEAR,
                                      H, S)
  want = (pos, dirs, dist, pos[:, jitter], dirs[:, jitter], dist[:, jitter])
  _assert_close(_port(tspec, data, o, d, jitter), want)
  # The full plain march also carries n and grad n along the path.
  t_out = t_eik.march(tspec, torch.from_numpy(data), torch.from_numpy(o),
                      torch.from_numpy(d), NEAR, H, S)
  np.testing.assert_allclose(t_out[3].numpy(), np.asarray(n), atol=ATOL)
  np.testing.assert_allclose(t_out[4].numpy(), np.asarray(g), atol=ATOL)


def test_cpu_tensors_take_the_plain_version():
  _, tspec, data, o, d, jitter = _setup(nrays=16, n=16)
  before = t_march.march_lean.launches
  got = _port(tspec, data, o, d, jitter)
  want = t_march.march_lean_reference(
      tspec, torch.from_numpy(data), torch.from_numpy(o), torch.from_numpy(d),
      NEAR, H, S, torch.from_numpy(jitter))
  assert t_march.march_lean.launches == before
  for g, w in zip(got, want):
    assert torch.equal(g, w)


def test_bad_jitter_is_rejected():
  # The check runs before any launch, so it is exercised on the CPU too.
  _, tspec, data, o, d, _ = _setup(nrays=4, n=8)
  bad = torch.arange(0, S, NUM_PATH) + NUM_PATH  # one bin too far
  with pytest.raises(ValueError, match="jitter"):
    t_march._check_inputs(tspec, torch.from_numpy(data), torch.from_numpy(o),
                          torch.from_numpy(d), S, bad)
  with pytest.raises(ValueError, match="multiple"):
    t_march._check_inputs(tspec, torch.from_numpy(data), torch.from_numpy(o),
                          torch.from_numpy(d), S + 1,
                          torch.arange(0, S, NUM_PATH))
