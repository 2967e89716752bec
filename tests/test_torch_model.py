"""The whole render slice: the port's NerfModel against the JAX NerfModel.

Same weights (carried by models/convert.params_from_flax), same 64^3 blob
grid, same 256 coherent rays and the same jitter (rebuilt from the JAX
model's rng exactly as models/nerf.py:382-392 draws it). randomized=False
and noise_std=None, so nothing else is random. Both levels of every output
are compared at atol=rtol=1e-4. The march agrees to ~1e-6 and the two CPU
backends sum the fp32 MLP products in different orders, so the coarse
level agrees to ~1e-5. The fine level amplifies that: its samples are
placed by the coarse weights and encoded at up to 2^9 rad per unit, so a
1e-6 shift of a fine sample moves its features by ~5e-4. Measured here:
coarse <= 1.2e-5, fine <= 1.4e-4 on distance (~4, within the rtol term)
and 1.0e-4 on acc, the same with 1, 3 or 8 threads. A wrong layer,
concat order or activation moves outputs by far more.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from samplenerfro_torch import resolve_device
from samplenerfro_torch.data.rays import Rays as TRays
from samplenerfro_torch.models import convert
from samplenerfro_torch.models import nerf as t_nerf
from samplenerfro_torch.utils import grid_io
from samplenerfro_tpu.data.rays import Rays as JRays
from samplenerfro_tpu.models import construct_nerf
from tests import helpers

ATOL = RTOL = 1e-4
NRAYS = 256


def _rays():
  side = int(np.sqrt(NRAYS))
  d = np.array([[0.004 * (i % side), 0.003 * (i // side), 1.0]
                for i in range(NRAYS)], np.float32)
  d /= np.linalg.norm(d, axis=-1, keepdims=True)
  o = np.broadcast_to(np.array([0.1, -0.05, -4.0], np.float32), d.shape).copy()
  radii = np.full((NRAYS, 1), 1e-3, np.float32)
  return o, d, radii


def _args(march_mode):
  return helpers.tiny_args(
      randomized=False, march_mode=march_mode, march_emit="lean",
      tile_size=16, march_window=16, march_refetch=8, net_depth=6,
      net_width=32, num_coarse_samples=8, num_path_samples=4,
      num_fine_samples=16, stage="radiance")


def _jax_jitter(rng_0, args):
  key, _ = random.split(rng_0)
  jitter = jnp.arange(0, args.num_coarse_samples * args.num_path_samples,
                      args.num_path_samples)
  return jitter + random.randint(key, [args.num_coarse_samples], minval=0,
                                 maxval=args.num_path_samples)


@pytest.mark.parametrize("march_mode", ["pallas", "scan"])
def test_render_slice_matches_jax(march_mode):
  args = _args(march_mode)
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(64, 1.5, 0.33)
  o, d, radii = _rays()
  jrays = JRays(*map(jnp.asarray, (o, d, d, radii)))
  model, variables = construct_nerf(random.PRNGKey(0), {"rays": jrays}, args,
                                    ndim, nmin, nmax, values)
  rng_0, rng_1 = random.PRNGKey(1), random.PRNGKey(2)
  (ret, _), diag = model.apply(variables, rng_0, rng_1, jrays, False,
                               mutable=["diagnostics"])
  oow = diag.get("diagnostics", {}).get("path_sampler", {}).get("march_oow")
  assert oow is None or int(np.sum(oow)) == 0, "JAX march clamped"

  port = t_nerf.construct_nerf(args, ndim, nmin, nmax, values, device="cpu")
  params = jax.tree_util.tree_map(np.asarray, variables["params"])
  convert.load_into(port, convert.params_from_flax(params))
  jitter = torch.from_numpy(np.array(_jax_jitter(rng_0, args)))
  trays = TRays(*map(torch.from_numpy, (o, d, d, radii)))
  with torch.no_grad():
    got, loss_sp = port(trays, jitter, randomized=False)

  assert loss_sp == 0.0  # no online sparsity, as in the JAX model
  assert len(got) == len(ret) == 2
  names = ("comp_rgb", "distance", "acc", "trans", "trans_rgb_bkgd")
  for level, (g_level, w_level) in enumerate(zip(got, ret)):
    for name, g, w in zip(names, g_level, w_level):
      np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                 rtol=RTOL, err_msg=f"level {level} {name}")


def test_weights_round_trip_through_npz(tmp_path):
  args = _args("scan")
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(8, 1.5, 0.33)
  a = t_nerf.construct_nerf(args, ndim, nmin, nmax, values, device="cpu",
                            seed=1)
  b = t_nerf.construct_nerf(args, ndim, nmin, nmax, values, device="cpu",
                            seed=2)
  tree = convert.params_to_flax(a)
  assert sorted(tree["path_sampler"]["so3_mlp"]) == [
      "Dense_0", "Dense_1", "Dense_2", "Dense_3", "Dense_out"]
  assert tree["path_sampler"]["so3_mlp"]["Dense_3"]["kernel"].shape == (
      188, 128)
  np.savez(tmp_path / "w.npz", **convert.flatten({"params": tree}))
  convert.load_into(b, convert.params_from_npz(tmp_path / "w.npz"))
  keys = [k for k in a.state_dict() if k != "path_sampler.grid"]
  assert any(k.startswith("path_sampler.so3_mlp.") for k in keys)
  for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                b.state_dict().items()):
    assert ka == kb and torch.equal(va, vb), ka
  with pytest.raises(ValueError, match="missing"):
    convert.load_into(b, {})


def test_seeded_weights_are_deterministic():
  args = _args("scan")
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(8, 1.5, 0.33)
  build = lambda seed: t_nerf.construct_nerf(args, ndim, nmin, nmax, values,
                                             device="cpu", seed=seed)
  w = lambda m: m.coarse_mlp.layers[0].weight
  assert torch.equal(w(build(3)), w(build(3)))
  assert not torch.equal(w(build(3)), w(build(4)))


def test_unported_options_raise():
  """The port raises where the JAX package raises, and only there: the
  options JAX implements build in both (online sparsity, SH colour, IPE),
  and what neither implements raises NotImplementedError in both (a
  VoxMLP interp_method other than linear3; in the 'all' stage, a
  normalized head with the residual). tests/test_torch_options.py and
  tests/test_torch_heads.py hold the rest of the shared raises."""
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(8, 1.5, 0.33)
  o, d, radii = (x[:4] for x in _rays())
  jrays = JRays(*map(jnp.asarray, (o, d, d, radii)))
  cases = (({"use_online_sparsity": True}, {}, None),
           ({"sh_deg": 2, "use_viewdirs": False}, {}, None),
           ({}, {"NerfModel.use_ipe": True}, None),
           ({}, {"VoxMLP.interp_method": "nearest"}, NotImplementedError),
           ({"stage": "all"}, {"VoxMLP.normalized": True},
            NotImplementedError))
  for override, binding, raises in cases:
    args = _args("scan")
    for k, v in override.items():
      setattr(args, k, v)
    build = (lambda: construct_nerf(random.PRNGKey(0), {"rays": jrays}, args,
                                    ndim, nmin, nmax, values, binding),
             lambda: t_nerf.construct_nerf(args, ndim, nmin, nmax, values,
                                           binding, device="cpu"))
    for fn in build:
      if raises is None:
        fn()
      else:
        with pytest.raises(raises):
          fn()


def test_make_jitter_bins():
  jitter = t_nerf.make_jitter(64, 12, torch.Generator().manual_seed(0))
  base = torch.arange(0, 768, 12)
  assert jitter.shape == (64,)
  assert bool(((jitter >= base) & (jitter < base + 12)).all())


def test_resolve_device():
  assert resolve_device("cpu") == torch.device("cpu")
  if torch.cuda.is_available():
    assert resolve_device().type == "cuda"
  else:
    # No silent fallback: asking for nothing means CUDA, which is absent.
    with pytest.raises(RuntimeError, match="CUDA"):
      resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
      resolve_device("cuda")
