"""The port's mesh-extraction slice against the JAX package's.

K2 with the so3 head off (ops/march_kernel.march_full_plain): its plain
version here on the CPU against the fused Pallas march in interpret mode
(march_tiled_pallas with so3_params=None) and against ops/eikonal.march,
at K1's tolerance (tests/test_torch_march.py: the two JAX paths agree to
~2e-6). NerfModel.sample_points against the JAX model's with the same
weights (models/convert.py) at 1e-5, through nn.Linear and the fused MLP's
plain version. The `extract_mesh` entry points of both packages on a tiny
scene with the same weights: the path dump at 1e-4 (the march's ulps over
the debug view's longer chain), the density grid at 1e-5, the same files.
Then eval's depth images. The CUDA kernel itself runs only on a card
(tests/test_torch_cuda.py).
"""

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from samplenerfro_torch import eval as t_eval
from samplenerfro_torch import extract_mesh as t_extract
from samplenerfro_torch.models import convert
from samplenerfro_torch.models import nerf as t_nerf
from samplenerfro_torch.ops import grid as t_grid
from samplenerfro_torch.ops import march_kernel as t_march
from samplenerfro_torch.train import checkpoints as t_ckpt
from samplenerfro_torch.utils import config as t_config
from samplenerfro_torch.utils import grid_io
from samplenerfro_tpu.models import construct_nerf
from samplenerfro_tpu.ops import eikonal as j_eik
from samplenerfro_tpu.ops import grid as j_grid
from samplenerfro_tpu.ops.pallas import march_kernel as j_march
from samplenerfro_tpu.train import checkpoints as j_ckpt
from tests import fixtures, helpers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
DUMP_ATOL = 1e-4
S, NEAR, FAR = 32, 2.0, 6.0
H = (FAR - NEAR) / (S - 1)


def _march_setup(nrays=256, n=64):
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(n, 1.5, 0.33)
  spec = j_grid.GridSpec(ndim, nmin, nmax)
  data = np.concatenate(
      [values, j_grid.central_difference_grad_numpy(spec, values)],
      axis=-1).astype(np.float32)
  side = int(np.sqrt(nrays))
  d = np.array([[0.004 * (i % side), 0.003 * (i // side), 1.0]
                for i in range(nrays)], np.float32)
  d /= np.linalg.norm(d, axis=-1, keepdims=True)
  o = np.broadcast_to(np.array([0.1, -0.05, -4.0], np.float32),
                      d.shape).copy()
  return spec, t_grid.GridSpec(ndim, nmin, nmax), data, o, d


def _port_full_plain(tspec, data, o, d):
  traj = t_march.march_full_plain(tspec, torch.from_numpy(data),
                                  torch.from_numpy(o), torch.from_numpy(d),
                                  NEAR, H, S)
  assert traj.shape == (o.shape[0], S, t_march.FULL_ROW)
  return [x.numpy() for x in t_march.split_trajectory(traj)]


def _assert_traj(got, want):
  for name, g, w in zip(("pos", "raw dir", "dist", "n", "grad n"), got,
                        want):
    w = np.asarray(w).reshape(g.shape)
    np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=name)


def test_plain_head_off_march_matches_pallas_interpret():
  spec, tspec, data, o, d = _march_setup()
  want = j_march.march_tiled_pallas(
      spec, jnp.asarray(data), jnp.asarray(o), jnp.asarray(d), NEAR, H, S,
      block_size=256, window=16, refetch_every=8, so3_params=None,
      interpret=True, normalize_dirs=False)
  assert int(want[5]) == 0, "the Pallas window clamped; results inexact"
  _assert_traj(_port_full_plain(tspec, data, o, d), want[:5])


def test_plain_head_off_march_matches_eikonal_march():
  spec, tspec, data, o, d = _march_setup(nrays=100)
  pos, dirs, dist, n, g = j_eik.march(spec, jnp.asarray(data),
                                      jnp.asarray(o), jnp.asarray(d), NEAR,
                                      H, S)
  got = _port_full_plain(tspec, data, o, d)
  # eik_ops.march emits unit directions; the full emit's are raw.
  nrm = got[1] / np.linalg.norm(got[1], axis=-1, keepdims=True)
  _assert_traj([got[0], nrm] + got[2:], (pos, dirs, dist, n, g))
  # K1's plain version marches the same path.
  jitter = torch.arange(0, S, 4)
  lean = t_march.march_lean(tspec, torch.from_numpy(data),
                            torch.from_numpy(o), torch.from_numpy(d), NEAR,
                            H, S, jitter)
  np.testing.assert_array_equal(lean[0].numpy(), got[0])
  np.testing.assert_array_equal(lean[2].numpy(), got[2])


def test_head_off_wrapper_checks_and_counts():
  _, tspec, data, o, d = _march_setup(nrays=4, n=16)
  before = t_march.march_full_plain.launches
  t_march.march_full_plain(tspec, torch.from_numpy(data), torch.from_numpy(o),
                           torch.from_numpy(d), NEAR, H, 8)
  assert t_march.march_full_plain.launches == before  # CPU: no launch
  with pytest.raises(ValueError, match="batch must be at least 1"):
    t_march.full_plain_launch_geometry(0)
  geom = t_march.full_plain_launch_geometry(8193)
  assert geom["blocks"] * geom["rays_per_block"] >= 8193
  assert geom["smem_bytes"] == 4 * 11 * 8 * 32


def _model_args(stage="radiance", **kw):
  base = dict(stage=stage, randomized=False, net_depth=2, net_width=32,
              num_coarse_samples=8, num_path_samples=4, num_fine_samples=16)
  base.update(kw)
  return helpers.tiny_args(**base)


def _models(args):
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(32, 1.5, 0.33)
  rays = helpers.make_rays(8)
  model, variables = construct_nerf(random.PRNGKey(0), {"rays": rays}, args,
                                    ndim, nmin, nmax, values)
  port = t_nerf.construct_nerf(args, ndim, nmin, nmax, values, device="cpu")
  params = jax.tree_util.tree_map(np.asarray, variables["params"])
  convert.load_into(port, convert.params_from_flax(params))
  return model, variables, port


@pytest.mark.parametrize("fine,mlp_kernel,width", [
    (16, "xla", 32), (0, "xla", 32), (16, "pallas", 128),
    (16, "pallas_pe", 128)])
def test_sample_points_matches_jax(fine, mlp_kernel, width):
  args = _model_args(num_fine_samples=fine, mlp_kernel=mlp_kernel,
                     net_width=width, net_width_condition=128)
  model, variables, port = _models(args)
  rng = np.random.RandomState(2)
  pts = rng.uniform(-1.2, 1.2, (64, 1, 3)).astype(np.float32)
  dirs = np.zeros_like(pts)
  dirs[5:9] = rng.randn(4, 1, 3)
  want = model.apply(variables, jnp.asarray(pts), jnp.asarray(dirs),
                     method=model.sample_points)
  with torch.no_grad():
    got = port.sample_points(torch.from_numpy(pts), torch.from_numpy(dirs))
  assert port._use_fused_mlp() == (mlp_kernel != "xla")
  for name, g, w in zip(("rgb", "alpha"), got, want):
    assert g.shape == w.shape, name
    np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0,
                               err_msg=name)


@pytest.mark.parametrize("stage", ["radiance", "all"])
def test_path_sampler_without_jitter_emits_the_full_path(stage):
  """A radiance sampler called without a jitter marches with the grid's
  gradient and returns n and grad n (the full emit); an `all` one marches
  with the so3 head, as the JAX sampler does."""
  args = _model_args(stage=stage)
  model, variables, port = _models(args)
  rays = helpers.make_rays(16, seed=4)
  o = np.asarray(rays.origins) + np.array([0.0, 0.0, -4.0], np.float32)
  d = np.array(rays.directions)
  want = model.apply(variables, jnp.asarray(o), jnp.asarray(d), 1.0,
                     method=lambda m, a, b, c: m.path_sampler(a, b, c))
  with torch.no_grad():
    got = port.path_sampler(torch.from_numpy(o), torch.from_numpy(d), None,
                            1.0)
  assert got[5] is None
  for name, g, w in zip(("pos", "dirs", "dist", "n", "grad n"), got[:5],
                        want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0,
                               err_msg=name)


def _jax_env():
  return dict(os.environ, JAX_PLATFORMS="cpu", SAMPLENERFRO_FORCE_CPU="1")


def test_extract_mesh_matches_jax(tmp_path):
  scene = fixtures.make_scene(str(tmp_path / "scene"), num_train=1,
                              num_test=2)
  cfg = fixtures.write_tiny_config(str(tmp_path / "cfg"))
  args, gcfg, bindings = t_config.load_args(cfg, [cfg + ".gin"])
  model = t_eval.build_model(args, gcfg, bindings, scene, "cpu", seed=3)
  t_ckpt.save_checkpoint(str(tmp_path / "t" / "rad_w"), model,
                         torch.optim.Adam(model.parameters()), 3)
  j_ckpt.save_checkpoint(str(tmp_path / "j" / "rad_w"),
                         {"step": 3, "params": convert.params_to_flax(model)},
                         3)
  sigma = t_extract.density_grid(model, 12, 1.2, args.chunk, "cpu")
  threshold = float(f"{np.median(sigma):.4g}")
  flags = [f"--data_dir={scene}", f"--config={cfg}", f"--gin_file={cfg}.gin",
           "--gin_param=Config.radiance_weight_name='rad_w'",
           "--stage=radiance", "--resolution=12", "--img_idx=2",
           "--pixel=10", "--pixel=13", f"--threshold={threshold}"]
  got = t_extract.main(flags + [f"--train_dir={tmp_path / 't'}",
                                "--device=cpu"])
  subprocess.run([sys.executable, os.path.join(REPO, "extract_mesh.py")]
                 + flags + [f"--train_dir={tmp_path / 'j'}"], check=True,
                 env=_jax_env(), cwd=REPO, capture_output=True)
  t_dir = tmp_path / "t" / "radiance" / "debug"
  j_dir = tmp_path / "j" / "radiance" / "debug"
  names = sorted(os.listdir(j_dir))
  assert sorted(os.listdir(t_dir)) == names
  dump = "ray_001_010_013.pkl"
  assert f"mesh_12_1.2_{threshold}.obj" in names and dump in names
  with open(t_dir / dump, "rb") as f:
    t_dump = pickle.load(f)
  with open(j_dir / dump, "rb") as f:
    j_dump = pickle.load(f)
  assert sorted(t_dump) == sorted(j_dump)
  assert t_dump["transform"] is None and j_dump["transform"] is None
  steps = args.num_coarse_samples * args.num_path_samples
  assert t_dump["ray_pos"].shape == (1, steps, 3)
  for k in ("ray_pos", "ray_dir", "idx_grad", "ray_pos_c"):
    np.testing.assert_allclose(t_dump[k], np.asarray(j_dump[k]),
                               atol=DUMP_ATOL, rtol=0, err_msg=k)
  assert np.abs(t_dump["idx_grad"]).max() > 0

  # The density the JAX model computes with these weights on the same
  # lattice (np.meshgrid's xy order), against the port's grid.
  np.testing.assert_array_equal(got["sigma"], sigma)
  jargs = helpers.tiny_args(**{k: getattr(args, k) for k in (
      "net_depth", "net_width", "net_depth_condition", "net_width_condition",
      "num_coarse_samples", "num_fine_samples", "num_path_samples")},
                            stage="radiance")
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(16, 1.5, 0.33)
  jmodel, jvars = construct_nerf(random.PRNGKey(0),
                                 {"rays": helpers.make_rays(8)}, jargs, ndim,
                                 nmin, nmax, values)
  jvars = {**jvars, "params": convert.params_to_flax(model)}
  t = np.linspace(-1.2, 1.2, 13)
  pts = np.stack(np.meshgrid(t, t, t), -1).astype(np.float32).reshape(
      -1, 1, 3)
  want = jmodel.apply(jvars, jnp.asarray(pts), jnp.zeros_like(pts),
                      method=jmodel.sample_points)[1]
  np.testing.assert_allclose(sigma, np.asarray(want).reshape(13, 13, 13),
                             atol=ATOL, rtol=0)
  assert 0 < len(got["faces"])
  assert os.path.getsize(t_dir / f"mesh_12_1.2_{threshold}.obj") > 0


def test_eval_writes_the_depth_images(tmp_path):
  scene = fixtures.make_scene(str(tmp_path / "scene"), num_train=1,
                              num_test=1, res=16)
  cfg = fixtures.write_tiny_config(str(tmp_path / "cfg"))
  args, gcfg, bindings = t_config.load_args(cfg, [cfg + ".gin"])
  model = t_eval.build_model(args, gcfg, bindings, scene, "cpu", seed=2)
  t_ckpt.save_checkpoint(str(tmp_path / "out" / "radiance"), model,
                         torch.optim.Adam(model.parameters()), 1)
  t_eval.main([f"--data_dir={scene}", f"--train_dir={tmp_path / 'out'}",
               f"--config={cfg}", f"--gin_file={cfg}.gin", "--device=cpu"])
  out = tmp_path / "out" / "radiance" / "test_preds"
  from PIL import Image
  disp = np.asarray(Image.open(out / "disp_000.png"))
  assert disp.shape == (16, 16) and disp.dtype == np.uint8
  for k in ("depth", "depth_mod", "depth_normals"):
    img = np.asarray(Image.open(out / f"{k}_000.png"))
    assert img.shape == (16, 16, 3), k
    assert img.std() > 0, k
