"""The port's `ior` stage and boundary-point losses against the JAX package.

The same seeded numpy inputs and weights (models/convert.py) go to both
packages: ops/grid.trilinear_numpy and data/datasets.Grid's batches bit
for bit (np.random.seed(s) for JAX, RandomState(s) for the port); the
normal smoothness and its gradient in the so3 head, with the JAX key's own
jax.random.normal draws handed to the port; the offline sparsity term; the
loss and every Stats field of the `ior` stage and of the radiance and
'all' stages with the sparsity and normal weights on; an `ior` step at
weight_decay_mult 1e-2 and one as shipped (0: nothing moves, bit for
bit); the SDF point sampler and the SDF renderer on a tools/synth mesh;
the `ior` branch of load_stage_weights; and `train` in the `ior` stage,
then `eval` of it, on the CPU.

Tolerances: batches, interpolation, renders and the shipped step exact
(the same numpy and native code on the same draws; a zero gradient makes
an Adam update of exactly 0); the refined gradients at 1e-6 of their
largest value (the same fp32 products, summed by other BLAS; a component
near 0 is 2.5e-6 off relative to itself); the smoothness, a mean of
sum |pred(p) - pred(p + offset)| / |grad n| whose two terms are each
about 1 in size and cancel to ~2e-3, at 1e-6 of the size of those terms
(measured 6e-9 absolute, 2.9e-6 of the smoothness itself); its gradient
per tensor at K3's form 2e-4 * max|want| + 2e-3 * |want| (autograd's and
JAX's reverse sums in other orders); Stats at tests/test_torch_train.py's rtol 1e-5; parameters
after an Adam step at 1e-6 (an update is about lr * sign(g), rounded
alike).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.training.train_state import TrainState
from jax import random

from samplenerfro_torch import eval as t_eval
from samplenerfro_torch.data import datasets as t_datasets
from samplenerfro_torch.data import prefetch
from samplenerfro_torch.data import sdf_points as t_sdf_points
from samplenerfro_torch.data.rays import Rays as TRays
from samplenerfro_torch.models import convert
from samplenerfro_torch.ops import grid as t_grid
from samplenerfro_torch.tools import isosurface as t_iso
from samplenerfro_torch.tools import objio as t_objio
from samplenerfro_torch.tools import sdf as t_sdf
from samplenerfro_torch.tools import sdf_demo as t_sdf_demo
from samplenerfro_torch.tools import synth as t_synth
from samplenerfro_torch.train import checkpoints as t_ckpt
from samplenerfro_torch.train import loop as t_loop
from samplenerfro_torch.train import step as t_step
from samplenerfro_torch.utils import config as t_config
from samplenerfro_torch.utils import grid_io
from samplenerfro_tpu.data import datasets as j_datasets
from samplenerfro_tpu.data import sdf_points as j_sdf_points
from samplenerfro_tpu.ops import grid as j_grid
from samplenerfro_tpu.tools import sdf as j_sdf
from samplenerfro_tpu.train import step as j_step
from tests import fixtures, helpers
from tests.test_torch_train import STATS, _args, _jax_batch, _jitter, _setup

SMOOTH_RTOL = 1e-6
K3_ATOL_SCALE, K3_RTOL = 2e-4, 2e-3
PARAM_ATOL = 1e-6


class _NoThreadGrid(j_datasets.Grid):
  """The JAX Grid without its prefetch thread, so only the test draws."""

  def start(self):
    pass


def _blob(n=24):
  return grid_io.synthetic_blob_grid(n, 1.5, 0.33)


def test_trilinear_numpy_matches_jax():
  values, ndim, nmin, nmax = _blob(12)
  spec_t = t_grid.GridSpec(ndim, nmin, nmax)
  spec_j = j_grid.GridSpec(ndim, nmin, nmax)
  data = np.random.RandomState(0).randn(12**3, 3).astype(np.float32)
  # Inside the grid, on its faces and beyond them (clamped).
  pts = np.random.RandomState(1).uniform(-1.8, 1.8, (500, 3))
  pts[:3] = [[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5], [0.0, 1.5, -1.5]]
  got = t_grid.trilinear_numpy(spec_t, data, pts)
  want = j_grid.trilinear_numpy(spec_j, data, pts)
  assert got.dtype == want.dtype == np.float64
  np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 5])
def test_grid_batches_match_jax(seed):
  values, ndim, nmin, nmax = _blob()
  args = helpers.tiny_args(extra_batch_size=16)
  j_ds = _NoThreadGrid("train", args, values, ndim, nmax, nmin)
  t_ds = t_datasets.Grid(args, values, ndim, nmax, nmin,
                         np.random.RandomState(seed))
  np.testing.assert_array_equal(t_ds.candidate_indices, j_ds.candidate_indices)
  assert 0 < len(t_ds.candidate_indices) < 24**3
  np.random.seed(seed)
  for _ in range(3):
    want, got = j_ds._next_train(), next(t_ds)
    assert sorted(got) == ["grads", "pts"]
    for k in want:
      assert got[k].shape == (16, 1, 3) and got[k].dtype == np.float32
      np.testing.assert_array_equal(got[k], want[k])


def _bent(variables, port, seed=0, std=0.05):
  """Both models' so3 output layer redrawn at `std`, so that the head
  bends the gradient by more than the shipped 1e-5 init would."""
  params = jax.tree_util.tree_map(np.asarray, variables["params"])
  out = params["path_sampler"]["so3_mlp"]["Dense_out"]
  rng = np.random.RandomState(seed)
  out["kernel"] = (std * rng.randn(*out["kernel"].shape)).astype(np.float32)
  out["bias"] = (std * rng.randn(*out["bias"].shape)).astype(np.float32)
  convert.load_into(port, convert.params_from_flax(params))
  return {**variables, "params": params}


def _ior_setup(stage="ior", **kw):
  args = _args(stage, "scan", **kw)
  model, variables, port, b = _setup(args)
  variables = _bent(variables, port)
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(64, 1.5, 0.33)
  grid = t_datasets.Grid(args, values, ndim, nmax, nmin,
                         np.random.RandomState(3))
  return args, model, variables, port, b, next(grid)


def _assert_grads(got, want, what):
  for key, w in want.items():
    bound = K3_ATOL_SCALE * float(np.abs(w).max()) + K3_RTOL * np.abs(w)
    err = np.abs(got[key] - w)
    assert np.all(err <= bound), (
        f"{what} {key}: worst {float((err - bound).max())} over its bound")


@pytest.mark.parametrize("alpha", [0.3, 1.0])
def test_normal_smoothness_and_its_gradient_match_jax(alpha):
  args, model, variables, port, _, pts = _ior_setup()
  key = random.PRNGKey(7)
  shape = pts["pts"].shape
  noise = np.asarray(random.normal(key, shape))

  def smooth(params):
    return model.apply({**variables, "params": params},
                       jnp.asarray(pts["pts"]), jnp.asarray(pts["grads"]),
                       jnp.float32(alpha), key,
                       method=model.wrapper_compute_normal_loss_and_smooth)

  (normal_j, smooth_j) = smooth(variables["params"])
  grads_j = jax.grad(lambda p: smooth(p)[1])(variables["params"])
  x, cond = torch.from_numpy(pts["pts"]), torch.from_numpy(pts["grads"])
  pred_j = model.apply(
      variables, jnp.asarray(pts["pts"]), jnp.asarray(pts["grads"]),
      jnp.float32(alpha),
      method=lambda m, *a: m.path_sampler.wrapper_grad_mlp(*a))
  with torch.no_grad():
    pred_t = port.path_sampler.wrapper_grad_mlp(x, cond, torch.tensor(alpha))
  pred_j = np.asarray(pred_j)
  np.testing.assert_allclose(pred_t.numpy(), pred_j, rtol=0,
                             atol=SMOOTH_RTOL * float(np.abs(pred_j).max()))
  assert float(np.abs(pred_t.numpy() - pts["grads"]).max()) > 1e-3
  normal_t, smooth_t = port.wrapper_compute_normal_loss_and_smooth(
      x, cond, torch.tensor(alpha), torch.from_numpy(noise.copy()))
  assert normal_t == float(normal_j) == 0.0
  assert float(smooth_j) > 1e-3
  terms = float((pred_t.abs().sum(-1) / cond.norm(dim=-1)).mean())
  np.testing.assert_allclose(float(smooth_t.detach()), float(smooth_j),
                             rtol=0, atol=SMOOTH_RTOL * terms)
  so3 = list(port.path_sampler.so3_mlp.parameters())
  got = torch.autograd.grad(smooth_t, so3)
  names = [k for k, _ in port.path_sampler.so3_mlp.named_parameters()]
  got = {f"path_sampler.so3_mlp.{k}": g.numpy() for k, g in zip(names, got)}
  want = {k: v.numpy() for k, v in convert.params_from_flax(
      jax.tree_util.tree_map(np.asarray, grads_j)).items()
          if k.startswith("path_sampler.")}
  assert sorted(got) == sorted(want)
  _assert_grads(got, want, "so3 grad")


@pytest.mark.parametrize("fine", [False, True])
def test_sparsity_loss_matches_jax(fine):
  args, model, variables, port, _, pts = _ior_setup(
      "radiance", use_fine_sparsity=fine, sparsity_weight=0.1)
  want = model.apply(variables, jnp.asarray(pts["pts"]), jnp.float32(0.1),
                     jnp.float32(0.2), method=model.compute_sparsity_loss)
  got = port.compute_sparsity_loss(torch.from_numpy(pts["pts"]), 0.1, 0.2)
  for g, w in zip(got, want):
    np.testing.assert_allclose(float(g.detach()) if torch.is_tensor(g)
                               else g, float(w), rtol=1e-5, atol=1e-7)
  assert (float(got[2]) > 0) == fine


def _port_batch(b, args, pts, noise, jitter, lr=None):
  host = {"pixels": b["pixels"], "rays": TRays(*b["rays"]),
          "env_rays": TRays(*b["env"]), **pts}
  batch = prefetch.to_device(t_loop.step_batch(
      host, b["annealed_alpha"], lr, jitter, args), "cpu")
  batch["normal_noise"] = torch.from_numpy(noise.copy())
  return batch


@pytest.mark.parametrize("stage,extra", [
    ("ior", {}),
    ("ior", {"weight_decay_mult": 1e-2}),
    ("radiance", {"sparsity_weight": 0.1}),
    ("all", {"sparsity_weight": 0.1, "use_fine_sparsity": True,
             "normal_loss_weight": 0.1, "normal_smooth_weight": 0.1})])
def test_loss_fn_and_stats_match_jax(stage, extra):
  args, model, variables, port, b, pts = _ior_setup(stage, **extra)
  assert t_step.needs_grid(args)
  rng = random.PRNGKey(3)
  _, key_0, key_1, key_nrm = random.split(rng, 4)
  noise = np.asarray(random.normal(key_nrm, pts["pts"].shape))
  jbatch = {**_jax_batch(b), "pts": jnp.asarray(pts["pts"]),
            "grads": jnp.asarray(pts["grads"])}
  total_j, stats_j = j_step.make_loss_fn(model, args)(
      variables["params"], {"grid": variables["grid"]}, key_0, key_1,
      key_nrm, jbatch)
  jitter = None if stage == "ior" else _jitter(rng, args)
  total_t, stats_t = t_step.loss_fn(port, _port_batch(b, args, pts, noise,
                                                      jitter), args)
  np.testing.assert_allclose(float(total_t), float(total_j), rtol=1e-5,
                             atol=1e-9)
  stats_t = stats_t.as_floats()
  for name in STATS + ("march_oow",):
    np.testing.assert_allclose(getattr(stats_t, name),
                               float(getattr(stats_j, name)), rtol=1e-5,
                               atol=1e-7, err_msg=name)
  if "sparsity_weight" in extra:
    assert stats_t.coarse_alpha_target > 0
    assert (stats_t.fine_alpha_target > 0) == extra.get(
        "use_fine_sparsity", False)
  # The gated terms reach the total as zeros.
  assert stats_t.loss_sp == stats_t.loss_nrm == 0.0


def _ior_steps(stage_args, n):
  """n `ior` steps of the JAX package and of the port from the same
  weights, Grid batches and smoothness draws; returns (JAX state, port,
  port optimizer, the port's starting parameters)."""
  args, model, variables, port, _, _ = _ior_setup(**stage_args)
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(64, 1.5, 0.33)
  grid = t_datasets.Grid(args, values, ndim, nmax, nmin,
                         np.random.RandomState(9))
  tx, _, _ = j_step.create_optimizer(args)
  state = TrainState.create(apply_fn=model.apply,
                            params=variables["params"], tx=tx)
  tstep = j_step.make_train_step(model, args, {"grid": variables["grid"]},
                                 donate=False)
  optimizer, _, _ = t_step.create_optimizer(port, args)
  start = {k: v.detach().clone() for k, v in port.state_dict().items()}
  rng = random.PRNGKey(11)
  for i in range(n):
    pts = next(grid)
    alpha = np.float32(0.25 * (i + 1))
    key_nrm = random.split(rng, 4)[3]
    noise = np.asarray(random.normal(key_nrm, pts["pts"].shape))
    state, _, rng = tstep(rng, state, {
        "pts": jnp.asarray(pts["pts"]), "grads": jnp.asarray(pts["grads"]),
        "annealed_alpha": jnp.asarray(alpha)})
    batch = prefetch.to_device(t_loop.step_batch(
        pts, alpha, t_step.learning_rates(optimizer, i), None, args), "cpu")
    batch["normal_noise"] = torch.from_numpy(noise.copy())
    stats = t_step.train_step(port, optimizer, batch, args)
    assert stats.loss_nrm == 0.0
  return state, port, optimizer, start


def test_ior_step_with_weight_decay_matches_jax():
  state, port, optimizer, start = _ior_steps(
      {"weight_decay_mult": 1e-2, "lr_delay_steps": 0}, 2)
  want = {k: v.numpy() for k, v in convert.params_from_flax(
      jax.tree_util.tree_map(np.asarray, state.params)).items()}
  got = {k: v.detach().numpy() for k, v in port.named_parameters()}
  for key, w in want.items():
    np.testing.assert_allclose(got[key], w, atol=PARAM_ATOL, rtol=0,
                               err_msg=key)
    moved = not np.array_equal(got[key], start[key].numpy())
    # Only the so3 head trains; its biases start at zero, where the
    # weight-L2 gradient is zero.
    assert moved == (key.startswith("path_sampler.")
                     and float(start[key].abs().max()) > 0), key
  assert [g["name"] for g in optimizer.param_groups] == ["path_sampler"]


def test_shipped_ior_step_changes_nothing():
  """weight_decay_mult 0 (every shipped config): the gated total has a
  zero gradient, and Adam moves nothing, bit for bit, in both packages."""
  state, port, optimizer, start = _ior_steps({"lr_delay_steps": 0}, 2)
  for key, v in port.state_dict().items():
    assert torch.equal(v, start[key]), key
  for moments in optimizer.state.values():
    assert not moments["exp_avg"].any() and not moments["exp_avg_sq"].any()
  assert int(optimizer.counts[0]) == 2
  want = {k: v.numpy() for k, v in convert.params_from_flax(
      jax.tree_util.tree_map(np.asarray, state.params)).items()}
  for key, w in want.items():
    np.testing.assert_array_equal(start[key].numpy(), w, err_msg=key)


@pytest.fixture(scope="module")
def synth_mesh(tmp_path_factory):
  """The iso-surface of tools/synth's blob at IOR 1.165, as mesh.obj."""
  values = t_synth.blob_ior_grid(24).reshape(24, 24, 24)
  verts, faces = t_iso.marching_cubes(values, 1.165)
  verts = verts / 23.0 * 3.0 - 1.5
  root = tmp_path_factory.mktemp("synth_mesh")
  t_objio.save_obj(str(root / "mesh.obj"), verts, faces)
  return str(root)


class _Done(Exception):
  pass


class _Catch:
  """A queue whose put keeps `n` batches, then stops the producer."""

  def __init__(self, n):
    self.items, self.n = [], n

  def put(self, item):
    self.items.append(item)
    if len(self.items) == self.n:
      raise _Done()


class _NoThreadSdfPoints(j_sdf_points.Dataset):
  def start(self):
    pass


def test_sdf_points_match_jax(synth_mesh):
  args = helpers.tiny_args(data_dir=synth_mesh, batch_size=64)
  j_ds = _NoThreadSdfPoints(args)
  j_ds.queue = _Catch(2)
  np.random.seed(4)
  with pytest.raises(_Done):
    j_ds.run()
  t_ds = t_sdf_points.Dataset(args, np.random.RandomState(4))
  for want in j_ds.queue.items:
    got = next(t_ds)
    for k in ("samples", "labels"):
      assert got[k].dtype == np.float32
      np.testing.assert_array_equal(got[k], want[k])
  assert got["samples"].shape == (64, 3) and got["labels"].shape == (64, 1)
  # Inside points are labelled 1.33, and there are some.
  assert 0 < float((got["labels"] == np.float32(1.33)).mean()) < 1


def test_renderer_matches_jax(synth_mesh):
  mesh = t_objio.load(os.path.join(synth_mesh, "mesh.obj"))
  cam_verts = mesh.vertices + np.array([0.1, -0.05, 3.0])
  kw = dict(width=48, height=40, fx=40.0, fy=42.0, cx=23.5, cy=20.5)
  got = t_sdf.Renderer(cam_verts, mesh.faces, **kw)
  want = j_sdf.Renderer(cam_verts, mesh.faces, **kw)
  depth = got.render_depth()
  np.testing.assert_array_equal(depth, want.render_depth())
  np.testing.assert_array_equal(got.render_mask(), want.render_mask())
  assert 0.05 < got.render_mask().mean() < 0.9
  for fill in (False, True):
    np.testing.assert_array_equal(got.render_nn(fill), want.render_nn(fill))
  assert (got.render_nn(True) >= 0).all()


def test_sdf_demo_writes_its_views(synth_mesh, tmp_path, capsys):
  out = tmp_path / "demo"
  t_sdf_demo.main([os.path.join(synth_mesh, "mesh.obj"), str(out),
                   "--views", "2", "--size", "32"])
  assert sorted(os.listdir(out)) == ["depth_00.png", "depth_01.png",
                                     "mask_00.png", "mask_01.png"]
  lines = capsys.readouterr().out.splitlines()
  assert len(lines) == 2 and all("coverage" in ln for ln in lines)
  mesh = t_objio.load(os.path.join(synth_mesh, "mesh.obj"))
  (depth, mask), _ = t_sdf_demo.render_views(mesh, 2, 32)
  assert 0 < mask.mean() < 1 and (depth[mask] > 0).all()


def _cfg(tmp_path, **gin):
  cfg = fixtures.write_tiny_config(str(tmp_path / "cfg"))
  with open(cfg + ".gin", "a") as f:
    for k, v in gin.items():
      f.write(f"{k} = {v!r}\n")
  return cfg


def test_load_stage_weights_takes_ior_from_two_checkpoints(tmp_path):
  cfg = _cfg(tmp_path)
  args, gcfg, bindings = t_config.load_args(cfg, [cfg + ".gin"])
  scene = fixtures.make_scene(str(tmp_path / "scene"), num_train=1,
                              num_test=1, res=8, grid_n=8)
  models = [t_eval.build_model(args, gcfg, bindings, scene, "cpu", seed=s)
            for s in (1, 2, 3)]
  train_dir = str(tmp_path / "logs")
  for model, name, step in ((models[0], "radiance", 4), (models[1], "ior", 7)):
    t_ckpt.save_checkpoint(os.path.join(train_dir, name), model,
                           torch.optim.Adam(model.parameters()), step)
  step = t_ckpt.load_stage_weights(models[2], train_dir, gcfg, "ior_x")
  assert step == 7
  src = [m.state_dict() for m in models[:2]]
  for k, v in models[2].state_dict().items():
    if k == "path_sampler.grid":
      continue
    want = src[1][k] if k.startswith("path_sampler.") else src[0][k]
    assert torch.equal(v, want), k


def test_ior_stage_trains_and_evaluates_on_cpu(tmp_path):
  """`train` in the ior stage (Grid batches, K = 3, a val render) leaves
  every weight where it was, as shipped; eval then renders the radiance
  and ior checkpoints. The 'all' stage with the sparsity and normal terms
  on draws its Grid batches beside the image batches."""
  scene = fixtures.make_scene(str(tmp_path / "scene"), num_train=2,
                              num_test=1, res=16, grid_n=12)
  cfg = _cfg(tmp_path)
  common = [f"--data_dir={scene}", f"--train_dir={tmp_path / 'logs'}",
            f"--config={cfg}", f"--gin_file={cfg}.gin", "--device=cpu",
            "--seed=2"]
  every = ["--max_steps=3", "--save_every=3", "--print_every=3",
           "--gc_every=3", "--steps_per_dispatch=3"]
  t_loop.main(common + ["--stage=radiance", "--render_every=0"] + every)
  ior = t_loop.main(common + ["--stage=ior", "--render_every=3",
                              "--extra_batch_size=8"] + every)
  args, gcfg, bindings = t_config.load_args(cfg, [cfg + ".gin"])
  init = t_eval.build_model(args, gcfg, bindings, scene, "cpu", seed=2)
  for k, v in ior.state_dict().items():
    assert torch.equal(v, init.state_dict()[k]), k
  assert os.listdir(tmp_path / "logs" / "ior") == ["checkpoint_3"]
  res = t_eval.main(common + [
      "--stage=ior", "--chunk=256",
      "--gin_param=Config.radiance_weight_name='radiance'",
      "--gin_param=Config.ior_weight_name='ior'"])
  assert res.step == 3 and np.isfinite(res.psnrs[0])
  t_loop.main(common + ["--stage=all", "--render_every=0",
                        "--sparsity_weight=0.1", "--normal_smooth_weight=0.1",
                        "--extra_batch_size=8"] + every)
  assert os.listdir(tmp_path / "logs" / "all") == ["checkpoint_3"]
