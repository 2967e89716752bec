"""The port's training slice against the JAX package's.

One train step of the radiance and of the 'all' stage, in both JAX march
modes, from the same weights (models/convert.py), grid, batch and jitter
(rebuilt from the JAX step's rng as models/nerf.py:382-392 draws it);
randomized=False and noise_std=None, so nothing else is random. Compared:
the loss and every Stats field at rtol 1e-5, the gradient of every
parameter at atol 1e-4 * its scale, and the parameters after two Adam
steps at atol 2 * lr(1) (the first update has lr(0) = 0; an update moves a
parameter by about lr * sign(g), so a near-zero gradient may flip sign).
The optimizer alone is held against optax exactly, so an update that used
the schedule one step off (a ~1e-2 relative error) would show. The point
encoding stops at degree 4 here: at the shipped degree 10 a 1e-6 shift of
a sample (the march's agreement) moves its top feature by 5e-4, and the
trunk gradients by ~2e-3 of their scale, which would hide a real fault.
Then the bf16 MLPs against the JAX bf16 path, the dataset's batchings against
Blender._next_train on the same draws, and the `train` entry point on a
tiny scene on the CPU.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training.train_state import TrainState
from jax import random

from samplenerfro_torch import eval as t_eval
from samplenerfro_torch.data import datasets as t_datasets
from samplenerfro_torch.data import prefetch
from samplenerfro_torch.data.rays import Rays as TRays
from samplenerfro_torch.models import convert
from samplenerfro_torch.models import nerf as t_nerf
from samplenerfro_torch.train import checkpoints as t_ckpt
from samplenerfro_torch.train import loop as t_loop
from samplenerfro_torch.train import step as t_step
from samplenerfro_torch.utils import grid_io
from samplenerfro_tpu.data import datasets as j_datasets
from samplenerfro_tpu.data.rays import Rays as JRays
from samplenerfro_tpu.models import construct_nerf
from samplenerfro_tpu.train import step as j_step
from tests import fixtures, helpers

NRAYS, PATCH = 256, 4
STATS = ("loss", "psnr", "loss_c", "psnr_c", "weight_l2", "loss_nrm",
         "loss_sp", "annealing_rate", "loss_bg", "loss_bg_c",
         "loss_bg_smooth", "coarse_alpha_target", "fine_alpha_target")


def _args(stage, march_mode, **kw):
  base = dict(
      randomized=False, march_mode=march_mode, march_emit="lean",
      tile_size=16, march_window=16, march_refetch=4, net_depth=4,
      net_width=32, num_coarse_samples=8, num_path_samples=4,
      num_fine_samples=16, stage=stage, grad_max_norm=0.0,
      bg_patch_size=PATCH, max_deg_point=4)
  base.update(kw)
  return helpers.tiny_args(**base)


def _batch(seed=0):
  rng = np.random.RandomState(seed)
  side = 16
  d = np.array([[0.004 * (i % side), 0.003 * (i // side), 1.0]
                for i in range(NRAYS)], np.float32)
  d /= np.linalg.norm(d, axis=-1, keepdims=True)
  o = np.broadcast_to(np.array([0.1, -0.05, -4.0], np.float32), d.shape)
  radii = np.full((NRAYS, 1), 1e-3, np.float32)
  env = rng.randn(PATCH, PATCH, 3).astype(np.float32)
  env /= np.linalg.norm(env, axis=-1, keepdims=True)
  return {"rays": (o.copy(), d, d, radii),
          "env": (env, env, env, np.full((PATCH, PATCH, 1), 1e-3,
                                         np.float32)),
          "pixels": rng.rand(NRAYS, 3).astype(np.float32),
          "annealed_alpha": np.float32(0.5)}


def _jax_batch(b):
  return {"rays": JRays(*map(jnp.asarray, b["rays"])),
          "env_rays": JRays(*map(jnp.asarray, b["env"])),
          "pixels": jnp.asarray(b["pixels"]),
          "annealed_alpha": jnp.asarray(b["annealed_alpha"]),
          "coarse_alpha_target": jnp.float32(0.0),
          "fine_alpha_target": jnp.float32(0.0)}


def _torch_batch(b):
  return {"rays": TRays(*map(torch.from_numpy, b["rays"])),
          "env_rays": TRays(*map(torch.from_numpy, b["env"])),
          "pixels": torch.from_numpy(b["pixels"]),
          "annealed_alpha": float(b["annealed_alpha"])}


def _step_batch(b, args, optimizer, count, jitter):
  """b as train_step takes it (loop.step_batch), with the rates of update
  number `count` and the jitter."""
  host = {"pixels": b["pixels"], "rays": TRays(*b["rays"]),
          "env_rays": TRays(*b["env"])}
  return prefetch.to_device(t_loop.step_batch(
      host, b["annealed_alpha"], t_step.learning_rates(optimizer, count),
      jitter, args), "cpu")


def _jitter(rng, args):
  """The jitter the JAX train step draws from `rng` (step.py:242)."""
  key_0 = random.split(rng, 4)[1]
  key, _ = random.split(key_0)
  base = jnp.arange(0, args.num_coarse_samples * args.num_path_samples,
                    args.num_path_samples)
  jit = base + random.randint(key, [args.num_coarse_samples], minval=0,
                              maxval=args.num_path_samples)
  return torch.from_numpy(np.asarray(jit))


def _setup(args):
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(64, 1.5, 0.33)
  b = _batch()
  model, variables = construct_nerf(
      random.PRNGKey(0), {"rays": JRays(*map(jnp.asarray, b["rays"]))}, args,
      ndim, nmin, nmax, values)
  port = t_nerf.construct_nerf(args, ndim, nmin, nmax, values, device="cpu")
  params = jax.tree_util.tree_map(np.asarray, variables["params"])
  convert.load_into(port, convert.params_from_flax(params))
  return model, variables, port, b


def _assert_close_tree(got_sd, want_sd, atol_of, what):
  for key, want in want_sd.items():
    got = got_sd[key]
    np.testing.assert_allclose(got, want, atol=atol_of(want), rtol=0,
                               err_msg=f"{what} {key}")


@pytest.mark.parametrize("stage", ["radiance", "all"])
@pytest.mark.parametrize("march_mode", ["pallas", "scan"])
def test_train_step_matches_jax(stage, march_mode):
  args = _args(stage, march_mode)
  model, variables, port, b = _setup(args)
  tx, lr_fn, _ = j_step.create_optimizer(args)
  state = TrainState.create(apply_fn=model.apply,
                            params=variables["params"], tx=tx)
  tstep = j_step.make_train_step(model, args, {"grid": variables["grid"]},
                                 donate=False)
  rng = random.PRNGKey(3)
  jbatch = _jax_batch(b)
  state1, j_stats, rng2 = tstep(rng, state, jbatch)
  state2, _, _ = tstep(rng2, state1, jbatch)

  optimizer, _, _ = t_step.create_optimizer(port, args)
  stats = t_step.train_step(
      port, optimizer, _step_batch(b, args, optimizer, 0, _jitter(rng, args)),
      args).as_floats()
  for name in STATS + ("march_oow",):
    np.testing.assert_allclose(getattr(stats, name),
                               float(getattr(j_stats, name)), rtol=1e-5,
                               atol=1e-7, err_msg=name)

  # The first update runs at lr(0) = 0, so its Adam first moment is
  # 0.1 * the step's gradient (no clipping here).
  mu = state1.opt_state.inner_states["adam_lr_scheduler"].inner_state[0].mu
  mu = {k: v for k, v in mu.items() if isinstance(v, dict)}
  want = {k: v.numpy() / np.float32(0.1) for k, v in convert.params_from_flax(
      jax.tree_util.tree_map(np.asarray, mu)).items()}
  got = {k: p.grad.numpy() for k, p in port.named_parameters()}
  _assert_close_tree(got, want,
                     lambda w: 1e-4 * max(float(np.abs(w).max()), 1e-12),
                     "grad")
  # The so3 head is trained in 'all' only; in radiance it gets only the
  # (zero-weighted) weight-L2 term's zero gradient, as in the JAX step.
  so3 = max(float(np.abs(v).max()) for k, v in got.items()
            if k.startswith("path_sampler."))
  assert (so3 > 0) == (stage == "all")
  assert all(k.startswith("path_sampler.") == (stage == "radiance")
             for k in set(got) - set(want))

  t_step.train_step(
      port, optimizer, _step_batch(b, args, optimizer, 1, _jitter(rng2, args)),
      args)
  want = {k: v.numpy() for k, v in convert.params_from_flax(
      jax.tree_util.tree_map(np.asarray, state2.params)).items()}
  got = {k: v.detach().numpy() for k, v in port.named_parameters()}
  _assert_close_tree(got, want, lambda _: 2 * lr_fn(1), "param")


def test_adam_schedule_matches_optax():
  args = _args("all", "scan", lr_delay_steps=3, grad_max_norm=0.0)
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(8, 1.5, 0.33)
  port = t_nerf.construct_nerf(args, ndim, nmin, nmax, values, device="cpu")
  params = convert.params_to_flax(port)
  tx, lr_fn, _ = j_step.create_optimizer(args)
  opt_state = tx.init(params)
  optimizer, _, _ = t_step.create_optimizer(port, args)
  rng = np.random.RandomState(0)
  for k in range(4):
    grads = jax.tree_util.tree_map(
        lambda p: rng.randn(*p.shape).astype(np.float32), params)
    updates, opt_state = tx.update(grads, opt_state, params)
    params = optax.apply_updates(params, updates)
    for key, g in convert.params_from_flax(grads).items():
      port.get_parameter(key).grad = g
    lrs = t_step.learning_rates(optimizer, k)
    assert lrs[0] == pytest.approx(lr_fn(k))
    optimizer.step(torch.tensor(lrs, dtype=torch.float32))
  for key, want in convert.params_from_flax(params).items():
    np.testing.assert_allclose(port.get_parameter(key).detach().numpy(),
                               want.numpy(), rtol=1e-5, atol=1e-8,
                               err_msg=key)


def test_radiance_stage_freezes_path_sampler():
  args = _args("radiance", "scan")
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(8, 1.5, 0.33)
  port = t_nerf.construct_nerf(args, ndim, nmin, nmax, values, device="cpu")
  optimizer, _, _ = t_step.create_optimizer(port, args)
  names = [g["name"] for g in optimizer.param_groups]
  assert names == ["bkgd_mlp", "coarse_mlp", "fine_mlp"]
  args_all = _args("all", "scan")
  optimizer, _, _ = t_step.create_optimizer(port, args_all)
  assert [g["name"] for g in optimizer.param_groups] == [
      "path_sampler", "bkgd_mlp", "coarse_mlp", "fine_mlp"]
  # The ior stage trains the so3 head alone; the sparsity term trains
  # nothing new.
  for stage in ("ior", "ior_x"):
    optimizer, _, _ = t_step.create_optimizer(port, _args(stage, "scan"))
    assert [g["name"] for g in optimizer.param_groups] == ["path_sampler"]
    assert optimizer.param_groups[0]["params"] == list(
        port.path_sampler.so3_mlp.parameters())
  optimizer, _, _ = t_step.create_optimizer(
      port, _args("radiance", "scan", sparsity_weight=0.1))
  assert [g["name"] for g in optimizer.param_groups] == [
      "bkgd_mlp", "coarse_mlp", "fine_mlp"]
  with pytest.raises(ValueError, match="unknown stage"):
    t_step.create_optimizer(port, _args("nope", "scan"))


def test_bf16_mlps_match_jax_bf16():
  """Both compute the radiance MLPs in bf16 with fp32 weights, rounding after
  every layer but at slightly other points (flax adds the bias in bf16,
  PyTorch's CPU addmm before it rounds). Measured here: rgb within 1.5e-5
  (fine) and 1.2e-7 (coarse), against 1.3e-3 and 4.3e-4 for the fp32 port.
  Held at 1e-4, which the fp32 port fails, so the test sees the dtype."""
  args = _args("all", "scan", mlp_dtype="bfloat16")
  model, variables, port, b = _setup(args)
  rng = random.PRNGKey(3)
  apply = jax.jit(lambda v, k0, k1, r: model.apply(v, k0, k1, r, False, 0.5))
  ret, _ = apply(variables, random.split(rng, 4)[1], random.split(rng, 4)[2],
                 JRays(*map(jnp.asarray, b["rays"])))
  jitter = _jitter(rng, args)
  rays = _torch_batch(b)["rays"]
  with torch.no_grad():
    got, _ = port(rays, jitter, annealed_alpha=0.5)
    fp32, _ = port(rays, jitter, annealed_alpha=0.5, mlp_dtype=torch.float32)
  for level in (0, 1):
    want = np.asarray(ret[level][0])
    np.testing.assert_allclose(got[level][0].numpy(), want, atol=1e-4)
    assert float(np.abs(fp32[level][0].numpy() - want).max()) > 1e-4


class _NoThread(j_datasets.Blender):
  """The JAX loader without its prefetch thread, so only the test draws."""

  def start(self):
    pass


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
  root = tmp_path_factory.mktemp("train_scene")
  return fixtures.make_scene(str(root / "scene"), num_train=3, num_test=1,
                             res=24, grid_n=12)


@pytest.mark.parametrize("batching,extra", [
    ("single_image", {}), ("single_image", {"precrop_iters": 2}),
    ("all_images", {"bg_patch_size": 0}), ("tile", {"tile_size": 4}),
    ("tile", {"tile_size": 4, "tile_stride": 2, "tile_images": True})])
def test_batches_match_blender_next_train(scene, batching, extra):
  kw = dict(data_dir=scene, batching=batching, batch_size=32,
            bg_patch_size=6, tile_size=4, tile_stride=1, tile_images=False,
            factor=0)
  kw.update(extra)
  args = helpers.tiny_args(**kw)
  j_ds = _NoThread("train", args)
  t_ds = t_datasets.TrainBatches(args, np.random.RandomState(11))
  np.random.seed(11)
  for _ in range(3):
    want, got = j_ds._next_train(), next(t_ds)
    np.testing.assert_array_equal(got["pixels"], want["pixels"])
    for g, w in zip(got["rays"], want["rays"]):
      np.testing.assert_array_equal(g, w)
    if want["env_rays"] is None:
      assert got["env_rays"] is None
    else:
      for g, w in zip(got["env_rays"], want["env_rays"]):
        np.testing.assert_array_equal(g, w)
  assert t_ds.train_it == j_ds.train_it == 3


def test_train_entry_point_writes_and_resumes(scene, tmp_path):
  cfg = fixtures.write_tiny_config(str(tmp_path / "cfg"))
  common = [f"--data_dir={scene}", f"--train_dir={tmp_path / 'out'}",
            f"--config={cfg}", f"--gin_file={cfg}.gin", "--device=cpu",
            "--stage=all", "--save_every=2", "--render_every=2"]
  t_loop.main(common + ["--max_steps=3"])
  stage_dir = str(tmp_path / "out" / "all")
  assert sorted(os.listdir(stage_dir)) == ["checkpoint_2", "checkpoint_3"]
  saved = torch.load(os.path.join(stage_dir, "checkpoint_3"),
                     weights_only=True)
  assert saved["step"] == 3 and "path_sampler.grid" not in saved["model"]
  model = t_loop.main(common + ["--max_steps=4"])
  assert t_ckpt.latest_step(stage_dir) == 4
  # The resumed run started from checkpoint_3's Adam state: four updates.
  state = torch.load(os.path.join(stage_dir, "checkpoint_4"),
                     weights_only=True)["optimizer"]["state"]
  assert {int(s["step"]) for s in state.values()} == {4}
  assert model.path_sampler.use_pred_grad
  with pytest.raises(ValueError, match="unknown flags"):
    t_loop.main(common + ["--not_a_flag=1"])

  # The trained 'all' model, carried as .npz, renders through eval.
  npz = tmp_path / "all.npz"
  np.savez(npz, **convert.flatten({"params": convert.params_to_flax(model)}))
  res = t_eval.main([f"--data_dir={scene}", f"--train_dir={tmp_path / 'ev'}",
                     f"--config={cfg}", f"--gin_file={cfg}.gin",
                     "--device=cpu", "--stage=all", f"--params_npz={npz}",
                     "--chunk=256"])
  assert len(res.psnrs) == 1 and np.isfinite(res.psnrs[0]) and res.step == 0
  assert os.path.exists(tmp_path / "ev" / "all" / "test_preds" / "000.png")


def test_train_refuses_an_unported_dataset(scene, tmp_path, monkeypatch):
  """A config naming no scene format stops with ValueError naming the
  dataset, before training reads any scene file."""
  cfg = fixtures.write_tiny_config(str(tmp_path / "cfg"))
  with open(cfg + ".yaml") as f:
    text = f.read().replace("dataset: blender", "dataset: colmap")
  with open(cfg + ".yaml", "w") as f:
    f.write(text)

  def untouched(*args, **kwargs):
    raise AssertionError("a scene file was read")

  monkeypatch.setattr(t_datasets, "TrainBatches", untouched)
  monkeypatch.setattr(t_datasets, "load_split", untouched)
  monkeypatch.setattr(t_loop, "build_model", untouched)
  with pytest.raises(ValueError, match="'colmap'"):
    t_loop.main([f"--data_dir={scene}", f"--train_dir={tmp_path / 'out'}",
                 f"--config={cfg}", f"--gin_file={cfg}.gin", "--device=cpu",
                 "--stage=radiance"])
