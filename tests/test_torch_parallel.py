"""The port's data parallelism (parallel/mesh.py) on the CPU, over gloo.

samplenerfro_torch/debug/dist_worker.py runs one spec of train steps and a
render three ways, each a fresh process (one OpenMP thread): alone (the
single-process step of the concatenated batch), as 2 ranks (each given
RANK, WORLD_SIZE, MASTER_ADDR and a MASTER_PORT from a socket bound to
port 0 here, each rank its half of every batch), and as 1 rank.
(a) The 2-rank steps against the single-process ones: one radiance step
    (randomized, density noise, online sparsity, clipping by global
    norm), one 'all' step and a window of K = 2; every Stats field at 1e-6
    relative, every gradient per tensor at K3's form (|got - want| <=
    2e-4 * max|want| + 2e-3 * |want|: per-rank partial sums in another
    order), both ranks' parameters and Adam moments equal bit for bit,
    and a render split over the ranks (chunks padded to a multiple of 2)
    within 1e-6.
(b) The 2-rank radiance step against the JAX step of the global batch at
    tests/test_torch_train.py's tolerances.
(c) Rank r's TrainBatches and Grid draws at W = 2 bit for bit the JAX
    loaders' under np.random.seed(20201473 + r), jax.process_count
    patched to 2.
(d) World 1 bit for bit no ranks.
(e) `train` and `eval` as 2 ranks: rank 0 prints and writes each file
    once, both ranks resume, eval's PSNR is the single-process eval's.
(f) A batch that W does not divide, NCCL on the CPU and a failed init
    raise.
"""

import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from flax.training.train_state import TrainState
from jax import random

from samplenerfro_torch.data import datasets as t_datasets
from samplenerfro_torch.data.rays import Rays as TRays
from samplenerfro_torch.debug import dist_worker
from samplenerfro_torch.models import convert
from samplenerfro_torch.models import nerf as t_nerf
from samplenerfro_torch.parallel import mesh
from samplenerfro_torch.train import checkpoints as t_ckpt
from samplenerfro_torch.train import loop as t_loop
from samplenerfro_torch.train import step as t_step
from samplenerfro_torch.utils import grid_io
from samplenerfro_tpu.data import datasets as j_datasets
from samplenerfro_tpu.train import step as j_step
from tests import fixtures, helpers
from tests.test_torch_train import STATS, _args, _jax_batch, _jitter, _setup

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120
K3_ATOL_SCALE, K3_RTOL = 2e-4, 2e-3
STATS_RTOL = 1e-6
RENDER_ATOL = 1e-6
DIST_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def _free_port():
  with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    return s.getsockname()[1]


def _env(rank=None, world=None, port=None):
  env = {k: v for k, v in os.environ.items() if k not in DIST_ENV}
  env["OMP_NUM_THREADS"] = "1"
  if world is not None:
    env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
  return env


def _start(cmd, world=None):
  """cmd as `world` ranks (None: one process without ranks)."""
  port = _free_port()
  return [subprocess.Popen(
      cmd, env=_env(r, world, port) if world else _env(), cwd=ROOT,
      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
          for r in range(world or 1)]


def _finish(procs):
  """The processes' stdouts; every process must exit 0 in time."""
  outs = []
  try:
    for p in procs:
      outs.append(p.communicate(timeout=TIMEOUT_S))
  finally:
    for p in procs:
      if p.poll() is None:
        p.kill()
        p.wait()
  for p, (_, err) in zip(procs, outs):
    assert p.returncode == 0, err[-4000:]
  return [out for out, _ in outs]


def _host(b):
  return {"pixels": b["pixels"], "rays": TRays(*b["rays"]),
          "env_rays": TRays(*b["env"])}


def _view(h=9, w=11):
  """A view whose last 40-ray chunk (19 rays) is padded for 2 ranks."""
  rng = np.random.RandomState(4)
  d = np.concatenate([rng.uniform(-0.03, 0.03, (h, w, 2)),
                      np.ones((h, w, 1))], -1)
  d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
  o = np.broadcast_to(np.array([0.1, -0.05, -4.0], np.float32),
                      d.shape).copy()
  return TRays(o, d, d, np.full((h, w, 1), 1e-3, np.float32))


def _spec(tmp):
  """The runs: radiance, 'all', a K = 2 window, the JAX-matched radiance
  step pair (randomized off, JAX's weights and jitters) and a render."""
  args = _args("radiance", "scan")
  _, _, port, b0 = _setup(args)
  b1 = dict(b0, pixels=np.random.RandomState(9).rand(
      *b0["pixels"].shape).astype(np.float32))
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(64, 1.5, 0.33)
  jit = lambda i: t_nerf.make_jitter(args.num_coarse_samples,
                                     args.num_path_samples,
                                     torch.Generator().manual_seed(i))
  steps = [{"host": _host(b), "alpha": 0.5, "count": 5 + i, "jitter": jit(i)}
           for i, b in enumerate((b0, b1))]
  rng = random.PRNGKey(3)
  rng2 = random.split(rng, 4)[0]
  jax_steps = [{"host": _host(b0), "alpha": 0.5, "count": i,
                "jitter": _jitter(r, args)} for i, r in enumerate((rng,
                                                                    rng2))]
  noisy = {"randomized": True, "noise_std": 1.0}
  # A shorter path leaves transmittance over 0.5 (the background term's
  # mask) on the rays; the 'all' run keeps the far bound that bends them.
  short = {**noisy, "far": 3.0}
  spec = {
      "device": "cpu", "backend": None, "args": vars(args), "seed": 0,
      "scene": {"values": values, "ndim": ndim, "nmin": nmin, "nmax": nmax},
      "runs": [
          {"name": "radiance", "kind": "train", "k": 1, "noise_seed": 7,
           "args": {**short, "use_online_sparsity": True,
                    "grad_max_norm": 0.05},
           "steps": steps[:1]},
          {"name": "all", "kind": "train", "k": 1, "noise_seed": 7,
           "args": {**noisy, "stage": "all"}, "steps": steps[:1]},
          {"name": "window", "kind": "train", "k": 2, "noise_seed": 7,
           "args": short, "steps": steps},
          {"name": "jax", "kind": "train", "k": 1, "noise_seed": 7,
           "weights": {n: p.detach().clone()
                       for n, p in port.named_parameters()},
           "steps": jax_steps},
          {"name": "render", "kind": "render", "view": _view(),
           "jitter": jit(5), "chunk": 40, "chunks_per_dispatch": 2},
          {"name": "forward", "kind": "forward", "host": _host(b0),
           "alpha": 0.5, "jitter": jit(0)},
      ]}
  path = str(tmp / "spec.pt")
  torch.save(spec, path)
  return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
  """{"single": [out], "pair": [rank 0's, rank 1's], "world1": [out]}."""
  tmp = tmp_path_factory.mktemp("parallel")
  spec = _spec(tmp)
  cmd = lambda name: [sys.executable, "-m",
                      "samplenerfro_torch.debug.dist_worker", spec,
                      str(tmp / name)]
  started = {"single": _start(cmd("single")),
             "pair": _start(cmd("pair"), 2),
             "world1": _start(cmd("world1"), 1)}
  for procs in started.values():
    _finish(procs)
  return {name: [torch.load(f"{tmp / name}.{r}", weights_only=False)
                 for r in range(len(procs))]
          for name, procs in started.items()}


def _k3_close(got, want, what):
  for key, w in want.items():
    g = got[key]
    tol = K3_ATOL_SCALE * float(w.abs().max()) + K3_RTOL * w.abs()
    worst = float(((g - w).abs() - tol).max())
    assert worst <= 0, f"{what} {key}: past K3's form by {worst}"


@pytest.mark.parametrize("name", ["radiance", "all", "window"])
def test_two_ranks_step_the_global_batch(runs, name):
  want = runs["single"][0][name]
  ranks = [out[name] for out in runs["pair"]]
  assert [out["world"] for out in runs["pair"]] == [2, 2]
  assert runs["single"][0]["world"] == 1
  for got in ranks:
    assert len(got["stats"]) == len(want["stats"])
    for i, (g, w) in enumerate(zip(got["stats"], want["stats"])):
      for field in STATS:
        np.testing.assert_allclose(g[field], w[field], rtol=STATS_RTOL,
                                   atol=1e-12, err_msg=f"{name} {i} {field}")
    for g, w in zip(got["grads"], want["grads"]):
      assert sorted(g) == sorted(w)
      _k3_close(g, w, f"{name} grad")
  # Replicated: both ranks hold the same parameters and moments.
  for key, value in ranks[0]["state"].items():
    assert torch.equal(value, ranks[1]["state"][key]), key
  # The ratio and replicated terms are live, and the 'all' step trains the
  # so3 head.
  assert want["stats"][0]["loss_bg_smooth"] > 0
  if name == "all":
    assert max(float(g.abs().max()) for k, g in want["grads"][0].items()
               if k.startswith("path_sampler.")) > 0
  else:
    assert want["stats"][0]["loss_bg"] > 0


def test_two_ranks_render_the_view(runs):
  want = runs["single"][0]["render"]
  for out in runs["pair"]:
    got = out["render"]
    for key in ("rgb", "distance", "acc"):
      assert got[key].shape == want[key].shape
      np.testing.assert_allclose(got[key], want[key], atol=RENDER_ATOL,
                                 rtol=0, err_msg=key)
  # Each rank's forward rows are the single process's rows.
  want = runs["single"][0]["forward"]
  assert want["rows"] == (0, 256)
  for r, out in enumerate(runs["pair"]):
    lo, hi = out["forward"]["rows"]
    assert (lo, hi) == (128 * r, 128 * (r + 1))
    np.testing.assert_allclose(out["forward"]["rgb"], want["rgb"][lo:hi],
                               atol=RENDER_ATOL, rtol=0)


def test_two_ranks_radiance_step_matches_jax(runs):
  """The JAX step of the 256-ray batch against the 2-rank step (128 rays
  a rank), as tests/test_torch_train.py holds the single-process one."""
  args = _args("radiance", "scan")
  model, variables, _, b = _setup(args)
  tx, lr_fn, _ = j_step.create_optimizer(args)
  state = TrainState.create(apply_fn=model.apply,
                            params=variables["params"], tx=tx)
  tstep = j_step.make_train_step(model, args, {"grid": variables["grid"]},
                                 donate=False)
  jbatch = _jax_batch(b)
  state1, j_stats, rng2 = tstep(random.PRNGKey(3), state, jbatch)
  state2, _, _ = tstep(rng2, state1, jbatch)
  got = runs["pair"][1]["jax"]
  for name in STATS + ("march_oow",):
    np.testing.assert_allclose(got["stats"][0][name],
                               float(getattr(j_stats, name)), rtol=1e-5,
                               atol=1e-7, err_msg=name)
  mu = state1.opt_state.inner_states["adam_lr_scheduler"].inner_state[0].mu
  mu = {k: v for k, v in mu.items() if isinstance(v, dict)}
  want = {k: v.numpy() / np.float32(0.1) for k, v in convert.params_from_flax(
      jax.tree_util.tree_map(np.asarray, mu)).items()}
  for key, w in want.items():
    np.testing.assert_allclose(got["grads"][0][key].numpy(), w, rtol=0,
                               atol=1e-4 * max(float(np.abs(w).max()), 1e-12),
                               err_msg=key)
  want = convert.params_from_flax(
      jax.tree_util.tree_map(np.asarray, state2.params))
  for key, w in want.items():
    np.testing.assert_allclose(got["state"][f"param {key}"].numpy(),
                               w.numpy(), rtol=0, atol=2 * lr_fn(1),
                               err_msg=key)


def _same(got, want, path=""):
  """Equal bit for bit, but for the runs' host seconds."""
  if isinstance(want, dict):
    assert sorted(got) == sorted(want), path
    for k in want:
      if k != "seconds":
        _same(got[k], want[k], f"{path}/{k}")
  elif isinstance(want, (list, tuple)):
    assert len(got) == len(want), path
    for i, (g, w) in enumerate(zip(got, want)):
      _same(g, w, f"{path}/{i}")
  elif torch.is_tensor(want):
    assert torch.equal(got, want), path
  elif isinstance(want, np.ndarray):
    np.testing.assert_array_equal(got, want, err_msg=path)
  else:
    assert got == want or (got != got and want != want), path


def test_world_one_is_no_ranks_bit_for_bit(runs):
  got, want = dict(runs["world1"][0]), dict(runs["single"][0])
  assert (got.pop("world"), want.pop("world")) == (1, 1)
  _same(got, want)


class _NoThread(j_datasets.Blender):
  def start(self):
    pass


class _NoThreadGrid(j_datasets.Grid):
  def start(self):
    pass


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
  root = tmp_path_factory.mktemp("parallel_scene")
  return fixtures.make_scene(str(root / "scene"), num_train=3, num_test=1,
                             res=24, grid_n=12)


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("batching", ["single_image", "tile"])
def test_rank_draws_match_jax_under_two_processes(scene, monkeypatch, rank,
                                                  batching):
  monkeypatch.setattr(jax, "process_count", lambda: 2)
  monkeypatch.setattr(mesh, "world", lambda: 2)
  assert t_loop.DATA_SEED == 20201473
  args = helpers.tiny_args(data_dir=scene, batching=batching, batch_size=64,
                           bg_patch_size=6, tile_size=4, tile_stride=1,
                           tile_images=False, factor=0, extra_batch_size=16)
  j_ds = _NoThread("train", args)
  t_ds = t_datasets.TrainBatches(args, np.random.RandomState(
      t_loop.DATA_SEED + rank))
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(24, 1.5, 0.33)
  j_grid = _NoThreadGrid("train", args, values, ndim, nmax, nmin)
  t_grid = t_datasets.Grid(args, values, ndim, nmax, nmin,
                           np.random.RandomState(t_loop.DATA_SEED + rank))
  assert t_ds.batch_size == j_ds.batch_size == 32
  assert t_grid.extra_batch_size == j_grid.extra_batch_size == 8
  np.random.seed(20201473 + rank)
  for _ in range(2):
    want, got = j_ds._next_train(), next(t_ds)
    np.testing.assert_array_equal(got["pixels"], want["pixels"])
    for g, w in zip(list(got["rays"]) + list(got["env_rays"]),
                    list(want["rays"]) + list(want["env_rays"])):
      np.testing.assert_array_equal(g, w)
  np.random.seed(20201473 + rank)
  for _ in range(2):
    want, got = j_grid._next_train(), next(t_grid)
    for key in ("pts", "grads"):
      np.testing.assert_array_equal(got[key], want[key])


def _cli(scene, cfg, out, *extra):
  return [f"--data_dir={scene}", f"--train_dir={out}", f"--config={cfg}",
          f"--gin_file={cfg}.gin", "--device=cpu", "--stage=all",
          "--chunk=128", *extra]


def test_train_and_eval_entry_points_on_two_ranks(scene, tmp_path):
  cfg = fixtures.write_tiny_config(str(tmp_path / "cfg"))
  out = tmp_path / "out"
  train = [sys.executable, "-m", "samplenerfro_torch.train"]
  first = _finish(_start(train + _cli(scene, cfg, out, "--max_steps=3",
                                      "--save_every=2", "--render_every=3"),
                         2))
  stage_dir = out / "all"
  assert sorted(os.listdir(stage_dir)) == ["checkpoint_2", "checkpoint_3"]
  lines = [l for l in first[0].splitlines() if "/3:" in l]
  assert len(lines) == 3 and "Eval 3:" in first[0]
  assert first[1].strip() == ""
  # Both ranks resume from checkpoint_3 (a rank that did not would run
  # other steps, and the collectives would not pair).
  again = _finish(_start(train + _cli(scene, cfg, out, "--max_steps=4",
                                      "--save_every=2"), 2))
  assert [l.split(":")[0].strip() for l in again[0].splitlines()
          if "/4:" in l] == ["4/4"] and again[1].strip() == ""
  saved = torch.load(stage_dir / "checkpoint_4", weights_only=True)
  assert {int(s["step"]) for s in saved["optimizer"]["state"].values()} == {4}

  shutil.copytree(out, tmp_path / "out1")
  ev = [sys.executable, "-m", "samplenerfro_torch.eval"]
  procs = (_start(ev + _cli(scene, cfg, out), 2)
           + _start(ev + _cli(scene, cfg, tmp_path / "out1")))
  outs = _finish(procs)
  assert outs[1].strip() == "" and "PSNR = " in outs[0]
  preds, preds1 = stage_dir / "test_preds", tmp_path / "out1/all/test_preds"
  assert sorted(os.listdir(preds)) == sorted(os.listdir(preds1))
  psnr = float((preds / "psnr.txt").read_text())
  assert np.isfinite(psnr)
  np.testing.assert_allclose(psnr, float((preds1 / "psnr.txt").read_text()),
                             rtol=1e-6)


def test_only_rank_zero_writes_a_checkpoint(tmp_path, monkeypatch):
  args = _args("radiance", "scan")
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(8, 1.5, 0.33)
  model = t_nerf.construct_nerf(args, ndim, nmin, nmax, values, device="cpu")
  optimizer, _, _ = t_step.create_optimizer(model, args)
  monkeypatch.setattr(mesh, "rank", lambda: 1)
  assert t_ckpt.save_checkpoint(str(tmp_path), model, optimizer, 3) is None
  assert os.listdir(tmp_path) == []
  monkeypatch.setattr(mesh, "rank", lambda: 0)
  assert t_ckpt.save_checkpoint(str(tmp_path), model, optimizer, 3)
  assert os.listdir(tmp_path) == ["checkpoint_3"]


def test_refusals(scene, monkeypatch):
  monkeypatch.setattr(mesh, "world", lambda: 2)
  args = helpers.tiny_args(data_dir=scene, batch_size=33, factor=0)
  with pytest.raises(ValueError, match="batch_size=33 must be divisible"):
    t_datasets.TrainBatches(args, np.random.RandomState(0))
  # Tile batching: 48 rays a step are 24 a rank, no multiple of 4^2.
  tiles = t_datasets.TrainBatches(
      helpers.tiny_args(data_dir=scene, batch_size=48, factor=0,
                        batching="tile", tile_size=4, tile_stride=1,
                        tile_images=False, bg_patch_size=0),
      np.random.RandomState(0))
  with pytest.raises(ValueError, match="multiple of tile_size"):
    next(tiles)
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(8, 1.5, 0.33)
  with pytest.raises(ValueError, match="extra_batch_size=15"):
    t_datasets.Grid(helpers.tiny_args(extra_batch_size=15), values, ndim,
                    nmax, nmin, np.random.RandomState(0))
  with pytest.raises(ValueError, match="rows=7"):
    mesh.local_rows(7)
  monkeypatch.undo()
  # NCCL without CUDA, and an init that cannot reach its rendezvous.
  for k in DIST_ENV:
    monkeypatch.delenv(k, raising=False)
  monkeypatch.setenv("WORLD_SIZE", "2")
  monkeypatch.setenv("RANK", "0")
  with pytest.raises(ValueError, match="NCCL needs CUDA"):
    with mesh.process_group("cpu", "nccl"):
      pass
  with pytest.raises(ValueError, match="MASTER_ADDR"):
    with mesh.process_group("cpu"):
      pass
  assert not mesh.active()
