"""The port's multi-step dispatch, prefetch and grouped render on the CPU.

The port's K steps
against samplenerfro_tpu.train.step.make_train_step_multi from the same
weights, batches and jitters, at tests/test_torch_train.py's tolerances
(the first step's Stats at rtol 1e-5, parameters at 2 * the lr of each
update that moves them). Then the CLI: --steps_per_dispatch=3 writes the
single-step run's checkpoint, an off-grid resume the same final one, and
a cadence that is not a multiple of K raises (tests/test_e2e_smoke.py:60
for the JAX package). Then data/prefetch.py (order, end, early close, a
worker's exception) and render_chunks_per_dispatch of 2, 4 and 8 bit for
bit against one chunk a call, with a ragged tail
(tests/test_render_image.py:88). The K steps against sequential steps
are in tests/test_torch_dispatch_steps.py, a file of their own so that
pytest-xdist's --dist loadfile runs them on another worker. The
CUDA graph itself is held against eager steps on the card in
tests/test_torch_cuda.py.
"""

import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.training.train_state import TrainState
from jax import random

from samplenerfro_torch import eval as t_eval
from samplenerfro_torch.data import prefetch
from samplenerfro_torch.data.rays import Rays as TRays
from samplenerfro_torch.models import convert
from samplenerfro_torch.models import nerf as t_nerf
from samplenerfro_torch.ops import march_kernel as t_march
from samplenerfro_torch.train import checkpoints as t_ckpt
from samplenerfro_torch.train import loop as t_loop
from samplenerfro_torch.train import step as t_step
from samplenerfro_torch.utils import grid_io
from samplenerfro_torch.utils import render as t_render
from samplenerfro_tpu.data.rays import Rays as JRays
from samplenerfro_tpu.models import construct_nerf
from samplenerfro_tpu.train import step as j_step
from tests import fixtures, helpers

NRAYS, PATCH, GRID = 64, 4, 32


def _args(stage, **kw):
  base = dict(march_mode="scan", march_emit="lean", tile_size=16,
              march_window=16, march_refetch=4, net_depth=2, net_width=32,
              num_coarse_samples=8, num_path_samples=4, num_fine_samples=16,
              stage=stage, grad_max_norm=0.0, bg_patch_size=PATCH,
              max_deg_point=4, anneal_delay_steps=1, anneal_max_steps=20,
              lr_delay_steps=2)
  base.update(kw)
  return helpers.tiny_args(**base)


def _host_batch(seed):
  """One step's host batch, as datasets.TrainBatches yields it."""
  rng = np.random.RandomState(seed)
  d = np.array([0.0, 0.0, 1.0]) + 0.05 * rng.randn(NRAYS, 3)
  d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
  o = (np.array([0.1, -0.05, -4.0]) + 0.1 * rng.randn(NRAYS, 3)).astype(
      np.float32)
  radii = np.full((NRAYS, 1), 1e-3, np.float32)
  env = rng.randn(PATCH, PATCH, 3).astype(np.float32)
  env /= np.linalg.norm(env, axis=-1, keepdims=True)
  return {"pixels": rng.rand(NRAYS, 3).astype(np.float32),
          "rays": TRays(o, d, d, radii),
          "env_rays": TRays(env, env, env,
                            np.full((PATCH, PATCH, 1), 1e-3, np.float32))}


def _grid():
  return grid_io.synthetic_blob_grid(GRID, 1.5, 0.33)


def _model(args, seed=0):
  values, ndim, nmin, nmax = _grid()
  return t_nerf.construct_nerf(args, ndim, nmin, nmax, values, device="cpu",
                               seed=seed)


def _state(model, optimizer):
  """Parameters, Adam moments and counts, as tensors."""
  out = {f"p.{k}": v.detach().clone() for k, v in model.named_parameters()}
  for i, (k, v) in enumerate(optimizer.state_dict()["state"].items()):
    for name, t in v.items():
      out[f"s{k}.{name}"] = torch.as_tensor(t).clone()
  return out


def _assert_equal_state(a, b):
  assert a.keys() == b.keys()
  for k in a:
    assert torch.equal(a[k], b[k]), k


def _windows(first, last, k):
  return list(t_loop.dispatch_windows(first, last, k))


def test_multi_step_matches_jax_multi_step():
  """3 'all' steps, randomized=False: the port's K-step dispatch against
  the JAX package's make_train_step_multi (a lax.scan) from the same
  weights, batches and the jitters the JAX rng chain draws."""
  k, first = 3, 5
  args = _args("all", randomized=False)
  values, ndim, nmin, nmax = _grid()
  hosts = [_host_batch(s) for s in range(first, first + k)]
  jrays = JRays(*map(jnp.asarray, hosts[0]["rays"]))
  model, variables = construct_nerf(random.PRNGKey(0), {"rays": jrays}, args,
                                    ndim, nmin, nmax, values)
  port = t_nerf.construct_nerf(args, ndim, nmin, nmax, values, device="cpu")
  convert.load_into(port, convert.params_from_flax(
      jax.tree_util.tree_map(np.asarray, variables["params"])))

  tx, lr_fn, _ = j_step.create_optimizer(args)
  state = TrainState.create(apply_fn=model.apply,
                            params=variables["params"], tx=tx)
  jbatches = [{"rays": JRays(*map(jnp.asarray, h["rays"])),
               "env_rays": JRays(*map(jnp.asarray, h["env_rays"])),
               "pixels": jnp.asarray(h["pixels"]),
               "annealed_alpha": jnp.float32(t_loop.annealed_alpha(s, args)),
               "coarse_alpha_target": jnp.float32(0.0),
               "fine_alpha_target": jnp.float32(0.0)}
              for s, h in zip(range(first, first + k), hosts)]
  stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jbatches)
  tmulti = j_step.make_train_step_multi(model, args,
                                        {"grid": variables["grid"]},
                                        donate=False)
  rng = random.PRNGKey(3)
  jstate, jstats, _ = tmulti(rng, state, stacked)

  jitters = []
  for _ in range(k):
    key_0 = random.split(rng, 4)[1]
    key, _ = random.split(key_0)
    base = jnp.arange(0, args.num_coarse_samples * args.num_path_samples,
                      args.num_path_samples)
    jitters.append(np.asarray(base + random.randint(
        key, [args.num_coarse_samples], 0, args.num_path_samples)))
    rng = random.split(rng, 4)[0]
  optimizer, _, _ = t_step.create_optimizer(port, args)
  # The JAX optimizer counts from 0: the port's rates of its updates
  # 0 .. k-1.
  host = prefetch.stack([
      t_loop.step_batch(h, t_loop.annealed_alpha(s, args),
                        t_step.learning_rates(optimizer, c),
                        torch.from_numpy(j), args)
      for c, (s, h, j) in enumerate(zip(range(first, first + k), hosts,
                                        jitters))])
  run = t_step.make_train_step_multi(port, optimizer, args, k)
  stats = run(prefetch.to_device(host, "cpu"))
  got = stats.per_step()
  for name in ("loss", "psnr", "loss_c", "psnr_c", "weight_l2", "loss_bg",
               "loss_bg_smooth", "annealing_rate"):
    np.testing.assert_allclose(getattr(got[0], name),
                               float(getattr(jstats, name)[0]), rtol=1e-5,
                               atol=1e-7, err_msg=name)
  want = {kk: v.numpy() for kk, v in convert.params_from_flax(
      jax.tree_util.tree_map(np.asarray, jstate.params)).items()}
  moved = 2 * sum(lr_fn(c) for c in range(k))
  for kk, w in want.items():
    np.testing.assert_allclose(port.get_parameter(kk).detach().numpy(), w,
                               atol=moved, rtol=0, err_msg=kk)


def test_dispatch_windows_align_to_the_k_grid():
  assert _windows(1, 10, 3) == [(1, 3), (4, 6), (7, 9), (10, 10)]
  assert _windows(5, 12, 3) == [(5, 6), (7, 9), (10, 12)]
  assert _windows(4, 4, 3) == [(4, 4)]
  assert _windows(3, 5, 1) == [(3, 3), (4, 4), (5, 5)]
  assert _windows(7, 6, 3) == []


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
  root = tmp_path_factory.mktemp("dispatch_scene")
  return fixtures.make_scene(str(root / "scene"), num_train=3, num_test=1,
                             res=24, grid_n=12)


def _ckpt(train_dir, step):
  return torch.load(os.path.join(train_dir, "all", f"checkpoint_{step}"),
                    weights_only=True)


def _assert_same_checkpoint(a, b):
  assert a["step"] == b["step"]
  assert a["model"].keys() == b["model"].keys()
  for k in a["model"]:
    assert torch.equal(a["model"][k], b["model"][k]), k
  sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
  assert sa.keys() == sb.keys()
  for i in sa:
    for name in ("step", "exp_avg", "exp_avg_sq"):
      assert torch.equal(torch.as_tensor(sa[i][name]),
                         torch.as_tensor(sb[i][name])), (i, name)


def test_cli_steps_per_dispatch_writes_the_single_step_checkpoint(
    scene, tmp_path):
  """6 'all' steps with --steps_per_dispatch=3 write single steps'
  checkpoint_6; a run stopped at step 2 and resumed off the K grid (a
  window of 1, then one of 3) writes the same checkpoint_6 as the same
  resume step by step."""
  cfg = fixtures.write_tiny_config(str(tmp_path / "cfg"))
  common = lambda out: [f"--data_dir={scene}", f"--train_dir={out}",
                        f"--config={cfg}", f"--gin_file={cfg}.gin",
                        "--device=cpu", "--stage=all"]
  k3 = ["--steps_per_dispatch=3", "--print_every=3", "--save_every=3",
        "--gc_every=3"]
  single, multi = tmp_path / "single", tmp_path / "multi"
  t_loop.main(common(single) + ["--max_steps=6"])
  t_loop.main(common(multi) + ["--max_steps=6"] + k3)
  _assert_same_checkpoint(_ckpt(single, 6), _ckpt(multi, 6))

  resumed_single, resumed_multi = tmp_path / "rs", tmp_path / "rm"
  for out in (resumed_single, resumed_multi):
    t_loop.main(common(out) + ["--max_steps=2", "--save_every=2"])
  t_loop.main(common(resumed_single) + ["--max_steps=6"])
  t_loop.main(common(resumed_multi) + ["--max_steps=6"] + k3)
  _assert_same_checkpoint(_ckpt(resumed_single, 6),
                          _ckpt(resumed_multi, 6))


@pytest.mark.parametrize("cadence", t_loop.CADENCES)
def test_cadence_not_a_multiple_of_k_raises(scene, tmp_path, cadence):
  cfg = fixtures.write_tiny_config(str(tmp_path / "cfg"))
  flags = [f"--data_dir={scene}", f"--train_dir={tmp_path / 'out'}",
           f"--config={cfg}", f"--gin_file={cfg}.gin", "--device=cpu",
           "--steps_per_dispatch=3", "--print_every=3", "--save_every=3",
           "--gc_every=3", "--render_every=0", f"--{cadence}=4"]
  with pytest.raises(ValueError, match=f"--{cadence}=4 must be a multiple"):
    t_loop.main(flags)
  assert not os.path.exists(tmp_path / "out")


def _threads_named(name):
  return [t for t in threading.enumerate() if t.name == name and
          t.is_alive()]


def test_prefetch_keeps_the_order_and_ends():
  items = iter(range(7))

  def fn():
    i = next(items, None)
    return None if i is None else {"x": np.full((2, 3), i),
                                   "i": np.full((2,), i)}

  got = [b["x"].tolist() for b in prefetch.device_prefetch(
      fn, "cpu", size=2, stacked=True)]
  assert got == [[[i] * 3] * 2 for i in range(7)]


def test_prefetch_raises_the_workers_exception():
  calls = []

  def fn():
    calls.append(1)
    if len(calls) == 3:
      raise KeyError("batch 3")
    return {"x": np.zeros(2)}

  it = prefetch.device_prefetch(fn, "cpu", size=3)
  assert next(it)["x"].shape == (2,) and next(it)["x"].shape == (2,)
  with pytest.raises(KeyError, match="batch 3"):
    next(it)


def test_prefetch_stops_its_worker_when_closed():
  before = len(_threads_named("device_prefetch"))
  it = prefetch.device_prefetch(lambda: {"x": np.zeros(3)}, "cpu", size=2)
  next(it)
  time.sleep(0.2)  # the worker fills the queue and waits on it
  it.close()
  deadline = time.time() + 10
  while len(_threads_named("device_prefetch")) > before and (
      time.time() < deadline):
    time.sleep(0.05)
  assert len(_threads_named("device_prefetch")) == before


def test_prefetch_refuses_a_ragged_stack():
  it = prefetch.device_prefetch(
      lambda: {"a": np.zeros((3, 2)), "b": np.zeros((2,))}, "cpu",
      stacked=True)
  with pytest.raises(ValueError, match="leading step axis"):
    next(it)


def test_checked_jitter_checks_each_step():
  s = 32
  good = torch.arange(0, s, 4) + torch.tensor([1, 0, 3, 2, 1, 1, 0, 3])
  with pytest.raises(ValueError, match=r"jitter\[c\]"):
    t_march.checked_jitter(good.flip(0), s)
  checked = t_march.checked_jitter(good.to(torch.int32), s)
  assert checked.indices.dtype == torch.int64
  # A window's stack (loop.host_window), its copy and a step's slice of it
  # (MultiStep slices each leaf) keep the type.
  window = prefetch.to_device(prefetch.stack(
      [{"jitter": checked}, {"jitter": t_march.checked_jitter(good, s)}]),
      "cpu")
  one = prefetch.map_tensors(lambda t: t[1], window)["jitter"]
  assert isinstance(one, t_march.CheckedJitter)
  assert torch.equal(one.indices, good)


@pytest.mark.parametrize("stage", ["radiance", "all"])
@pytest.mark.parametrize("per_dispatch", [2, 4, 8])
def test_render_chunks_per_dispatch_is_bit_exact(stage, per_dispatch):
  """A 20x18 view in chunks of 48 (7 full chunks and a ragged tail of 24):
  2, 4 or 8 chunks a dispatch (a ragged last group, or one group) give
  the one-chunk render bit for bit, chunk by chunk in the same order."""
  args = _args(stage)
  model = _model(args, seed=1)
  rng = np.random.RandomState(2)
  d = np.array([0.0, 0.0, 1.0]) + 0.1 * rng.randn(18, 20, 3)
  d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
  o = np.broadcast_to(np.array([0.1, -0.05, -4.0], np.float32),
                      d.shape).copy()
  view = TRays(o, d, d, np.full((18, 20, 1), 1e-3, np.float32))
  jitter = t_nerf.make_jitter(args.num_coarse_samples,
                              args.num_path_samples,
                              torch.Generator().manual_seed(0))
  render_fn = t_eval.make_render_fn(model, jitter)
  sizes = {}

  def recording(rays, key):
    sizes.setdefault(key, []).append(rays.origins.shape[0])
    return render_fn(rays)

  one = t_render.render_image(lambda r: recording(r, 1), view, False,
                              chunk=48, device="cpu")
  grouped = t_render.render_image(lambda r: recording(r, per_dispatch), view,
                                  False, chunk=48, device="cpu",
                                  chunks_per_dispatch=per_dispatch)
  for a, b in zip(one, grouped):
    assert a.shape == b.shape and np.array_equal(a, b)
  assert one[0].shape == (18, 20, 3)
  assert sizes[1] == sizes[per_dispatch] == [48] * 7 + [24]


def test_adam_loads_a_torch_optim_checkpoint():
  """A torch.optim.Adam state_dict (checkpoints of earlier runs) loads
  into the port's Adam: moments and counts, group by group."""
  args = _args("all")
  model = _model(args)
  optimizer, _, _ = t_step.create_optimizer(model, args)
  groups = [{"params": g["params"], "name": g["name"], "label": g["label"]}
            for g in optimizer.param_groups]
  ref = torch.optim.Adam(groups, lr=1e-3)
  for p in model.parameters():
    p.grad = torch.randn_like(p)
  ref.step()
  ref.step()
  t_ckpt._load_optimizer(optimizer, ref.state_dict())
  for p in model.parameters():
    if p in ref.state:
      assert torch.equal(optimizer.state[p]["exp_avg"],
                         ref.state[p]["exp_avg"])
      assert torch.equal(optimizer.state[p]["exp_avg_sq"],
                         ref.state[p]["exp_avg_sq"])
  assert [float(c) for c in optimizer.counts] == [2.0] * len(groups)
