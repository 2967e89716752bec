"""The fused-MLP slice (--mlp_kernel=pallas|pallas_pe) against the JAX
package's.

The JAX NerfModel takes its fused path only on a TPU backend
(samplenerfro_tpu/models/nerf.py:284). Here pytest's monkeypatch swaps its
`_use_fused_mlp` for the same gate without the backend test, and
`ops/pallas/mlp_kernel.fused_nerf_mlp` for the same function in interpret
mode; nothing in the JAX package changes, and each test checks that the
JAX fused kernel did run. The port runs its plain K4/K5 versions (CPU
tensors). Shapes are the small supported spec (trunk 4x128, skip 2,
condition width 128), point encoding to degree 4 as tests/test_torch_train.py
explains.

Compared: the two-level render (rgb, distance, acc, trans, trans_rgb_bkgd)
at atol = rtol = 1e-4 in fp32, the tolerance and reasons of
tests/test_torch_model.py; in bf16 at atol 2e-3 (measured 2.0e-4 with
either encoding: the bf16 MLPs differ by a rounding flip now and then,
tests/test_torch_mlp_kernel.py, and the fine samples, placed by the coarse
weights, carry it on). One radiance train step: the loss and every Stats
field at rtol 1e-5, every gradient at 1e-4 of its scale
(tests/test_torch_train.py's convention). The weights come from JAX init
key 2: at keys 0 and 1 a fine sample's pre-activation lies within the
march's ulps of a ReLU kink, and the port's nn.Linear path and its fused
path then stand alike at 1.16 and 5.8 of that tolerance from the JAX step
on one weight (while agreeing with each other to 0.003 of it); key 2 has no
such sample, so the comparison sees the MLP. Then the gates (the 'all' stage
keeps nn.Linear; unknown kernels and non-ReLU activations raise) and the
train and eval entry points on a tiny scene at width 128.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.training.train_state import TrainState
from jax import random

from samplenerfro_torch import eval as t_eval
from samplenerfro_torch.models import convert
from samplenerfro_torch.models import nerf as t_nerf
from samplenerfro_torch.ops import mlp_kernel
from samplenerfro_torch.train import loop as t_loop
from samplenerfro_torch.train import step as t_step
from samplenerfro_torch.utils import grid_io
from samplenerfro_tpu.data.rays import Rays as JRays
from samplenerfro_tpu.models import construct_nerf
from samplenerfro_tpu.models import nerf as j_nerf
from samplenerfro_tpu.ops.pallas import mlp_kernel as j_kernel
from samplenerfro_tpu.train import step as j_step
from tests import fixtures
from tests import test_torch_train as ttt

WIDTHS = dict(net_depth=4, net_width=128, net_width_condition=128,
              skip_layer=2)
NAMES = ("comp_rgb", "distance", "acc", "trans", "trans_rgb_bkgd")


@pytest.fixture
def jax_fused(monkeypatch):
  """Force the JAX model's fused MLP on the CPU; returns its call count."""
  calls = []
  interpret = functools.partial(j_kernel.fused_nerf_mlp, interpret=True)

  def fused(*args, **kwargs):
    calls.append(kwargs.get("pe"))
    return interpret(*args, **kwargs)

  def use_fused(self, samples_enc, viewdirs_enc):
    return (self.mlp_kernel in ("pallas", "pallas_pe")
            and not self.is_initializing() and self.use_viewdirs
            and self.sh_deg < 0 and not self.stage.startswith("all")
            and j_kernel.supports(
                samples_enc.shape[-1], viewdirs_enc.shape[-1],
                self.net_depth, self.net_width, self.skip_layer,
                self.net_depth_condition, self.net_width_condition,
                self.num_rgb_channels, self.num_sigma_channels))

  monkeypatch.setattr(j_nerf.NerfModel, "_use_fused_mlp", use_fused)
  monkeypatch.setattr(j_kernel, "fused_nerf_mlp", fused)
  return calls


def _setup(args, key=2):
  """tests/test_torch_train.py's setup with JAX init key `key`."""
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(64, 1.5, 0.33)
  b = ttt._batch()
  model, variables = construct_nerf(
      random.PRNGKey(key), {"rays": JRays(*map(jnp.asarray, b["rays"]))},
      args, ndim, nmin, nmax, values)
  port = t_nerf.construct_nerf(args, ndim, nmin, nmax, values, device="cpu")
  params = jax.tree_util.tree_map(np.asarray, variables["params"])
  convert.load_into(port, convert.params_from_flax(params))
  return model, variables, port, b


def _port_calls(monkeypatch):
  """Count the port model's calls of the fused MLP."""
  calls = []
  original = mlp_kernel.fused_nerf_mlp

  def fused(*args, **kwargs):
    calls.append(kwargs.get("pe"))
    return original(*args, **kwargs)

  monkeypatch.setattr(mlp_kernel, "fused_nerf_mlp", fused)
  return calls


@pytest.mark.parametrize("mlp_kernel_name,mlp_dtype", [
    ("pallas", "float32"), ("pallas_pe", "float32"),
    ("pallas", "bfloat16"), ("pallas_pe", "bfloat16")])
def test_fused_render_matches_jax(jax_fused, monkeypatch, mlp_kernel_name,
                                  mlp_dtype):
  args = ttt._args("radiance", "scan", mlp_kernel=mlp_kernel_name,
                   mlp_dtype=mlp_dtype, **WIDTHS)
  model, variables, port, b = _setup(args)
  port_calls = _port_calls(monkeypatch)
  rng = random.PRNGKey(3)
  ret, _ = model.apply(variables, random.split(rng, 4)[1],
                       random.split(rng, 4)[2],
                       JRays(*map(jnp.asarray, b["rays"])), False, 0.5)
  pe = ((args.max_deg_point, args.deg_view) if mlp_kernel_name == "pallas_pe"
        else None)
  assert jax_fused == [pe, pe]
  with torch.no_grad():
    got, _ = port(ttt._torch_batch(b)["rays"], ttt._jitter(rng, args),
                  annealed_alpha=0.5)
  assert port_calls == [pe, pe]
  tol = 1e-4 if mlp_dtype == "float32" else 2e-3
  for level, (g_level, w_level) in enumerate(zip(got, ret)):
    for name, g, w in zip(NAMES, g_level, w_level):
      np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol,
                                 rtol=1e-4, err_msg=f"level {level} {name}")


def test_fused_train_step_matches_jax(jax_fused):
  args = ttt._args("radiance", "scan", mlp_kernel="pallas", **WIDTHS)
  model, variables, port, b = _setup(args)
  tx, _, _ = j_step.create_optimizer(args)
  state = TrainState.create(apply_fn=model.apply,
                            params=variables["params"], tx=tx)
  tstep = j_step.make_train_step(model, args, {"grid": variables["grid"]},
                                 donate=False)
  rng = random.PRNGKey(3)
  state1, j_stats, _ = tstep(rng, state, ttt._jax_batch(b))
  assert len(jax_fused) == 2

  optimizer, _, _ = t_step.create_optimizer(port, args)
  stats = t_step.train_step(
      port, optimizer,
      ttt._step_batch(b, args, optimizer, 0, ttt._jitter(rng, args)),
      args).as_floats()
  for name in ttt.STATS:
    np.testing.assert_allclose(getattr(stats, name),
                               float(getattr(j_stats, name)), rtol=1e-5,
                               atol=1e-7, err_msg=name)
  mu = state1.opt_state.inner_states["adam_lr_scheduler"].inner_state[0].mu
  mu = {k: v for k, v in mu.items() if isinstance(v, dict)}
  want = {k: v.numpy() / np.float32(0.1) for k, v in convert.params_from_flax(
      jax.tree_util.tree_map(np.asarray, mu)).items()}
  got = {k: p.grad.numpy() for k, p in port.named_parameters()
         if k in want}
  assert any(k.startswith("fine_mlp.") for k in got)
  ttt._assert_close_tree(got, want,
                         lambda w: 1e-4 * max(float(np.abs(w).max()), 1e-12),
                         "grad")


def test_all_stage_keeps_linear_layers(monkeypatch):
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(16, 1.5, 0.33)
  rays = ttt._torch_batch(ttt._batch())["rays"]
  rays = type(rays)(*[r[:32] for r in rays])
  jitter = t_nerf.make_jitter(8, 4, torch.Generator().manual_seed(0))
  outs = {}
  for kernel in ("xla", "pallas"):
    args = ttt._args("all", "scan", mlp_kernel=kernel, **WIDTHS)
    port = t_nerf.construct_nerf(args, ndim, nmin, nmax, values,
                                 device="cpu", seed=0)
    calls = _port_calls(monkeypatch)
    with torch.no_grad():
      outs[kernel] = port(rays, jitter, annealed_alpha=0.5)[0]
    assert calls == []
  for g_level, w_level in zip(outs["pallas"], outs["xla"]):
    for g, w in zip(g_level, w_level):
      assert torch.equal(g, w)


@pytest.mark.parametrize("override,error", [
    ({"mlp_kernel": "triton"}, ValueError),
    ({"mlp_kernel": "pallas", "net_activation": "elu"}, NotImplementedError),
    ({"mlp_kernel": "pallas_pe", "net_activation": "silu"},
     NotImplementedError)])
def test_bad_fused_options_raise(override, error):
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(8, 1.5, 0.33)
  args = ttt._args("radiance", "scan", **WIDTHS)
  for k, v in override.items():
    setattr(args, k, v)
  with pytest.raises(error):
    t_nerf.construct_nerf(args, ndim, nmin, nmax, values, device="cpu")


def test_entry_points_run_the_fused_path(tmp_path, monkeypatch):
  scene = fixtures.make_scene(str(tmp_path / "scene"), num_train=2,
                              num_test=1, res=16, grid_n=12)
  cfg = fixtures.write_tiny_config(str(tmp_path / "cfg"))
  common = [f"--data_dir={scene}", f"--config={cfg}",
            f"--gin_file={cfg}.gin", "--device=cpu", "--stage=radiance",
            "--mlp_kernel=pallas_pe", "--net_width=128",
            "--net_width_condition=128"]
  calls = _port_calls(monkeypatch)
  model = t_loop.main(common + [f"--train_dir={tmp_path / 'out'}",
                                "--max_steps=2"])
  assert model.mlp_kernel == "pallas_pe" and len(calls) == 4
  assert set(calls) == {(10, 4)}
  assert os.path.exists(tmp_path / "out" / "radiance" / "checkpoint_2")
  npz = tmp_path / "w.npz"
  np.savez(npz, **convert.flatten({"params": convert.params_to_flax(model)}))
  del calls[:]
  res = t_eval.main(common + [f"--train_dir={tmp_path / 'ev'}",
                              f"--params_npz={npz}", "--chunk=128"])
  assert len(res.psnrs) == 1 and np.isfinite(res.psnrs[0])
  assert len(calls) == 2 * 2  # two chunks of the 16x16 view, two levels
  with pytest.raises(ValueError, match="mlp_kernel"):
    t_loop.main(common[:-3] + [f"--train_dir={tmp_path / 'x'}",
                               "--mlp_kernel=cuda"])
