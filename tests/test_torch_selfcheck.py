"""The port's self-check and ReLU-flip probe against the JAX package.

samplenerfro_torch/train/selfcheck.py is the counterpart of
samplenerfro_tpu/train/selfcheck.py, and samplenerfro_torch/debug/
probe_so3_relu.py with P3 (utils/probes.so3_preacts) that of
scripts/debug/probe_so3_relu.py. On the CPU every kernel wrapper runs its
plain version, so the gate is held to its inputs (bitwise the JAX gate's),
to its plumbing at a reduced size, and to failing when a kernel is off;
P3's plain version is held to the JAX probe's own Pallas kernel (interpret
mode) on the probe's own inputs.
"""

import functools
import io
import runpy
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch
from jax import random
from jax.experimental import pallas as pl

from samplenerfro_torch.debug import probe_so3_relu
from samplenerfro_torch.models import convert
from samplenerfro_torch.ops import grid as t_grid
from samplenerfro_torch.ops import march_kernel
from samplenerfro_torch.train import selfcheck as t_selfcheck
from samplenerfro_torch.utils import probes
from samplenerfro_tpu.ops import grid as j_grid
from samplenerfro_tpu.ops import mlp as j_mlp
from samplenerfro_tpu.train import selfcheck as j_selfcheck

ROOT = Path(__file__).resolve().parents[1]
LAYERS = ("Dense_0", "Dense_1", "Dense_2", "Dense_3", "Dense_out")
# The port's plain P3 against the JAX probe's Pallas kernel: fp32 products
# summed in other orders by torch and XLA on the CPU (measured 3.0e-7).
P3_ATOL = 1e-5
# A size at which the CPU runs the whole gate in seconds.
REDUCED = dict(grid_n=32, num_samples=64, block_size=128, nblocks=2,
               grad_samples=24)


def _flat_so3(tree):
  """A flax so3 head's Dense_* kernels and biases in the port's flat
  [W_0, b_0, ..., W_out, b_out] layout, carried as models/convert.py
  carries the path sampler's head."""
  sd = convert.params_from_flax({"path_sampler": {"so3_mlp": tree}})
  return [sd[f"path_sampler.so3_mlp.layers.{name}.{kind}"]
          for name in LAYERS for kind in ("weight", "bias")]


def _jax_so3():
  return j_mlp.mlp_init(random.PRNGKey(7), 60, net_depth=4, net_width=128,
                        skip_layer=2, num_out_channels=3,
                        output_init_std=1e-2)


@pytest.fixture(scope="module")
def jax_probe():
  """scripts/debug/probe_so3_relu.py's globals after a run with its Pallas
  kernel in interpret mode, and its printed lines."""
  mp = pytest.MonkeyPatch()
  mp.setattr(pl, "pallas_call", functools.partial(pl.pallas_call,
                                                  interpret=True))
  mp.setattr(sys, "path", list(sys.path))
  out = io.StringIO()
  try:
    with redirect_stdout(out):
      script = runpy.run_path(str(ROOT / "scripts/debug/probe_so3_relu.py"),
                              run_name="__main__")
  finally:
    mp.undo()
  return script, out.getvalue().splitlines()


def test_p3_plain_version_matches_jax_probe_kernel(jax_probe):
  script, lines = jax_probe
  pos = torch.from_numpy(np.array(script["pos"]).reshape(-1, 3))
  so3 = _flat_so3(script["so3"])
  got = probes.so3_preacts(pos, so3, script["alpha"], script["max_deg"])
  want = probes.so3_preacts_reference(pos, so3, script["alpha"],
                                      script["max_deg"])
  assert all(torch.equal(a, b) for a, b in zip(got, want))
  assert len(lines) == 3
  for layer, (line, g, k, x) in enumerate(
      zip(lines, got, script["k_pre"], script["x_pre"]), 1):
    g = g.numpy()
    assert g.shape == k.shape == (pos.shape[0], 128)
    np.testing.assert_allclose(g, k, rtol=0, atol=P3_ATOL,
                               err_msg=f"layer {layer}")
    jax_flips = int(np.sum((k > 0) != (x > 0)))
    assert f"relu flips {jax_flips} of " in line
    assert int(np.sum((g > 0) != (x > 0))) == jax_flips


def test_probe_module_prints_the_jax_scripts_lines(jax_probe):
  _, jax_lines = jax_probe
  out = io.StringIO()
  with redirect_stdout(out):
    probe_so3_relu.main(["--device=cpu"])
  lines = out.getvalue().splitlines()
  assert [line.split(":")[0] for line in lines] == [
      line.split(":")[0] for line in jax_lines]
  for line in lines:
    assert " of 6291456 (min |preact| " in line


def test_probe_on_the_cpu_counts_no_flip():
  pos = torch.from_numpy(np.random.RandomState(0).uniform(
      -1.5, 1.5, (4, 6, 3)).astype(np.float32))
  before = probes.so3_preacts.launches
  layers = probe_so3_relu.probe(device="cpu", positions=pos)
  assert probes.so3_preacts.launches == before
  assert [r["elements"] for r in layers] == [4 * 6 * 128] * 3
  assert all(r["flips"] == 0 and r["max_dev"] <= 1e-5 for r in layers)


def test_probe_refuses_tf32(monkeypatch):
  monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
  with pytest.raises(RuntimeError, match="TF32"):
    probe_so3_relu.probe(device="cpu", positions=torch.zeros((1, 1, 3)))


def test_relu_flips_counts_sign_changes():
  a = torch.tensor([[1.0, -2.0, 3e-9], [0.0, 5.0, -1.0]])
  b = torch.tensor([[1.0, -2.0, -1e-9], [1e-9, 5.0, -1.0]])
  stats = probes.relu_flips([a], [b])[0]
  assert stats["flips"] == 2 and stats["elements"] == 6
  assert stats["min_abs"] == pytest.approx(1e-9)
  masked = probes.relu_flips([a], [b], mask=torch.tensor([True, False]))[0]
  assert masked["flips"] == 1 and masked["elements"] == 3


@pytest.mark.parametrize("n", [16, 33])
def test_blob_grid_matches_jax_bitwise(n):
  spec = j_grid.GridSpec([n] * 3, [-1.5] * 3, [1.5] * 3)
  want, _ = j_selfcheck._blob_grid3d(spec, n)
  got = t_selfcheck._blob_grid3d(t_grid.GridSpec(spec.ndim, spec.nmin,
                                                 spec.nmax), n)
  assert got.dtype == np.float32 and got.shape == (n**3, 4)
  np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("batch", [256, 512])
def test_center_tile_rays_match_jax_bitwise(batch):
  want = j_selfcheck._center_tile_rays(batch)
  got = t_selfcheck._center_tile_rays(batch)
  for g, w in zip(got, want):
    assert g.dtype == np.float32 and g.shape == (batch, 3)
    np.testing.assert_array_equal(g, np.asarray(w))


def test_constants_match_jax():
  assert t_selfcheck.SO3_KEY == j_selfcheck.SO3_KEY


@pytest.fixture(scope="module")
def reduced_run():
  envelopes = {}
  deviations, not_run = t_selfcheck.check_march(
      device="cpu", so3_params=_flat_so3(_jax_so3()), envelopes=envelopes,
      **REDUCED)
  return deviations, not_run, envelopes


def test_check_march_passes_on_the_cpu_with_jax_weights(reduced_run):
  deviations, _, envelopes = reduced_run
  fwd = [f"fwd_lean_{n}" for n in ("pos", "dirs", "dist", "sub_pos",
                                   "sub_dirs", "sub_dist")]
  fwd += [f"fwd_{arm}_{n}" for arm in ("so3", "pallas_bf16")
          for n in ("pos", "dirs", "dist", "n", "g")]
  grads = ["grad_origins", "grad_directions", "grad_alpha"] + [
      f"grad_so3.{name}.{kind}" for name in LAYERS
      for kind in ("weight", "bias")]
  assert list(deviations) == fwd + ["allstage_loss"] + grads
  for name, dev in deviations.items():
    assert np.isfinite(dev) and dev <= envelopes[name], name


def test_check_march_reports_the_skipped_bf16_arms(reduced_run):
  _, not_run, _ = reduced_run
  assert len(not_run) == len(t_selfcheck.SKIPPED_ARMS) == 1
  for msg, (name, why) in zip(not_run, t_selfcheck.SKIPPED_ARMS):
    assert msg.startswith(f"{name}: not run") and why in msg
    assert name == "fwd_tiled_bf16" and "no XLA tiled marcher" in why


def test_check_march_default_head_is_the_ship_width():
  so3 = t_selfcheck.default_so3_params("cpu")
  assert march_kernel.so3_width(so3, t_selfcheck.SO3_KEY[1]) == 128
  assert [tuple(p.shape) for p in so3[0::2]] == [
      (128, 60), (128, 128), (128, 128), (128, 188), (3, 128)]
  assert 5e-3 < float(so3[-2].std()) < 2e-2


def test_check_march_fails_when_march_full_is_off(monkeypatch):
  full = march_kernel.march_full

  @functools.wraps(full)
  def off(*a, **k):
    return full(*a, **k) + 1e-2

  monkeypatch.setattr(march_kernel, "march_full", off)
  with pytest.raises(AssertionError, match="fwd_so3_"):
    t_selfcheck.check_march(device="cpu", **REDUCED)


def test_check_march_fails_when_march_bwd_is_off(monkeypatch):
  from samplenerfro_torch.ops import eikonal_vjp
  bwd = eikonal_vjp.march_bwd

  @functools.wraps(bwd)
  def off(*a, **k):
    obar, dbar, abar, grads = bwd(*a, **k)
    return obar, dbar, abar, [g * 1.01 for g in grads]

  monkeypatch.setattr(eikonal_vjp, "march_bwd", off)
  with pytest.raises(AssertionError, match="grad_so3"):
    t_selfcheck.check_march(device="cpu", **REDUCED)
