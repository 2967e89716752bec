"""The counts against hand counts at one shape per kernel."""

import pytest
import torch

from portbench.counts import nerf as counts
from portbench.reference import model as ref_model
from portbench.tests import tiny

SHIP = {"max_deg_point": 10, "deg_view": 4, "net_width": 256,
        "net_width_condition": 128, "net_depth": 8, "net_depth_condition": 1,
        "skip_layer": 4, "num_coarse_samples": 64, "num_path_samples": 12,
        "num_fine_samples": 128, "mlp_dtype": "bfloat16",
        "march_bwd_dtype": "bfloat16"}


def test_mlp_macs_by_hand():
  assert counts.nerf_mlp_macs(SHIP) == (63 * 256 + 6 * 256 * 256 + 319 * 256
                                        + 256 + 256 * 256 + 283 * 128
                                        + 128 * 3)
  assert counts.bkgd_macs(SHIP) == 27 * 128 + 2 * 128**2 + 155 * 128 + 384
  assert counts.so3_macs() == 60 * 128 + 2 * 128**2 + 188 * 128 + 384


def test_param_counts_match_the_reference_leaves():
  cfg = tiny.tiny_config()
  cfg["flags"].update(SHIP)
  shapes = ref_model.param_shapes(cfg)
  total = lambda pre: sum(torch.Size(s).numel() for k, s in shapes.items()
                          if k.startswith(pre))
  assert total("path_sampler") == counts.so3_params()
  macs = counts.nerf_mlp_macs(cfg["flags"])
  assert total("coarse_mlp") == macs + sum(
      s[0] for k, s in shapes.items() if k.startswith("coarse_mlp")
      and k.endswith("bias"))


def test_k1_bound_by_hand():
  # 1024 rays, 768 steps, 64 coarse samples, 1000 voxels.
  ms, by = counts.k1(SHIP, 1024, 1000)
  nbytes = 28 * 1024 * (768 + 64) + 4 * (6 * 1024 + 64) + 16 * 1000
  assert by == "bytes"
  assert ms == pytest.approx(1e3 * nbytes / 3.35e12)


def test_k2_and_k3_bounds_by_hand():
  active, distinct = 300_000, 50_000
  ops_bf16 = 2 * counts.so3_macs() * active
  ops_fp32 = 120 * 1024 * 768 + 120 * active
  ms, by = counts.k2(SHIP, 1024, active, distinct)
  assert by == "operations"
  assert ms == pytest.approx(1e3 * (ops_bf16 / 989e12 + ops_fp32 / 67e12))
  ms3, _ = counts.k3(SHIP, 1024, active, distinct)
  want = 1e3 * (2 * ops_bf16 / 989e12 + 200 * 1024 * 768 / 67e12)
  nbytes = 88 * 1024 * 768 + 16 * distinct + 24 * 1024 + 8 * (
      counts.so3_params())
  assert ms3 == pytest.approx(max(want, 1e3 * nbytes / 3.35e12))


def test_step_and_render_counts_by_precision_class():
  ops = counts.train_step_ops(SHIP, "all", 1024, 128 * 128, 300_000, 10)
  rows = 1024 * (64 + 192)
  assert ops["bf16"] == (6 * counts.nerf_mlp_macs(SHIP) * rows
                         + 6 * counts.so3_macs() * 300_000)
  radiance = counts.train_step_ops(SHIP, "radiance", 1024, 0, 0, 10)
  assert radiance["bf16"] == 6 * counts.nerf_mlp_macs(SHIP) * rows
  r = counts.render_ops(SHIP, 8192, 1000)
  assert r["bf16"] == 2 * counts.so3_macs() * 1000
  assert r["fp32"] == (2 * counts.nerf_mlp_macs(SHIP) * 8192 * 256
                       + 2 * counts.bkgd_macs(SHIP) * 8192
                       + 120 * 8192 * 768 + 120 * 1000)


def test_distinct_voxels_and_tile_order():
  spec = ref_model.Spec([4, 4, 4], [-1] * 3, [1] * 3)
  # One point inside one cell touches its 8 corners; a corner point clamps.
  assert counts.distinct_voxels(spec, torch.tensor([[0.1, 0.1, 0.1]])) == 8
  assert counts.distinct_voxels(spec, torch.tensor([[1.0, 1.0, 1.0]])) == 1
  order = counts.tile_order(32, 48, 16)
  assert sorted(order.tolist()) == list(range(32 * 48))
  assert order[:16].tolist() == list(range(16))
