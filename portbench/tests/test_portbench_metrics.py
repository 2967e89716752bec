"""Each per-layer reader on a canned trace."""

import importlib.util
import os

import pytest

from portbench import harness
from portbench import trace as trace_lib
from portbench.cells.train import Context
from portbench.counts import nerf as counts

K3 = ("k3_pieces", "k3_jacobians", "k3_sweep", "k3_params", "k3_reduce")


def reader(name):
  path = os.path.join(harness.PKG, "metrics", name + ".py")
  spec = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod.read


def canned():
  """1000 us of window: K1 100-150, K2 200-300 and 600-700 (two launches),
  each K3 kernel 10 us from 300, a GEMM 400-500, a copy 500-520; idle
  0-100, 150-200, 350-400, 520-600, 700-1000."""
  ops = [("void march_lean_kernel<2>(MarchArgs)", 100, 150),
         ("void bfh::march_so3_kernel<2, 16, 1>(So3Args)", 200, 300),
         ("void bfh::march_so3_kernel<2, 16, 1>(So3Args)", 600, 700)]
  ops += [(f"void {k}<Bf16Arm>(Args)", 300 + 10 * i, 310 + 10 * i)
          for i, k in enumerate(K3)]
  ops += [("nvjet_tst_128x256_64x4_2x1_v_bz_coopA_NNN", 400, 500),
          ("Memcpy HtoD (Pinned -> Device)", 500, 520)]
  spans = [("traced", 0, 1000), ("replay", 0, 90), ("prefetch_wait", 520, 610)]
  return trace_lib.Trace(sorted(ops, key=lambda o: o[1]), spans, (0, 1000))


def ctx(**kw):
  base = dict(trace=canned(), steps=2, rays=16384, chunk=8192,
              input_wait_ms=0.25,
              bounds={"k1": (0.01, "bytes"), "k2": (0.02, "operations"),
                      "k3": (0.01, "operations"), "mlp": (0.03, "ops")},
              step_ops={"bf16": 989e6, "fp32": 67e6},
              ops_per_ray={"fp32": 67e6 / 16384})
  base.update(kw)
  return Context(**base)


def test_trace_arithmetic():
  t = canned()
  assert trace_lib.busy_s(t) == pytest.approx(420e-6)
  assert trace_lib.idle_gaps(t) == [(0, 100), (150, 200), (350, 400),
                                    (520, 600), (700, 1000)]
  b = trace_lib.breakdown(t)
  assert b["device_ops"][0] == ["void bfh::march_so3_kernel<2, 16, 1>(So3Args)",
                                pytest.approx(200e-6)]
  assert b["idle_gaps"][0] == ["traced", pytest.approx(300e-6)]
  assert [g[0] for g in b["idle_gaps"]][1:3] == ["replay", "prefetch_wait"]


def test_readers_on_the_canned_trace():
  c = ctx()
  assert reader("device_idle_share.train")(c) == pytest.approx(58.0)
  assert reader("device_idle_share.render")(c) == pytest.approx(58.0)
  assert reader("input_wait_ms.train")(c) == 0.25
  # K1: a 0.01 ms bound over one 50 us launch.
  assert reader("k1_roofline.train")(c) == pytest.approx(20.0)
  # K2: 0.02 ms over 100 us a launch, in training and rendering.
  assert reader("k2_roofline.train")(c) == pytest.approx(20.0)
  assert reader("k2_roofline.render")(c) == pytest.approx(20.0)
  # K3: 0.01 ms over five kernels of 10 us.
  assert reader("k3_roofline.train")(c) == pytest.approx(20.0)
  # MLPs: 0.03 ms over 100 us of GEMM for 2 steps / 2 chunks.
  assert reader("mlp_roofline.train")(c) == pytest.approx(60.0)
  assert reader("mlp_roofline.render")(c) == pytest.approx(60.0)
  # 1 us + 1 us of ideal time a step over the 500 us a step measured.
  assert reader("mfu.train")(c) == pytest.approx(100 * 2e-6 / 500e-6)
  # 1 us of ideal time over the 1000 us window.
  assert reader("mfu.render")(c) == pytest.approx(100 * 1e-6 / 1000e-6)


def test_readers_find_nothing_without_their_kernels():
  empty = trace_lib.Trace([], [("traced", 0, 10)], (0, 10))
  c = ctx(trace=empty)
  for name in ("device_idle_share.train", "mfu.train", "k1_roofline.train",
               "k2_roofline.train", "k3_roofline.train", "mlp_roofline.train",
               "device_idle_share.render", "mfu.render", "k2_roofline.render",
               "mlp_roofline.render"):
    assert reader(name)(c) is None, name


def test_peaks_are_the_data_sheet_figures():
  assert counts.PEAK == {"fp32": 67e12, "bf16": 989e12}
  assert counts.HBM_BYTES_PER_S == 3.35e12
