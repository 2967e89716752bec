"""A configuration, a cell and a per-layer metric added as files and
manifest entries run through the harness, no file of it edited."""

import json
import os

from portbench import harness
from portbench.tests import tiny


def test_new_config_cell_and_metric_run(tmp_path):
  root, pkg = tiny.make_root(tmp_path, fp32=True)
  with open(os.path.join(pkg, "metrics", "traced_steps.train.py"), "w") as f:
    f.write('"""Steps in the traced window."""\n\n\ndef read(ctx):\n'
            '  return float(ctx.steps)\n')
  man = harness.manifest(root)
  man["per_layer"].append({"name": "traced_steps.train", "unit": "steps",
                           "better": "higher", "source": "program_counter",
                           "layer": "dispatch", "moves": "train_rays_per_s",
                           "workloads": ["tiny.train_all"]})
  with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
    json.dump(man, f)
  quiet = lambda msg: None
  result, checks = harness.run("tiny.train_all", 7, 0.2, False,
                               device="cpu", root=root, pkg=pkg, log=quiet)
  assert set(result["metrics"]) == {"train_rays_per_s", "setup_s"}
  assert result["correct"], checks
  assert list(result)[-1] == "checks"
  traced, _ = harness.run("tiny.train_all", 7, 0.2, True, device="cpu",
                          root=root, pkg=pkg, log=quiet)
  k = tiny.tiny_config()["flags"]["steps_per_dispatch"]
  assert traced["metrics"]["traced_steps.train"]["value"] == 10 * k
  assert "input_wait_ms.train" in traced["metrics"]
  # No device ops on the CPU: the readers of the trace read nothing.
  assert "mfu.train" not in traced["metrics"]
  assert traced["device"]["window_s"] > 0


def test_cell_metrics_follow_workloads_and_moves():
  man = {"end_to_end": [{"name": "a", "workloads": ["x"]}, {"name": "s"}],
         "per_layer": [{"name": "p", "moves": "a"},
                       {"name": "q", "moves": "a", "workloads": ["y"]}]}
  assert [m["name"] for m in harness.cell_metrics(man, "x", "end_to_end")] == [
      "a", "s"]
  assert [m["name"] for m in harness.cell_metrics(man, "x", "per_layer")] == [
      "p"]
  assert [m["name"] for m in harness.cell_metrics(man, "y", "per_layer")] == [
      "q"]


def test_every_manifest_entry_has_its_files():
  man = harness.manifest()
  for c in man["configs"]:
    assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
  for w in man["workloads"]:
    cell, cfg, mix = harness.cell_spec(w["name"])
    assert os.path.exists(os.path.join(harness.PKG, "cells",
                                       mix["kind"] + ".py"))
    assert set(mix["limits"])
  for m in man["per_layer"]:
    assert os.path.exists(os.path.join(harness.PKG, "metrics",
                                       m["name"] + ".py"))
