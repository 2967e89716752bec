"""A tiny copy of the benchmark for the CPU tests: a temporary root with
the manifest, the package's files and a `tiny` configuration (the ship
configuration at small widths, a 24^3 grid, 32 march steps, 64x64 views)
with a cell per traffic mix, each held to the real cell's limits."""

import json
import os
import shutil

from portbench import harness

BASE = {"train_all": "ship.train_all", "train_radiance": "ship.train_radiance",
        "render": "ship.render"}


def tiny_config(fp32=False):
  cfg = harness.load_json(os.path.join(harness.PKG, "configs", "ship.json"))
  cfg["name"] = "tiny"
  cfg["flags"].update({"net_width": 32, "net_width_condition": 16,
                       "batch_size": 256, "bg_patch_size": 8,
                       "num_coarse_samples": 8, "num_path_samples": 4,
                       "num_fine_samples": 8, "steps_per_dispatch": 2,
                       "chunk": 512, "render_chunks_per_dispatch": 2})
  if fp32:
    cfg["flags"].update({"mlp_dtype": "float32", "march_interp": "highest",
                         "march_bwd_dtype": "float32"})
  cfg["scene"].update({"grid_n": 24, "width": 64, "height": 64,
                       "train_views": 3})
  cfg["gin"].update({"Config.kernel_size": 3, "Config.kernel_sigma": 1.0})
  return cfg


def make_root(tmp, fp32=False, views=3):
  """A benchmark root under `tmp` with tiny.<mix> cells; returns (root,
  pkg)."""
  root = os.path.join(str(tmp), "root")
  pkg = os.path.join(root, "portbench")
  shutil.copytree(harness.PKG, pkg,
                  ignore=shutil.ignore_patterns("tests", "__pycache__"))
  with open(os.path.join(pkg, "configs", "tiny.json"), "w") as f:
    json.dump(tiny_config(fp32), f)
  man = harness.manifest()
  for mix, base in BASE.items():
    name = "tiny." + mix
    man["workloads"].append({"name": name, "config": "tiny", "traffic": mix,
                             "chips": 1, "why": "CPU test"})
    for m in man["end_to_end"] + man["per_layer"]:
      if base in m.get("workloads", []):
        m["workloads"].append(name)
    own = harness.load_json(os.path.join(harness.PKG, "workloads",
                                         base + ".json"))
    if mix == "render":
      own["views"] = views
    with open(os.path.join(pkg, "workloads", name + ".json"), "w") as f:
      json.dump(own, f)
  with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
    json.dump(man, f)
  return root, pkg


def run(tmp, mix, seed=12345678901, trace=False, fp32=True, seconds=0.5):
  root, pkg = make_root(tmp, fp32)
  return harness.run("tiny." + mix, seed, seconds, trace, device="cpu",
                     root=root, pkg=pkg, log=lambda msg: None)


def run_cell(tmp, mix, seed=12345678901, fp32=True, seconds=0.5, **kw):
  """The runner's own result of one run of tiny.<mix> (with `kw`, such as
  the variants calibrate.py runs)."""
  root, pkg = make_root(tmp, fp32)
  cell, cfg, m = harness.cell_spec("tiny." + mix, root, pkg)
  return harness.runner(m["kind"], pkg).run(
      cell=cell, cfg=cfg, mix=m, seed=seed, seconds=seconds, trace=False,
      device="cpu", t_start=0.0, log=lambda msg: None, **kw)
