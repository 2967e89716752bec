"""The benchmark's harness: finds a cell's files by name, runs it, reports.

A cell is an entry of BENCHMARK.json's `workloads`: a configuration
(portbench/configs/<config>.json), a traffic mix
(portbench/traffic/<traffic>.json, its `kind` naming the runner:
portbench/cells/<kind>.py) and the cell's own settings
(portbench/workloads/<cell>.json, which override the mix's). A per-layer
metric is a reader, portbench/metrics/<metric>.py, whose read(ctx)
returns a number or None. Adding a configuration, a mix, a cell or a
metric adds files and manifest entries; nothing here changes.
"""

import contextlib
import importlib.util
import json
import os
import sys
import time

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
# Top-level module names that may not be loaded when a run's window has
# closed: the JAX stack and the JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "samplenerfro_tpu")


def load_json(path):
  with open(path) as f:
    return json.load(f)


def manifest(root=ROOT):
  return load_json(os.path.join(root, "BENCHMARK.json"))


def cell_spec(name, root=ROOT, pkg=PKG):
  """(workload entry, configuration, mix) of cell `name`."""
  man = manifest(root)
  cells = {w["name"]: w for w in man["workloads"]}
  if name not in cells:
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have "
                     f"{sorted(cells)})")
  cell = cells[name]
  cfg = load_json(os.path.join(pkg, "configs", f"{cell['config']}.json"))
  mix = load_json(os.path.join(pkg, "traffic", f"{cell['traffic']}.json"))
  own = os.path.join(pkg, "workloads", f"{name}.json")
  if os.path.exists(own):
    mix = {**mix, **load_json(own)}
  return cell, cfg, mix


def _load_file(path, name):
  spec = importlib.util.spec_from_file_location(name, path)
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def runner(kind, pkg=PKG):
  return _load_file(os.path.join(pkg, "cells", f"{kind}.py"),
                    f"portbench_cell_{kind}")


def cell_metrics(man, cell_name, section):
  """The metrics of `section` ("end_to_end" or "per_layer") that cell
  `cell_name` reports: those whose `workloads` list it, or, without the
  key, every cell that reports the end-to-end metric they move."""
  own_e2e = [m["name"] for m in man["end_to_end"]
             if "workloads" not in m or cell_name in m["workloads"]]
  out = []
  for m in man[section]:
    if "workloads" in m:
      if cell_name in m["workloads"]:
        out.append(m)
    elif section == "end_to_end" or m["moves"] in own_e2e:
      out.append(m)
  return out


def read_per_layer(metrics, ctx, pkg=PKG):
  """{name: {"value", "unit"}} of each per-layer metric whose reader finds
  something to read."""
  out = {}
  for m in metrics:
    reader = _load_file(os.path.join(pkg, "metrics", f"{m['name']}.py"),
                        "portbench_metric_" + m["name"].replace(".", "_"))
    value = reader.read(ctx)
    if value is not None:
      out[m["name"]] = {"value": value, "unit": m["unit"]}
  return out


def forbidden_modules(names=None):
  """The top-level names of loaded modules (of `names`, by default
  sys.modules) that are whole names of FORBIDDEN."""
  names = list(sys.modules) if names is None else names
  return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


class Spans:
  """The benchmark's own host spans: while a profiler runs (`traced`), a
  record_function named `pb:<name>` on its timeline; otherwise nothing."""

  def __init__(self):
    self.traced = False

  @contextlib.contextmanager
  def __call__(self, name):
    if not self.traced:
      yield
      return
    import torch
    with torch.profiler.record_function("pb:" + name):
      yield


def check_device(chips):
  """Raise SystemExit unless `chips` CUDA devices are there."""
  import torch
  if not torch.cuda.is_available():
    raise SystemExit("portbench: no CUDA device (torch.cuda.is_available() "
                     "is false); the benchmark runs on the card only")
  if torch.cuda.device_count() < chips:
    raise SystemExit(f"portbench: the cell needs {chips} CUDA devices, "
                     f"{torch.cuda.device_count()} are visible")


def run(name, seed, seconds, trace, device="cuda", root=ROOT, pkg=PKG,
        t_start=None, log=None):
  """Run cell `name` once; returns the result object (not yet printed) and
  the compared numbers, {name: (value, limit)}."""
  t_start = time.perf_counter() if t_start is None else t_start
  log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
  man = manifest(root)
  cell, cfg, mix = cell_spec(name, root, pkg)
  run_cell = runner(mix["kind"], pkg)
  out = run_cell.run(cell=cell, cfg=cfg, mix=mix, seed=int(seed),
                     seconds=float(seconds), trace=bool(trace),
                     device=device, t_start=t_start, log=log)
  found = forbidden_modules()
  if found:
    raise SystemExit(f"portbench: {found} loaded in the benchmark's process "
                     "once the window closed")
  if trace:
    metrics = read_per_layer(cell_metrics(man, name, "per_layer"),
                             out["ctx"], pkg)
  else:
    metrics = {m["name"]: {"value": out["e2e"][m["name"]], "unit": m["unit"]}
               for m in cell_metrics(man, name, "end_to_end")}
  checks = out["checks"]
  correct = all(v <= lim for v, lim in checks.values())
  result = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": out["device"]}
  if trace and out.get("breakdown"):
    result["breakdown"] = out["breakdown"]
  result["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
  return result, checks
