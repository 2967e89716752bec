"""The readings a cell's limits are set from, on the card at its own size.

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 ... \\
        --control_seeds 1 2 3 [--witness_seeds 1 2] [--seconds 1]

In one process (the set-up of a run is long): for each of --seeds a run
of the cell (the program against the reference, as every run compares
it, with every number the runner computes, compared or not); for each of
--witness_seeds a run of the program in its fp32 arms (march_interp
highest, march_bwd_dtype float32, mlp_dtype float32), a second witness of
how far the program sits from the reference without the configuration's
reduced precision; then for each of --control_seeds the control and the
faults, each put in the program's place and compared with the reference:
  - the control: the reference one precision below the configuration's
    (reference/model.control_prec: fp8 for bf16, TF32 for fp32), forward
    and backward;
  - a training cell's fault "half of the batch left out, the mean over
    the rest": the reference's loss over the first half of each batch;
  - a training cell's witness `bf16_witness`: the reference at the
    configuration's own bf16 rounding, forward and backward
    (reference/model.config_prec), which shows what that rounding alone
    does to each number;
  - a render cell's faults: a chunk of 8192 rays answered with another
    chunk's colours, and half of each chunk's rays left unrendered (0).
A training cell's variants run its start from the benchmark's weights and
its window from the program's leaves and moments before its first
replay, as the reference does. A state left unchanged reads 1 by the
training cells' measure (no run).
One JSON line per reading, `kind` program, fp32_arms, control or a
fault's or witness's name.
"""

import argparse
import json
import os
import sys
import time

if __package__ in (None, ""):
  sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
      __file__))))

import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.cells import render as render_cell  # noqa: E402
from portbench.reference import model as ref_model  # noqa: E402
from portbench.traffic import capture  # noqa: E402
from portbench.traffic import weights as weights_lib  # noqa: E402


TRAIN_VARIANTS = ("control", "half_batch", "bf16_witness")


def emit(**kw):
  print(json.dumps(kw), flush=True)


def render_faults(cfg, mix, seed, device):
  from samplenerfro_torch.models import nerf
  f = cfg["flags"]
  raw = capture.raw_grid(cfg, device)
  weights = weights_lib.make(ref_model.param_shapes(cfg), seed, device,
                             cfg["scene"].get("so3_std", 1e-2))
  jitter = nerf.make_jitter(f["num_coarse_samples"], f["num_path_samples"],
                            torch.Generator().manual_seed(seed + 303))
  pose = capture.test_poses(cfg, seed, int(mix["views"]))[1:2]
  span = f["far"] - f["near"]
  ref = [x.cpu() for x in render_cell.reference_views(
      cfg, raw, weights, pose, jitter, device)[0]]
  ctl = [x.cpu() for x in render_cell.reference_views(
      cfg, raw, weights, pose, jitter, device,
      prec=ref_model.control_prec(cfg, render=True))[0]]
  emit(kind="control", seed=seed, **render_cell.compare(ctl, ref, span))
  c = f["chunk"]
  swapped = [x.clone() for x in ref]
  for x, r in zip(swapped, ref):
    x[:c] = r[c:2 * c]
  emit(kind="answer_altered", seed=seed,
       **render_cell.compare(swapped, ref, span))
  halved = [x.clone() for x in ref]
  for x in halved:
    for i in range(0, x.shape[0], c):
      x[i + c // 2:i + c] = 0
  emit(kind="half_batch", seed=seed, **render_cell.compare(halved, ref, span))


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--workload", required=True)
  p.add_argument("--seeds", type=int, nargs="*", default=[])
  p.add_argument("--control_seeds", type=int, nargs="*", default=[])
  p.add_argument("--witness_seeds", type=int, nargs="*", default=[])
  p.add_argument("--seconds", type=float, default=1.0)
  ns = p.parse_args(argv)
  cell, cfg, mix = harness.cell_spec(ns.workload)
  harness.check_device(cell["chips"])
  device = torch.device("cuda")
  log = lambda msg: print(msg, file=sys.stderr, flush=True)
  fp32 = {"march_interp": "highest", "march_bwd_dtype": "float32",
          "mlp_dtype": "float32"}
  train = mix["kind"] == "train"
  variants = {"variants": TRAIN_VARIANTS} if train else {}
  for kind, seeds, flags, kw in (("program", ns.seeds, {}, {}),
                                 ("fp32_arms", ns.witness_seeds, fp32, {}),
                                 ("program", ns.control_seeds if train
                                  else [], {}, variants)):
    for seed in seeds:
      t = time.perf_counter()
      run_cfg = dict(cfg, flags=dict(cfg["flags"], **flags))
      out = harness.runner(mix["kind"]).run(
          cell=cell, cfg=run_cfg, mix=mix, seed=seed, seconds=ns.seconds,
          trace=False, device=device, t_start=t, log=log, **kw)
      emit(kind=kind, seed=seed, seconds=time.perf_counter() - t,
           metrics=out["e2e"], **out["numbers"])
      for name, numbers in out.get("variants", {}).items():
        emit(kind=name, seed=seed, **numbers)
      del out
      torch.cuda.empty_cache()
  if not train:
    for seed in ns.control_seeds:
      render_faults(cfg, mix, seed, device)
      torch.cuda.empty_cache()


if __name__ == "__main__":
  main()
