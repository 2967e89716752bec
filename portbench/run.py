"""Run one cell of the port's benchmark once, on the card.

    python3 portbench/run.py --workload <cell> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>
    python3 -m portbench.run ...      (the same, from the checkout's root)

Prints the set-up split and each compared number beside its limit on
standard error, and, as the last line of standard output, one JSON
object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with --trace 1 its per-layer ones), `device`, with
--trace 1 `breakdown`, and `checks` last. Exits non-zero, printing no
result, without the CUDA devices the cell asks for.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):
  sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
      __file__))))

from portbench import harness  # noqa: E402


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--workload", required=True)
  p.add_argument("--seed", type=int, required=True)
  p.add_argument("--seconds", type=float, required=True)
  p.add_argument("--trace", type=int, choices=(0, 1), default=0)
  ns = p.parse_args(argv)
  cell, _, _ = harness.cell_spec(ns.workload)
  harness.check_device(cell["chips"])
  result, checks = harness.run(ns.workload, ns.seed, ns.seconds, ns.trace,
                               t_start=T_START)
  for k, (v, lim) in checks.items():
    print(f"check {k}: {v!r} (limit {lim!r})", file=sys.stderr, flush=True)
  print(json.dumps(result), flush=True)


if __name__ == "__main__":
  main()
