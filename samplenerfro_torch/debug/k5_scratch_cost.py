"""What K5 spends on its scratch: K5-bf16's time as built, and built with
-DK5_TRIAL_NO_SCRATCH (csrc/mlp_bwd.cu: the stored activations, inputs and
rounded cotangents are neither written to the scratch slabs nor read back
by the ReLU masks and the weight-gradient products), at the ship train
batch's fine call.

    python -m samplenerfro_torch.debug.k5_scratch_cost [--rows 196608]

The trial's gradients are wrong; only its times are read. The two builds
alternate as built / trial / trial / built in one process; each line is
the median of 5 calls (CUDA events) of mlp_kernel.mlp_bwd with the weights
packed, on debug/mlp_rounding's ship MLP and samples.
"""

import argparse
import time

import torch

from samplenerfro_torch.debug import march_parity
from samplenerfro_torch.debug import mlp_rounding
from samplenerfro_torch.ops import cuda_build
from samplenerfro_torch.ops import math as math_ops
from samplenerfro_torch.ops import mlp_kernel

TRIAL = ("K5_TRIAL_NO_SCRATCH=1",)


def main():
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--rows", type=int, default=196608)
  p.add_argument("--seed", type=int, default=0)
  ns = p.parse_args()
  if not torch.cuda.is_available():
    raise SystemExit("k5_scratch_cost: no CUDA device")
  t0 = time.time()
  print(march_parity.card_name(), flush=True)
  cuda_build.build(["mlp_bwd"], also=[("mlp_bwd", TRIAL)])
  dev = torch.device("cuda")
  spec, params = mlp_rounding.ship_mlp(ns.seed, dev)
  pts, dirs, drgb, dsigma = mlp_rounding.samples(ns.rows, ns.seed, dev)
  x = math_ops.pe_cols(pts, 10).contiguous()
  c = math_ops.pe_cols(dirs, 4).contiguous()
  bf16 = torch.bfloat16
  pack = mlp_kernel.pack_params(params, bf16)
  scratch = mlp_kernel.scratch_row_elems(spec) * 2 * ns.rows
  print(f"{ns.rows} rows; scratch written once {scratch / 1e9:.3f} GB",
        flush=True)
  try:
    for defines in ((), TRIAL, TRIAL, ()):
      mlp_kernel.TRIAL_DEFINES = defines
      ms = mlp_rounding._ms(lambda: mlp_kernel.mlp_bwd(
          spec, params, x, c, drgb, dsigma, bf16, pack=pack))
      print(f"{'trial' if defines else 'built'}: K5-bf16 {ms:.4f} ms",
            flush=True)
  finally:
    mlp_kernel.TRIAL_DEFINES = ()
  print(f"total {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
  main()
