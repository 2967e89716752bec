"""What K3 bf16's pass 3 spends on its partial: the five kernels' device
times as built, and built with -DK3_TRIAL_NO_PARTIAL (csrc/march_bwd.cu's
grad_chunk: the weight-gradient products run, the [G, P] partial is
neither read nor written), at the ship 'all' batch.

    python -m samplenerfro_torch.debug.k3_partial_cost [--seed N]

The trial's gradients are wrong; only its times are read. The two builds
alternate as built / trial / trial / built in one process, and each line
is precision_arms.k3_split's device ms (torch.profiler) for one call of
march_bwd in the bf16 arm on the plain march's trajectory, as chip_smoke's
shipped-arms phase times it.
"""

import argparse
import time

import torch

from samplenerfro_torch.debug import march_parity
from samplenerfro_torch.debug import precision_arms
from samplenerfro_torch.models.path_sampler import SO3_MAX_DEG
from samplenerfro_torch.ops import cuda_build
from samplenerfro_torch.ops import eikonal_vjp
from samplenerfro_torch.ops import march_kernel

TRIAL = ("K3_TRIAL_NO_PARTIAL",)


def main():
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--seed", type=int, default=0)
  ns = p.parse_args()
  if not torch.cuda.is_available():
    raise SystemExit("k3_partial_cost: no CUDA device")
  t0 = time.time()
  print(march_parity.card_name(), flush=True)
  cuda_build.build(["march_bwd"], also=[("march_bwd", TRIAL)])
  device = torch.device("cuda")
  args, model, _ = march_parity.ship_model(device, ns.seed)
  _, _, _, _, batch = march_parity.ship_inputs(args, ns.seed, device)
  ps = model.path_sampler
  so3 = march_parity.so3_params_for(ns.seed, device)
  alpha = march_parity.SO3_ALPHA
  o, d = batch.origins, batch.viewdirs
  cfg = eikonal_vjp.MarchConfig(ps.spec, ps.near, ps.step_size,
                                ps.num_samples, SO3_MAX_DEG, "default",
                                "bfloat16")
  with torch.no_grad():
    traj = march_kernel.march_full_reference(
        ps.spec, ps.grid, o, d, ps.near, ps.step_size, ps.num_samples, so3,
        alpha, SO3_MAX_DEG, "default", "bfloat16")
  dtraj = torch.randn(traj.shape, generator=torch.Generator().manual_seed(
      ns.seed + 1)).to(device)
  active = int((traj[..., 8:11].norm(dim=-1) > 1e-3).sum())
  print(f"batch {o.shape[0]} rays x {ps.num_samples} steps, {active} "
        f"active ray-steps", flush=True)
  call = lambda: eikonal_vjp.march_bwd(cfg, ps.grid, o, d, so3, alpha,
                                       traj, dtraj)
  try:
    for defines in ((), TRIAL, TRIAL, ()):
      eikonal_vjp.TRIAL_DEFINES = defines
      split = precision_arms.k3_split(call)
      print(f"{'trial' if defines else 'built'}: k3_params "
            f"{split.get('k3_params', float('nan')):.4f} device ms; split "
            f"{ {k: round(v, 4) for k, v in split.items()} }", flush=True)
  finally:
    eikonal_vjp.TRIAL_DEFINES = ()
  print(f"total {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
  main()
