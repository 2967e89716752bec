"""K2's bf16 head against P3's bf16 arm (K3's forward) at the ship shapes:
the ReLU masks of the head's first three layers that two summations set
apart, at the active ray-steps of K2's own trajectory, and K2's device
time.

    python -m samplenerfro_torch.debug.k2_head_flips [--seed N]

At the ship 'all' batch (1024 rays) and the render chunk (8192 rays), 768
steps, march_interp "default" and the bf16 head (march_bwd_dtype
"bfloat16"): K2's trajectory and its active ray-steps (|grad n| > 1e-3).
At their positions, the pre-activations of hidden layers 1-3 summed

- as a k-order chain (chain_preacts): each one fp32 sum from zero in k
  order of bf16 products, then + bias. A product of two bf16 values is
  exact in fp32, so acc + x * w rounds once, as a fused multiply-add
  does: this is the CUDA-core head of K2's bf16 arm before it ran on
  tensor cores, in torch on the card, on the plain version's features;
- by P3's bf16 arm (utils/probes.so3_preacts): K3's own forward,
  mma.sync m16n8k16 with the running sum in the accumulator;
- by K2 itself, where the checkout's march_kernel reads them back
  (march_full_preacts, a trial build of csrc/march_so3.cu); each bit
  against P3's.

For each pair it prints probes.relu_flips (the masks that differ, per
layer) and the elements that differ at all, then K2's call ms (CUDA
events) and kernel device ms (torch.profiler) at both shapes, and, where
the checkout's K2 takes a geometry pinned (march_kernel.SO3_BF16_SHAPES),
its kernel device ms in each, its trajectory held bit for bit the chosen
geometry's.
"""

import argparse
import functools
import time

import torch

from samplenerfro_torch.debug import march_parity
from samplenerfro_torch.models.path_sampler import SO3_MAX_DEG
from samplenerfro_torch.ops import cuda_build
from samplenerfro_torch.ops import march_kernel
from samplenerfro_torch.ops import math as math_ops
from samplenerfro_torch.ops import precision
from samplenerfro_torch.utils import probes


def log(msg):
  print(msg, flush=True)


def chain_preacts(p, so3, alpha, max_deg=SO3_MAX_DEG):
  """The pre-activations of the bf16 head's first three layers at the
  points p [N, 3], each an fp32 sum from zero in k order of bf16 products
  and then + bias (a product of bf16 values is exact, so each addition
  rounds once): (pre1, pre2, pre3), each [N, width]."""
  a = torch.as_tensor(alpha, dtype=torch.float32, device=p.device)
  h = precision.bf16(math_ops.annealed_pos_enc(p, 0, max_deg, a * max_deg))
  pres = []
  for i in range(3):
    w = precision.bf16(so3[2 * i]).t().contiguous()  # [in, width]
    acc = torch.zeros((p.shape[0], w.shape[1]), dtype=torch.float32,
                      device=p.device)
    for k in range(w.shape[0]):
      acc = acc + h[:, k:k + 1] * w[k]
    pres.append(acc + so3[2 * i + 1])
    h = precision.bf16(torch.relu(pres[-1]))
  return tuple(pres)


def differ(got, want):
  """Per layer, the elements of got and want that are not equal bit for
  bit."""
  return [int((a != b).sum()) for a, b in zip(got, want)]


def compare(what, got, want):
  flips = probes.relu_flips(got, want)
  log(f"  {what}: flips per layer {[f['flips'] for f in flips]}, elements "
      f"that differ {differ(got, want)} of {flips[0]['elements']} a layer, "
      f"max abs difference {[f['max_dev'] for f in flips]}")
  return flips


def main():
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--seed", type=int, default=0)
  ns = p.parse_args()
  if not torch.cuda.is_available():
    raise SystemExit("k2_head_flips: no CUDA device")
  t0 = time.time()
  log(march_parity.card_name())
  cuda_build.build(["march_so3", "march_bwd"])
  device = torch.device("cuda")
  args, model, _ = march_parity.ship_model(device, ns.seed)
  _, _, first, _, batch = march_parity.ship_inputs(args, ns.seed, device)
  ps = model.path_sampler
  so3 = march_parity.so3_params_for(ns.seed, device)
  alpha = march_parity.SO3_ALPHA
  readback = getattr(march_kernel, "march_full_preacts", None)
  for shape, rays in (("batch", batch), ("chunk", first)):
    fwd = (ps.spec, ps.grid, rays.origins, rays.viewdirs, ps.near,
           ps.step_size, ps.num_samples, so3, alpha, SO3_MAX_DEG, "default",
           "bfloat16")
    with torch.no_grad():
      traj = march_kernel.march_full(*fwd)
      active = traj[..., 8:11].norm(dim=-1) > 1e-3
      pts = traj[..., 0:3][active].contiguous()
      log(f"{shape}: {rays.origins.shape[0]} rays x {ps.num_samples} steps, "
          f"{pts.shape[0]} active ray-steps")
      p3 = probes.so3_preacts(pts, so3, alpha, SO3_MAX_DEG, "bfloat16")
      compare("k-order chain against P3 bf16", chain_preacts(pts, so3,
                                                            alpha), p3)
      if readback is not None:
        traj2, pre = readback(*fwd[:-1])
        log(f"  K2's trial build: trajectory bit for bit K2's "
            f"{torch.equal(traj, traj2)}")
        compare("K2 against P3 bf16", [x[active] for x in pre], p3)
        del traj2, pre
      del traj, pts, p3
    torch.cuda.empty_cache()
    call = lambda: march_kernel.march_full(*fwd)
    ms = march_parity.cuda_ms(call)
    dev_ms, per = march_parity.kernel_device_ms(call, "march_so3_kernel")
    log(f"  K2 [default, bf16 head] {shape}: {ms:.4f} ms a call, kernel "
        f"{dev_ms:.4f} device ms ({per:g} launches a call)")
    shapes = getattr(march_kernel, "SO3_BF16_SHAPES", ())
    if shapes:
      chosen = march_kernel.march_full(*fwd)
      for pinned in shapes:
        pin = functools.partial(
            march_kernel._launch_so3,  # pylint: disable=protected-access
            *fwd, shape=pinned)
        same = torch.equal(pin(), chosen)
        dev_ms, _ = march_parity.kernel_device_ms(pin, "march_so3_kernel")
        log(f"    {pinned[0]} rays a group x {pinned[1]} a CTA: kernel "
            f"{dev_ms:.4f} device ms, bit for bit the chosen one's {same}")
      del chosen
  log(f"total {time.time() - t0:.1f} s")


if __name__ == "__main__":
  main()
