"""Probe: do K3 and cuBLAS set the so3 head's ReLU masks apart?

Counterpart of scripts/debug/probe_so3_relu.py. K3 (csrc/march_bwd.cu)
recomputes the so3 head's activations summing each product in k order,
one fmaf at a time; the plain march, and so autograd, compute them with
F.linear, which cuBLAS sums in its own order. A pre-activation within that
rounding of 0 passes ReLU on one side only. The flipped mask makes a
discrete jump in the parameter cotangent: the unit's row of the layer's
weight gradient and its bias gradient (pure sums of its cotangent) and its
column in the next layer's. Such a deviation is a subgradient choice, not
a kernel fault.

This probe computes the pre-activations of hidden layers 1-3 both ways,
P3 (utils/probes.so3_preacts) against its plain version, at the points the
self-check (train/selfcheck.py) differentiates through: 256 center-tile
rays marched 192 steps at h = 4/767 through the 128^3 blob without the
head, 49,152 points. The plain version runs a step at a time on the 256
rays, as the plain march calls the head: cuBLAS picks its summation order
by the shape of the call, and in one call over all points it can sum as
K3 does. It prints, per layer, the largest difference, the flipped masks
and the smallest |pre-activation|.

    python -m samplenerfro_torch.debug.probe_so3_relu [--device=cpu]

On the CPU both sides are the plain version, which can differ only where
the CPU's BLAS sums a one-call product in another order than a per-step
one.
"""

import argparse
import itertools

import torch
import torch.nn.functional as F

from samplenerfro_torch import resolve_device
from samplenerfro_torch.ops import eikonal as eik_ops
from samplenerfro_torch.ops import grid as grid_ops
from samplenerfro_torch.ops import march_kernel
from samplenerfro_torch.ops import math as math_ops
from samplenerfro_torch.train import selfcheck
from samplenerfro_torch.utils import probes

GRID_N, RAYS, STEPS = 128, 256, 192
STEP = (selfcheck.FAR - selfcheck.NEAR) / (768 - 1)


def probe_positions(device):
  """The probe's [RAYS, STEPS, 3] path vertices: K1's dense path on the
  card, the plain march's on the CPU."""
  spec = grid_ops.GridSpec([GRID_N] * 3, [-1.5] * 3, [1.5] * 3)
  data = torch.from_numpy(selfcheck._blob_grid3d(spec, GRID_N)).to(device)
  o, d = (torch.from_numpy(a).to(device)
          for a in selfcheck._center_tile_rays(RAYS))
  jitter = torch.arange(0, STEPS, STEPS // 64)  # on the host, checked there
  with torch.no_grad():
    pos = march_kernel.march_lean(spec, data, o, d, selfcheck.NEAR, STEP,
                                  STEPS, jitter)[0]
  return pos.contiguous()


def probe(device=None, positions=None, so3_params=None, alpha=selfcheck.ALPHA):
  """Per hidden layer 1-3, a dict of P3 against its plain version: max_dev,
  flips, elements, min_abs (the plain version's smallest |pre-activation|).

  positions: [B, S, 3] path vertices of B rays (default probe_positions);
  the plain version runs a step at a time on the B rays. so3_params: the
  head's flat params (default selfcheck.default_so3_params).
  """
  dev = resolve_device(device)
  if torch.backends.cuda.matmul.allow_tf32:
    raise RuntimeError("probe: TF32 matmuls are on; the plain version must "
                       "run in true fp32")
  pos = (probe_positions(dev) if positions is None else
         positions.to(dev, torch.float32))
  so3 = (selfcheck.default_so3_params(dev) if so3_params is None else
         [p.detach().to(dev) for p in so3_params])
  with torch.no_grad():
    got, want = zip(*probes.so3_preacts_by_step(pos, so3, alpha,
                                                selfcheck.SO3_KEY[1]))
  return probes.relu_flips(got, want)


def replaying_refine_fn(k3_pre, flipped):
  """A stand-in for ops/march_kernel.so3_refine_fn that replays K3's ReLU
  masks in the plain march, to show that flips explain a deviation.

  k3_pre, flipped: per layer 1-3, [B, S, W] pre-activations of K3's (P3's)
  and the mask of the entries to take from them, at the path vertices of a
  march of B rays and S steps. The returned factory has so3_refine_fn's
  signature; its head is the shipped skip-MLP (4 layers, the input again
  after layer 3) whose marked pre-activations take K3's value, their
  gradient passing as through the plain version's. Each refine it makes
  counts the plain march's steps, one call a step on all B rays.
  """
  def factory(so3_params, alpha, max_deg, dtype="float32"):
    if dtype != "float32":
      raise NotImplementedError("the replay runs the fp32 head; the bf16 "
                                "arm replays through ops/eikonal_vjp."
                                "march_bwd_passes_reference(replay=...)")
    step = itertools.count()

    def refine(p, g):
      s = next(step)
      x = math_ops.annealed_pos_enc(p, 0, max_deg, alpha * max_deg)
      h = x
      for i in range(4):
        z = F.linear(h, so3_params[2 * i], so3_params[2 * i + 1])
        if i < 3:
          z = torch.where(flipped[i][:, s],
                          k3_pre[i][:, s] + (z - z.detach()), z)
        h = torch.relu(z)
        if i == 2:
          h = torch.cat([h, x], dim=-1)
      raw = F.linear(h, so3_params[8], so3_params[9])
      return eik_ops.rodrigues_rotate(raw, g)

    return refine

  return factory


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--device", default=None, help="cuda (default) or cpu")
  ns = p.parse_args(argv)
  for i, r in enumerate(probe(ns.device), 1):
    print(f"layer {i}: preact max dev {r['max_dev']:.3e}, relu flips "
          f"{r['flips']} of {r['elements']} (min |preact| "
          f"{r['min_abs']:.3e})")


if __name__ == "__main__":
  main()
