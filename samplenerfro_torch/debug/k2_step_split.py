"""Where a step of K2's bf16 head spends its cycles, by clock64.

    python -m samplenerfro_torch.debug.k2_step_split [--seed N]

Writes a copy of ops/csrc under build/k2_step_split/ in which
csrc/march_so3.cu's bf16-head kernel (namespace bfh) reads clock64 at the
boundaries of a step's phases, each warp summing the cycles of each
phase over the march, and builds and runs it in every geometry the kernel
is built for (march_kernel.SO3_BF16_SHAPES) at the ship 'all' batch (1024
rays) and render chunk (8192 rays), 768 steps, march_interp "default".
Each line gives, per warp that marches and averaged over those warps, the
cycles a step of each phase:

  march    the trilinear value, the next position and corner, the
           trajectory row (and, with helper warps, the wait for the next
           step's PE at the step's barrier)
  pe       the PE of the group's active rays, by their own lanes
  vote     the group's barrier that ORs its activity
  L0..L3   each hidden layer (the products, the epilogue, its barrier)
  out      the output layer and the shuffles that share it
  rod+fin  Rodrigues and the rest of the step

and, per step that ran the head, L0..L3 and out. The reads of clock64
order the phases' instructions, so the sum runs above the kernel's device
time; the split says where a step's chain is long. The copy's kernel
writes its figures where the trial build writes pre-activations, so its
trajectories are not read.
"""

import argparse
import pathlib
import shutil

import numpy as np
import torch

from samplenerfro_torch.debug import march_parity
from samplenerfro_torch.models.path_sampler import SO3_MAX_DEG
from samplenerfro_torch.ops import cuda_build
from samplenerfro_torch.ops import march_kernel

PHASES = ("march", "pe", "vote", "L0", "L1", "L2", "L3", "out", "rod+fin")
SLOTS = len(PHASES) + 1  # the phases and the steps that ran the head
OUT = pathlib.Path(__file__).resolve().parents[2] / "build" / "k2_step_split"


def _tick(i):
  return (f"{{ const long long t_ = clock64(); prof[{i}] += t_ - t0_; "
          f"t0_ = t_; }}\n")


def _once(text, old, new):
  if text.count(old) < 1:
    raise SystemExit(f"k2_step_split: march_so3.cu has no {old.strip()!r}")
  return text.replace(old, new, 1)


def instrument(src):
  """march_so3.cu's text with the bf16-head kernel's phases timed."""
  head = src.index("namespace bfh {")
  start = src.index("\n  for (int s = 0; s < a.num_samples; ++s) {", head) + 1
  end = src.index("// K2's bf16 head in one arm and geometry", start)
  body = src[start:end]
  body = _once(body, "  for (int s = 0; s < a.num_samples; ++s) {\n",
               f"  long long prof[{SLOTS}] = {{}};\n"
               "  long long t0_ = clock64();\n"
               "  for (int s = 0; s < a.num_samples; ++s) {\n")
  body = _once(body, "    float ux = gx, uy = gy, uz = gz;\n",
               "    float ux = gx, uy = gy, uz = gz;\n" + _tick(0))
  body = _once(body, "    if (G::any(act)) {\n",
               _tick(1) + "    const bool any_ = G::any(act);\n" + _tick(2)
               + f"    if (any_) {{\n      prof[{SLOTS - 1}] += 1;\n")
  parts = body.split("      layer(K")
  if len(parts) != 5:
    raise SystemExit("k2_step_split: the kernel's four layer() calls moved")
  timed = parts[0]
  for i, part in enumerate(parts[1:]):
    j = part.index(");\n") + 3
    timed += "      layer(K" + part[:j] + _tick(3 + i) + part[j:]
  body = _once(timed, "      if (act) rodrigues(",
               _tick(7) + "      if (act) rodrigues(")
  body = _once(
      body, "                       dz, t);\n  }\n",
      "                       dz, t);\n" + _tick(8) + "  }\n"
      "  if ((threadIdx.x & 31) == 0) {\n"
      f"    float* o = a.pre + (blockIdx.x * (blockDim.x / 32) + "
      f"threadIdx.x / 32) * {SLOTS};\n"
      f"    for (int i = 0; i < {SLOTS}; ++i) o[i] = (float)prof[i];\n"
      "  }\n")
  src = src[:start] + body + src[end:]
  # The figures go where the trial build's pre-activations go, without
  # its layer stores.
  return _once(src, "(pre != nullptr) != bfh::kTrialPreacts",
               "pre == nullptr")


def build_copy():
  """Copies ops/csrc with the kernel instrumented and points the build at
  it; returns the library."""
  csrc = OUT / "csrc"
  shutil.rmtree(csrc, ignore_errors=True)
  shutil.copytree(cuda_build.CSRC, csrc)
  so3 = csrc / "march_so3.cu"
  so3.write_text(instrument(so3.read_text()))
  cuda_build.CSRC, cuda_build.BUILD_DIR = csrc, OUT / "so"
  return march_kernel._so3_library(())  # pylint: disable=protected-access


def split(figures):
  """Over the warps that march (the helper warps write nothing): mean
  cycles a step of each phase, summed over the march; the steps that ran
  the head; L0..out a step that ran it."""
  v = figures.view(-1, SLOTS).cpu().numpy()
  v = v[v[:, 0] > 0]
  heads = float(v[:, SLOTS - 1].mean())
  return v[:, :len(PHASES)].mean(0), heads, v[:, 3:8].mean(0) / max(heads,
                                                                     1.0)


def main():
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--seed", type=int, default=0)
  ns = p.parse_args()
  if not torch.cuda.is_available():
    raise SystemExit("k2_step_split: no CUDA device")
  print(march_parity.card_name(), flush=True)
  lib = build_copy()
  device = torch.device("cuda")
  args, model, _ = march_parity.ship_model(device, ns.seed)
  _, _, first, _, batch = march_parity.ship_inputs(args, ns.seed, device)
  ps = model.path_sampler
  so3 = march_parity.so3_params_for(ns.seed, device)
  sms = march_kernel.sm_count(device)
  loaded = march_kernel._so3_library  # pylint: disable=protected-access
  march_kernel._so3_library = lambda defines=(): lib
  try:
    for shape_name, rays in (("batch", batch), ("chunk", first)):
      b = rays.origins.shape[0]
      for shape in march_kernel.SO3_BF16_SHAPES:
        g = march_kernel.so3_bf16_launch_geometry(b, so3[0].shape[0],
                                                  SO3_MAX_DEG, sms, shape)
        figures = torch.zeros(g["ctas"] * g["threads"] // 32 * SLOTS,
                              device=device)
        for _ in range(2):
          march_kernel._launch_so3(  # pylint: disable=protected-access
              ps.spec, ps.grid, rays.origins, rays.viewdirs, ps.near,
              ps.step_size, ps.num_samples, so3, march_parity.SO3_ALPHA,
              SO3_MAX_DEG, "default", "bfloat16", pre=figures, shape=shape)
        torch.cuda.synchronize()
        steps, heads, per_head = split(figures)
        per_step = steps / ps.num_samples
        print(f"{shape_name} {b} rays, {shape[0]} rays a group x "
              f"{shape[1]}: cycles a step "
              f"{ {k: round(float(x), 1) for k, x in zip(PHASES, per_step)} }"
              f", sum {float(per_step.sum()):.1f}; {heads:.1f} of "
              f"{ps.num_samples} steps ran the head, L0..out a step that "
              f"did {np.round(per_head, 1).tolist()}", flush=True)
  finally:
    march_kernel._so3_library = loaded


if __name__ == "__main__":
  main()
