"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed N] [--profile]

Phases, each of which must pass or the script exits non-zero:
  1. device: a CUDA card is required; prints its name and power limit.
  2. build: compiles every kernel under samplenerfro_torch/ops/csrc.
  3. model: the ship configuration (configs/tpu/ship_*.yaml + .gin) at full
     width with weights drawn from --seed, on a synthetic 512^3 IOR blob
     grid prefiltered 9/3 on the card.
  4. kernels: each kernel of the render path against its plain PyTorch
     version on the card, at the render's shapes (the first 8192-ray chunk
     of the view), with timings beside the kernel's bound.
  5. main path: one 256x256 view rendered through samplenerfro_torch.eval's
     render function (8 chunks of 8192 rays); every kernel must have been
     launched during it.
  6. CPU cross-check: 256 of those rays rendered with the same model and
     grid on the CPU (the plain march) against the card's output.
The last two lines are the kernel report and {"ok": true, "device": ...}.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from samplenerfro_torch.data import rays as rays_lib
from samplenerfro_torch.eval import make_render_fn
from samplenerfro_torch.models import nerf
from samplenerfro_torch.ops import cuda_build
from samplenerfro_torch.ops import grid as grid_ops
from samplenerfro_torch.ops import march_kernel
from samplenerfro_torch.utils import config as config_lib
from samplenerfro_torch.utils import grid_io
from samplenerfro_torch.utils import render as render_lib

SHIP = "configs/tpu/ship_skydome-bkgd_no-partial-reflect_cycles"
GRID_N = 512
RES = 256
CAMERA_ANGLE_X = 0.6911112070083618  # the Blender scenes' field of view
HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12                   # H100 SXM fp32 outside tensor cores
# K1 (fp32, FMA contraction off in both versions) against its plain
# version over 768 Euler steps: the only differences left are the order
# of the 3-term sums, a few ulp that the march carries forward.
K1_ATOL = 1e-4
# Whole render, card against CPU: cuBLAS and the CPU BLAS sum the MLP
# products in different orders (fp32, no TF32) and the march differs by
# the ulps above; a fine sample may move by those, so colours and opacity
# agree to ~1e-5 and are held at 1e-4.
XCHECK_ATOL = 1e-4


def log(msg):
  print(msg, flush=True)


def camera_rays(res, radius=4.0, theta=0.6, phi=0.35):
  """Pinhole rays of a camera at `radius` looking at the origin."""
  eye = radius * np.array([np.cos(theta) * np.cos(phi),
                           np.sin(theta) * np.cos(phi), np.sin(phi)])
  fwd = eye / np.linalg.norm(eye)
  right = np.cross([0.0, 0.0, 1.0], fwd)
  right /= np.linalg.norm(right)
  c2w = np.eye(4)
  c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = (
      right, np.cross(fwd, right), fwd, eye)
  focal = 0.5 * res / np.tan(0.5 * CAMERA_ANGLE_X)
  rays = rays_lib.generate_pinhole_rays(res, res, focal, c2w[None], True)
  return rays_lib.namedtuple_map(lambda r: r[0], rays)


def cuda_ms(fn, reps=5):
  """Median milliseconds of fn() over `reps` timed runs after one warm-up."""
  fn()
  times = []
  for _ in range(reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    times.append(start.elapsed_time(end))
  return float(np.median(times))


def device_phase():
  if not torch.cuda.is_available():
    raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                     "is false)")
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, timeout=60, check=True)
  card = smi.stdout.strip().splitlines()[0]
  log(f"card: {card}")
  log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
      f"{torch.cuda.device_count()} device(s)")
  return card


def build_phase():
  t0 = time.time()
  logs = cuda_build.build(cuda_build.kernel_names())
  log(f"build: {time.time() - t0:.1f} s for {cuda_build.kernel_names()}")
  for name, out in logs.items():
    for line in out.splitlines():
      if "registers" in line or "spill" in line:
        log(f"  {name}: {line.strip()}")


def model_phase(device, seed, grid_n=GRID_N, **overrides):
  """The ship-configured NerfModel on a prefiltered synthetic blob grid."""
  args, cfg, bindings = config_lib.load_args(SHIP, [SHIP + ".gin"],
                                             **overrides)
  t0 = time.time()
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(grid_n, 1.5, 0.33)
  grid = grid_ops.gaussian_prefilter(torch.from_numpy(values).to(device),
                                     tuple(ndim), cfg.kernel_size,
                                     cfg.kernel_sigma)
  model = nerf.construct_nerf(args, ndim, nmin, nmax, grid, bindings,
                              device=device, seed=seed)
  if device.type == "cuda":
    torch.cuda.synchronize()
  log(f"model: {grid_n}^3 grid prefiltered {cfg.kernel_size}/"
      f"{cfg.kernel_sigma}, {args.net_depth}x{args.net_width} MLPs, "
      f"{args.num_coarse_samples}x{args.num_path_samples} march steps, "
      f"{args.num_fine_samples} fine samples: {time.time() - t0:.1f} s")
  return args, model


def march_bytes_and_flops(spec, pos, batch, num_samples, num_coarse):
  """K1's least work: outputs written once, inputs and the distinct grid
  voxels this run's paths touch read once; ~120 fp32 operations a step."""
  nmin, ndelta = spec.axis_tensors(pos.device)
  hi = torch.tensor(spec.ndim, device=pos.device) - 1
  c0 = torch.floor((pos.reshape(-1, 3) - nmin) / ndelta).to(torch.int64)
  voxels = []
  nx, ny, nz = spec.ndim
  for dx in (0, 1):
    for dy in (0, 1):
      for dz in (0, 1):
        c = torch.minimum(torch.clamp(
            c0 + torch.tensor([dx, dy, dz], device=pos.device), min=0), hi)
        voxels.append((c[:, 0] * ny + c[:, 1]) * nz + c[:, 2])
  distinct = int(torch.unique(torch.cat(voxels)).numel())
  written = 4 * 7 * batch * (num_samples + num_coarse)
  read = 4 * (6 * batch + num_coarse) + 16 * distinct
  return written + read, 120 * batch * num_samples, distinct


def kernel_phase(model, chunk_rays, jitter):
  """K1 against its plain version on the card, timed, with its bound."""
  ps = model.path_sampler
  args = (ps.spec, ps.grid, chunk_rays.origins, chunk_rays.viewdirs, ps.near,
          ps.step_size, ps.num_samples, jitter)
  got = march_kernel.march_lean(*args)
  torch.cuda.synchronize()
  want = march_kernel.march_lean_reference(*args)
  names = ("pos", "dir", "dist", "sub_pos", "sub_dir", "sub_dist")
  err = 0.0
  for name, a, b in zip(names, got, want):
    per = (a - b).abs().reshape(-1, a.shape[-1] if a.dim() == 3 else 1)
    per = per.amax(dim=0).tolist()
    log(f"  K1 {name}: max abs err per channel {per}")
    if not all(np.isfinite(per)):
      raise SystemExit(f"K1 {name}: non-finite output")
    err = max(err, max(per))
  if err > K1_ATOL:
    raise SystemExit(f"K1 disagrees with its plain version: {err} > "
                     f"{K1_ATOL}")
  ms = cuda_ms(lambda: march_kernel.march_lean(*args))
  plain_ms = cuda_ms(lambda: march_kernel.march_lean_reference(*args))
  nbytes, flops, distinct = march_bytes_and_flops(
      ps.spec, want[0], chunk_rays.origins.shape[0], ps.num_samples,
      jitter.shape[0])
  t_bytes, t_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / FP32_FLOPS
  bound_ms = max(t_bytes, t_ops)
  log(f"  K1 march_lean: {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
      f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB incl. {distinct} distinct "
      f"voxels; {flops / 1e9:.3f} GFLOP = {t_ops:.4f} ms)")
  return {"name": "march_lean", "route": "cuda",
          "source": "samplenerfro_torch/ops/csrc/march_lean.cu",
          "replaces": "samplenerfro_tpu/ops/pallas/march_kernel.py:248",
          "launches": None, "max_abs_err": err, "ms": ms,
          "plain_ms": plain_ms, "bound_ms": bound_ms,
          "bound_by": "bytes" if t_bytes >= t_ops else "operations",
          "library_ms": None}


def main_path_phase(model, view, jitter, chunk, device, profile=False):
  """Render the view through eval's render function; returns its outputs."""
  render_fn = make_render_fn(model, jitter)
  render_lib.render_image(render_fn, view, False, chunk=chunk, device=device)
  torch.cuda.synchronize()
  march_kernel.march_lean.launches = 0
  t0 = time.time()
  rgb, dist, acc = render_lib.render_image(render_fn, view, False,
                                           chunk=chunk, device=device)
  torch.cuda.synchronize()
  secs = time.time() - t0
  launches = march_kernel.march_lean.launches
  n = rgb.shape[0] * rgb.shape[1]
  n_chunks = -(-n // chunk)
  log(f"main path: {rgb.shape[0]}x{rgb.shape[1]} view, {n_chunks} chunks, "
      f"{secs:.3f} s, {n / secs:.1f} rays/s, march_lean launches "
      f"{launches}")
  for name, x in (("rgb", rgb), ("distance", dist), ("acc", acc)):
    if not np.all(np.isfinite(x)):
      raise SystemExit(f"main path: non-finite {name}")
  if acc.min() < 0 or acc.max() > 1:
    raise SystemExit(f"main path: acc outside [0, 1]: {acc.min()} "
                     f"{acc.max()}")
  if launches != n_chunks:
    raise SystemExit(f"main path: march_lean launched {launches} times for "
                     f"{n_chunks} chunks")
  log(f"  rgb mean {rgb.mean():.6f}, acc mean {acc.mean():.6f}, distance "
      f"range [{dist.min():.4f}, {dist.max():.4f}]")
  if profile:
    profile_chunk(render_fn, view, chunk, device)
  return rgb, acc, launches


def profile_chunk(render_fn, view, chunk, device):
  """Device time by kernel for one chunk (torch.profiler)."""
  from torch.profiler import ProfilerActivity
  from torch.profiler import profile as tprofile
  flat = rays_lib.namedtuple_map(
      lambda r: torch.from_numpy(np.ascontiguousarray(
          r.reshape(-1, r.shape[-1])[:chunk])).to(device), view)
  with torch.no_grad(), tprofile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
    render_fn(flat)
    torch.cuda.synchronize()
  log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=20))


def cross_check_phase(model, view, jitter, rgb_gpu, acc_gpu, n=256):
  """The first `n` rays of the render order on the CPU against the card."""
  perm, _ = render_lib.tile_order(RES, RES, render_lib.TILE)
  idx = perm[:n]
  flat = rays_lib.namedtuple_map(
      lambda r: torch.from_numpy(r.reshape(-1, r.shape[-1])[idx].copy()),
      view)
  model.to("cpu")
  t0 = time.time()
  with torch.no_grad():
    out = model(flat, jitter.cpu(), randomized=False)[-1]
  rgb_cpu, acc_cpu = out[0].numpy(), out[2].numpy()
  e_rgb = float(np.abs(rgb_cpu - rgb_gpu.reshape(-1, 3)[idx]).max())
  e_acc = float(np.abs(acc_cpu - acc_gpu.reshape(-1)[idx]).max())
  log(f"cpu cross-check: {n} rays in {time.time() - t0:.1f} s, max abs err "
      f"rgb {e_rgb:.3e}, acc {e_acc:.3e} (tolerance {XCHECK_ATOL})")
  if not (e_rgb <= XCHECK_ATOL and e_acc <= XCHECK_ATOL):
    raise SystemExit("cpu cross-check failed")


def main():
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--seed", type=int, default=0)
  p.add_argument("--profile", action="store_true",
                 help="print device time by kernel for one render chunk")
  ns = p.parse_args()

  t_start = time.time()
  card = device_phase()
  device = torch.device("cuda")
  build_phase()
  args, model = model_phase(device, ns.seed)
  view = camera_rays(RES)
  jitter = nerf.make_jitter(args.num_coarse_samples, args.num_path_samples,
                            torch.Generator().manual_seed(ns.seed), device)

  perm, _ = render_lib.tile_order(RES, RES, render_lib.TILE)
  first = rays_lib.namedtuple_map(
      lambda r: torch.from_numpy(
          r.reshape(-1, r.shape[-1])[perm[:args.chunk]].copy()).to(device),
      view)
  with torch.no_grad():
    report = [kernel_phase(model, first, jitter)]
  del first
  torch.cuda.empty_cache()

  rgb, acc, launches = main_path_phase(model, view, jitter, args.chunk,
                                       device, ns.profile)
  report[0]["launches"] = launches
  cross_check_phase(model, view, jitter, rgb, acc)

  log(f"total: {time.time() - t_start:.1f} s")
  log(f"card: {card}")
  print(json.dumps({"kernels": report}))
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
  sys.exit(main())
