"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed N] [--profile]

--profile adds torch.profiler tables: one render chunk and one radiance
train step with the nn.Linear MLPs and again with the fused MLP (K4/K5),
and one 'all' train step.

Phases, each of which must pass or the script exits non-zero:
  1. device: a CUDA card is required; prints its name and power limit.
  2. build: compiles every kernel under samplenerfro_torch/ops/csrc, one
     nvcc per source, all started together. P1 (x + 1) must then come back
     exact; P2 (sinf at argument scales 1 to 2048) within 1e-6 of float64.
     Then the selfcheck: samplenerfro_torch.train.selfcheck.check_march at
     its defaults (the JAX gate's 128^3 blob, 512 rays of 768 steps, the
     'all' arm on 256 rays of 192 steps, the so3 head at ship width 4x128);
     K1, K2 and K3 must each launch, every deviation inside its envelope
     (forward 2e-3, gradients 5e-3, loss 1e-4 of scale). Then P3 (the so3
     head's pre-activations summed as K3 sums them) against its plain
     version (cuBLAS) at the probe's 49,152 points, with the ReLU masks the
     two set apart, and the probe's own path (samplenerfro_torch.debug.
     probe_so3_relu.probe), which must launch P3 once.
  3. model: the ship configuration (configs/tpu/ship_*.yaml + .gin) at full
     width with weights drawn from --seed, on a synthetic 512^3 IOR blob
     grid prefiltered 9/3 on the card.
  4. kernels: each kernel against its plain PyTorch version on the card, at
     the shapes its path gives it, timed beside its bound: K1 at the
     render's first 8192-ray chunk; K2 (so3 march) and K3 (its reverse
     sweep) at a 1024-ray training batch, with so3 weights drawn from
     --seed at output std 1e-2 so that the head bends the paths; P3 at
     that batch's active ray-steps, the points K3 recomputes. K4 (the
     fused NerfMLP forward) in fp32, fed with features and with raw samples
     (pe), at the render's first chunk's fine call, and in bf16 at a
     training batch's fine call; K5 (its parameter backward) in bf16 and
     fp32 at that call, twice, bit for bit. Each beside the time of the
     port's nn.Linear stack for the same work (unfused).
  5. render path: one 256x256 view rendered through samplenerfro_torch.eval's
     render function (8 chunks of 8192 rays); K1 must have been launched
     once per chunk. Then the same view with --mlp_kernel=pallas and
     pallas_pe: K4 twice per chunk, K5 never, colours and opacity within
     1e-4 of the nn.Linear render.
  6. train path: radiance steps, then 'all' steps, through
     samplenerfro_torch.train.step.train_step (what `python -m
     samplenerfro_torch.train` calls) on a repeated synthetic 1024-ray
     batch with a 128x128 env-ray patch, bf16 MLPs, as a run resumed at
     step 80000 takes them. Losses and gradients must be finite, the
     radiance loss must fall, the so3 gradients must be non-zero, and K1
     must run once per radiance step, K2 and K3 once per 'all' step. Then
     radiance steps with --mlp_kernel=pallas (bf16): K4 and K5 twice a
     step, the loss falling; and 'all' steps with the flag set, which must
     launch neither (the 'all' stage keeps nn.Linear).
  7. CPU cross-checks: 256 rays of the view rendered on the CPU (the plain
     march) against the card; one 'all' step's loss and so3 gradients on
     128 rays, fp32 MLPs, on the CPU (plain K2 and K3) against the card,
     with P3's count of the ReLU masks the two set apart;
     one fused radiance step's loss and MLP gradients on 128 rays, fp32,
     on the CPU (plain K1, K4, K5) against the card.
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
from samplenerfro_torch.debug import probe_so3_relu
from samplenerfro_torch.eval import make_render_fn
from samplenerfro_torch.models import convert
from samplenerfro_torch.models import nerf
from samplenerfro_torch.models.path_sampler import SO3_MAX_DEG
from samplenerfro_torch.ops import cuda_build
from samplenerfro_torch.ops import eikonal_vjp
from samplenerfro_torch.ops import grid as grid_ops
from samplenerfro_torch.ops import march_kernel
from samplenerfro_torch.ops import math as math_ops
from samplenerfro_torch.ops import mlp as mlp_ops
from samplenerfro_torch.ops import mlp_kernel
from samplenerfro_torch.ops import render as render_ops
from samplenerfro_torch.train import selfcheck
from samplenerfro_torch.train import step as step_lib
from samplenerfro_torch.train.loop import annealed_alpha
from samplenerfro_torch.train.loop import batch_to_device
from samplenerfro_torch.utils import config as config_lib
from samplenerfro_torch.utils import grid_io
from samplenerfro_torch.utils import probes
from samplenerfro_torch.utils import render as render_lib

SHIP = "configs/tpu/ship_skydome-bkgd_no-partial-reflect_cycles"
MARCH_KERNEL = "samplenerfro_tpu/ops/pallas/march_kernel.py:248"
MLP_KERNEL = "samplenerfro_tpu/ops/pallas/mlp_kernel.py"
GRID_N = 512
RES = 256
CAMERA_ANGLE_X = 0.6911112070083618  # the Blender scenes' field of view
HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12                   # H100 SXM fp32 outside tensor cores
BF16_TC_FLOPS = 989e12               # H100 SXM dense bf16 tensor cores,
                                     # NVIDIA data sheet
# K1 (fp32, FMA contraction off in both versions) against its plain
# version over 768 Euler steps: the only differences left are the order
# of the 3-term sums, a few ulp that the march carries forward.
K1_ATOL = 1e-4
# Whole render, card against CPU: cuBLAS and the CPU BLAS sum the MLP
# products in different orders (fp32, no TF32) and the march differs by
# the ulps above; a fine sample may move by those, so colours and opacity
# agree to ~1e-5 and are held at 1e-4.
XCHECK_ATOL = 1e-4
# K2 against its plain version: the march as K1, plus the so3 MLP, whose
# products K2 sums in its own order (fp32 FMA, no TF32) where cuBLAS sums
# in another; the refined gradient differs by ~1e-7 relative a step, and
# 768 steps carry that forward. Held at K1's 1e-4.
K2_ATOL = 1e-4
# K3 against autograd of the plain march: the JAX package's own tolerance
# for its reverse sweep (tests/test_eikonal_vjp.py:108-111), per tensor:
# |got - want| <= 2e-4 * max|want| + 2e-3 * |want|.
K3_ATOL_SCALE, K3_RTOL = 2e-4, 2e-3
SO3_STD = 1e-2     # so3 output init for the kernel phases (ship: 1e-5)
SO3_ALPHA = 0.7    # annealing progress for the kernel phases
TRAIN_FROM = 80000  # the train path's steps continue a run at this step
N_RADIANCE, N_ALL = 12, 4
N_ALL_FUSED = 2  # 'all' steps with --mlp_kernel=pallas, which keep nn.Linear
XCHECK_RAYS = 128
# One 'all' step, card against CPU, fp32 MLPs, not randomized: the loss to
# 1e-4 relative (K1's and K2's ulps moved through the MLPs), the so3
# gradients at the K3 tolerance.
XCHECK_LOSS_RTOL = 1e-4
# P2: CUDA documents sinf at 2 ulp, <= 1e-6 of a value in [-1, 1] at these
# arguments.
P2_ATOL = 1e-6
# P3 against its plain version, max abs error over the largest
# |pre-activation|: both sum the same fp32 products, in other orders.
P3_ATOL = 1e-5
# K4 against its plain version. fp32: both sum fp32 products, in other
# orders (cuBLAS without TF32 for the plain version). bf16: the products
# are exact on both sides; a sum in another order can round a
# pre-activation to the other bf16 neighbour, which later layers carry (up
# to 1.3e-3 in one row, 6.6e-6 in the mean: tests/test_torch_mlp_kernel.py).
K4_FP32_ATOL = 1e-5
K4_BF16_MAX, K4_BF16_MEAN = 4e-3, 3e-5
# K5 against its plain version, per tensor: fp32 at the K3 form
# |got - want| <= 2e-4 * max|want| + 2e-3 * |want| (summation order, and
# in the card-vs-CPU check the march's ulps carried through the encoding);
# bf16 at 2e-3 * max|want| (an ulp-rounded cotangent or a ReLU mask at 0
# moves one row's contribution).
K5_ATOL_SCALE, K5_RTOL = 2e-4, 2e-3
K5_BF16_SCALE = 2e-3


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
  return args, model, (ndim, nmin, nmax, grid, bindings)


def distinct_voxels(spec, pos):
  """Grid voxels the trilinear gathers at these path vertices touch."""
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
  return int(torch.unique(torch.cat(voxels)).numel())


def march_bytes_and_flops(spec, pos, batch, num_samples, num_coarse):
  """K1's least work: outputs written once, inputs and the distinct grid
  voxels this run's paths touch read once; ~120 fp32 operations a step."""
  distinct = distinct_voxels(spec, pos)
  written = 4 * 7 * batch * (num_samples + num_coarse)
  read = 4 * (6 * batch + num_coarse) + 16 * distinct
  return written + read, 120 * batch * num_samples, distinct


def so3_flops(so3):
  """fp32 operations of one so3 head evaluation: 2 per weight (a multiply
  and an add) plus the 60 sines and the Rodrigues rotation (~60)."""
  weights = sum(p.numel() for p in so3[0::2])
  return 2 * weights + 6 * SO3_MAX_DEG + 60


def report_row(name, replaces, err, ms, plain_ms, bound_ms, bound_by,
               source=None, **extra):
  """One kernel's entry of the report line; `launches` is filled from its
  path's run. No single PyTorch call computes a march, its reverse sweep,
  the fused NerfMLP or its weight gradients, so there is no library time
  (the MLP rows carry `unfused_ms`, the port's own nn.Linear stack, as
  their yardstick instead)."""
  return {"name": name, "route": "cuda",
          "source": source or f"samplenerfro_torch/ops/csrc/{name}.cu",
          "replaces": replaces,
          "launches": None, "max_abs_err": err, "ms": ms,
          "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
          "library_ms": None, **extra}


def bound(nbytes, flops, peak=FP32_FLOPS):
  """(bound ms, what bounds it) at the card's HBM rate and `peak`."""
  t_bytes, t_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / peak
  return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                               "operations")


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
  bound_ms, bound_by = bound(nbytes, flops)
  log(f"  K1 march_lean: {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
      f"{bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB incl. "
      f"{distinct} distinct voxels; {flops / 1e9:.3f} GFLOP)")
  return report_row("march_lean", MARCH_KERNEL, err, ms, plain_ms, bound_ms,
                    bound_by)


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
  return rgb, acc, launches, n / secs


def fused_render_phase(model, view, jitter, chunk, device, rgb_ref, acc_ref,
                       xla_rate, profile=False):
  """The view again with --mlp_kernel=pallas and pallas_pe; returns the K4
  launches of each render."""
  render_fn = make_render_fn(model, jitter)
  n_chunks = -(-RES * RES // chunk)
  counts, saved = {}, model.mlp_kernel
  try:
    for name in ("pallas", "pallas_pe"):
      model.mlp_kernel = name
      render_lib.render_image(render_fn, view, False, chunk=chunk,
                              device=device)
      torch.cuda.synchronize()
      mlp_kernel.mlp_fwd.launches = mlp_kernel.mlp_bwd.launches = 0
      t0 = time.time()
      rgb, dist, acc = render_lib.render_image(render_fn, view, False,
                                               chunk=chunk, device=device)
      torch.cuda.synchronize()
      secs = time.time() - t0
      k4, k5 = mlp_kernel.mlp_fwd.launches, mlp_kernel.mlp_bwd.launches
      e_rgb = float(np.abs(rgb - rgb_ref).max())
      e_acc = float(np.abs(acc - acc_ref).max())
      log(f"fused render path (--mlp_kernel={name}): {secs:.3f} s, "
          f"{RES * RES / secs:.1f} rays/s (nn.Linear: {xla_rate:.1f}), "
          f"K4 launches {k4}, K5 {k5}; against the nn.Linear render max abs "
          f"err rgb {e_rgb:.3e}, acc {e_acc:.3e} (tolerance {XCHECK_ATOL})")
      if not all(np.all(np.isfinite(x)) for x in (rgb, dist, acc)):
        raise SystemExit(f"fused render ({name}): non-finite output")
      if (k4, k5) != (2 * n_chunks, 0):
        raise SystemExit(f"fused render ({name}): K4/K5 launched {k4}/{k5} "
                         f"times for {n_chunks} chunks")
      if not (e_rgb <= XCHECK_ATOL and e_acc <= XCHECK_ATOL):
        raise SystemExit(f"fused render ({name}) disagrees with nn.Linear")
      counts[name] = k4
      if profile and name == "pallas":
        profile_chunk(render_fn, view, chunk, device)
  finally:
    model.mlp_kernel = saved
  return counts


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
    out = model(flat, jitter.cpu(), randomized=False,
                mlp_dtype=torch.float32)[-1]
  rgb_cpu, acc_cpu = out[0].numpy(), out[2].numpy()
  e_rgb = float(np.abs(rgb_cpu - rgb_gpu.reshape(-1, 3)[idx]).max())
  e_acc = float(np.abs(acc_cpu - acc_gpu.reshape(-1)[idx]).max())
  log(f"cpu cross-check: {n} rays in {time.time() - t0:.1f} s, max abs err "
      f"rgb {e_rgb:.3e}, acc {e_acc:.3e} (tolerance {XCHECK_ATOL})")
  if not (e_rgb <= XCHECK_ATOL and e_acc <= XCHECK_ATOL):
    raise SystemExit("cpu cross-check failed")


def synthetic_batch(args, seed):
  """A host training batch: `batch_size` random pixels of a camera at a
  seeded pose, the target 0.5 + 0.5 * viewdir, and a bg_patch_size^2
  env-ray patch of the same view."""
  rng = np.random.RandomState(seed)
  view = camera_rays(RES, theta=rng.uniform(0, 2 * np.pi),
                     phi=rng.uniform(0.2, 0.8))
  flat = rays_lib.namedtuple_map(lambda r: r.reshape(-1, r.shape[-1]), view)
  idx = rng.choice(RES * RES, args.batch_size, replace=False)
  rays = rays_lib.namedtuple_map(lambda r: r[idx], flat)
  ps = args.bg_patch_size
  x, y = rng.randint(0, RES - ps, 2)
  env = rays_lib.namedtuple_map(lambda r: r[y:y + ps, x:x + ps], view)
  return {"pixels": (0.5 + 0.5 * rays.viewdirs).astype(np.float32),
          "rays": rays, "env_rays": env}


def so3_kernel_phases(model, batch, seed):
  """K2 and K3 against their plain versions on the card, timed, with
  their bounds, on one training batch's rays."""
  ps = model.path_sampler
  dev = ps.grid.device
  head = mlp_ops.So3MLP(6 * SO3_MAX_DEG, output_init_std=SO3_STD,
                        generator=torch.Generator().manual_seed(seed))
  so3 = [p.detach().to(dev) for p in head.params()]
  o = torch.from_numpy(batch["rays"].origins).to(dev)
  d = torch.from_numpy(batch["rays"].viewdirs).to(dev)
  fwd_args = (ps.spec, ps.grid, o, d, ps.near, ps.step_size, ps.num_samples,
              so3, SO3_ALPHA, SO3_MAX_DEG)
  traj = march_kernel.march_full(*fwd_args)
  torch.cuda.synchronize()
  want = march_kernel.march_full_reference(*fwd_args)
  per = (traj - want).abs().reshape(-1, 11).amax(dim=0).tolist()
  log(f"  K2 max abs err per channel (pos 3, dir 3, dist, n, grad n 3): "
      f"{per}")
  err2 = max(per)
  if not (np.all(np.isfinite(per)) and err2 <= K2_ATOL):
    raise SystemExit(f"K2 disagrees with its plain version: {err2} > "
                     f"{K2_ATOL}")
  batch_n, steps = o.shape[0], ps.num_samples
  active = int((traj[..., 8:11].norm(dim=-1) > 1e-3).sum())
  distinct = distinct_voxels(ps.spec, traj[..., 0:3])
  nparams = sum(p.numel() for p in so3)
  mlp_flops = so3_flops(so3) * active
  march_ops = 120 * batch_n * steps
  ms2 = cuda_ms(lambda: march_kernel.march_full(*fwd_args))
  plain2 = cuda_ms(lambda: march_kernel.march_full_reference(*fwd_args), 3)
  bytes2 = 44 * batch_n * steps + 16 * distinct + 24 * batch_n + 4 * nparams
  bound2, by2 = bound(bytes2, mlp_flops + march_ops)
  log(f"  K2 march_so3: {ms2:.4f} ms, plain {plain2:.3f} ms, bound "
      f"{bound2:.4f} ms by {by2} ({active} of {batch_n * steps} ray-steps "
      f"active, {(mlp_flops + march_ops) / 1e9:.3f} GFLOP, "
      f"{bytes2 / 1e6:.1f} MB incl. {distinct} distinct voxels)")

  # K3 sweeps the plain march's trajectory, the one march_bwd_reference
  # replays, so that both differentiate the same path: K2's own path
  # differs by the ulps above, which the PE multiplies by up to 2^9 and
  # which then flip ReLU masks of the head near 0.
  cfg = eikonal_vjp.MarchConfig(ps.spec, ps.near, ps.step_size, steps,
                                SO3_MAX_DEG)
  gen = torch.Generator().manual_seed(seed + 1)
  dtraj = torch.randn(traj.shape, generator=gen).to(dev)
  bwd_args = (cfg, ps.grid, o, d, so3, SO3_ALPHA, want, dtraj)
  swept = want[..., 8:11].norm(dim=-1) > 1e-3
  p3_case("'all' batch, active ray-steps", want[..., 0:3][swept].contiguous(),
          so3, SO3_ALPHA)
  by_step = probes.so3_preacts_by_step(want[..., 0:3], so3, SO3_ALPHA)
  layers = probes.relu_flips(*zip(*by_step), mask=swept)
  del by_step, swept
  log("  P3 'all' batch against the plain version called a step at a time, "
      "as the plain march calls the head, over the active ray-steps, per "
      "layer (max abs err, ReLU flips, min |pre-activation|): "
      f"{[(r['max_dev'], r['flips'], r['min_abs']) for r in layers]}")
  got = eikonal_vjp.march_bwd(*bwd_args)
  torch.cuda.synchronize()
  ref = eikonal_vjp.march_bwd_reference(cfg, ps.grid, o, d, so3, SO3_ALPHA,
                                        dtraj)
  flat = lambda r: [r[0], r[1], r[2]] + list(r[3])
  names = ["origins", "directions", "alpha"] + [
      f"so3 {n}.{k}" for n in ("Dense_0", "Dense_1", "Dense_2", "Dense_3",
                               "Dense_out") for k in ("weight", "bias")]
  err3 = 0.0
  for name, g, w in zip(names, flat(got), flat(ref)):
    diff = (g - w).abs()
    scale = float(w.abs().max())
    worst = float((diff / (K3_ATOL_SCALE * scale + K3_RTOL * w.abs()))
                  .max()) if scale > 0 else 0.0
    log(f"  K3 {name}: max abs err {float(diff.max()):.3e} of scale "
        f"{scale:.3e} ({worst:.3f} of the tolerance)")
    if not (bool(torch.isfinite(g).all()) and worst <= 1.0):
      raise SystemExit(f"K3 {name} disagrees with its plain version")
    err3 = max(err3, float(diff.max()))
  again = eikonal_vjp.march_bwd(*bwd_args)
  if not all(torch.equal(a, b) for a, b in zip(flat(got), flat(again))):
    raise SystemExit("K3 is not deterministic: two runs differ")
  log("  K3 two runs agree bit for bit")
  ms3 = cuda_ms(lambda: eikonal_vjp.march_bwd(*bwd_args))
  plain3 = cuda_ms(lambda: eikonal_vjp.march_bwd_reference(
      cfg, ps.grid, o, d, so3, SO3_ALPHA, dtraj), 3)
  # Least work: the head's forward, its backward to the input and its
  # weight gradients at each active ray-step (3x K2's MLP arithmetic) plus
  # ~200 operations of step adjoints a ray-step; the trajectory and its
  # cotangent read once, the voxels once, the weights read and their
  # gradients written once.
  flops3 = 3 * mlp_flops + 200 * batch_n * steps
  bytes3 = (2 * 44 * batch_n * steps + 16 * distinct + 24 * batch_n
            + 8 * nparams)
  bound3, by3 = bound(bytes3, flops3)
  log(f"  K3 march_bwd: {ms3:.4f} ms, plain {plain3:.3f} ms, bound "
      f"{bound3:.4f} ms by {by3} ({flops3 / 1e9:.3f} GFLOP, "
      f"{bytes3 / 1e6:.1f} MB)")
  return (report_row("march_so3", MARCH_KERNEL, err2, ms2, plain2, bound2,
                     by2),
          report_row("march_bwd",
                     "samplenerfro_tpu/ops/pallas/march_bwd_kernel.py:168",
                     err3, ms3, plain3, bound3, by3))


def probe_phase(device):
  """P1 right after the build, then P2; returns their report rows."""
  x = probes.probe_inputs((8, 128)).to(device)
  probes.add_one.launches = probes.sin.launches = 0
  t0 = time.time()
  y = probes.add_one(x)
  torch.cuda.synchronize()
  secs = time.time() - t0
  if not torch.equal(y, x + 1):
    raise SystemExit("P1: x + 1 came back wrong")
  launches1 = probes.add_one.launches
  ms1 = cuda_ms(lambda: probes.add_one(x))
  plain1 = cuda_ms(lambda: x + 1)
  log(f"P1 probe_add_one: exact, first launch {secs * 1e3:.3f} ms, "
      f"{ms1:.4f} ms, plain {plain1:.4f} ms")
  errs = probes.sin_errors(device)
  for scale, e64, elib in errs:
    log(f"P2 sinf at scale {scale:g}: max abs err {e64:.3e} against float64, "
        f"{elib:.3e} against torch.sin on the card")
  worst = max(e for _, e, _ in errs)
  if worst > P2_ATOL:
    raise SystemExit(f"P2: sinf off by {worst} > {P2_ATOL}")
  launches2 = probes.sin.launches
  xs = (probes.probe_inputs((8, 256)) * 2048.0).to(device)
  ms2 = cuda_ms(lambda: probes.sin(xs))
  plain2 = cuda_ms(lambda: torch.sin(xs))
  rows = []
  for name, replaces, launches, err, ms, plain, n in (
      ("probe_add_one", "samplenerfro_tpu/utils/mosaic_probe.py:39",
       launches1, 0.0, ms1, plain1, 8 * 128),
      ("probe_sin", "scripts/debug/dbg_sin.py:16", launches2, worst, ms2,
       plain2, 8 * 256)):
    # Least work: the block read once and written once; a sine is ~20
    # operations.
    bound_ms, by = bound(8 * n, 20 * n)
    # The plain version is one PyTorch call (x + 1, torch.sin), so it is
    # the library yardstick as well.
    row = report_row(name, replaces, err, ms, plain, bound_ms, by,
                     source="samplenerfro_torch/ops/csrc/probes.cu")
    row["launches"], row["library_ms"] = launches, plain
    rows.append(row)
  return rows


def selfcheck_phase():
  """selfcheck.check_march at its defaults on the card, with K1, K2 and
  K3's counts zeroed before it and read after."""
  march_kernel.march_lean.launches = 0
  march_kernel.march_full.launches = 0
  eikonal_vjp.march_bwd.launches = 0
  t0 = time.time()
  envelopes = {}
  deviations, not_run = selfcheck.check_march(envelopes=envelopes)
  counts = (march_kernel.march_lean.launches,
            march_kernel.march_full.launches, eikonal_vjp.march_bwd.launches)
  log(f"selfcheck: {time.time() - t0:.1f} s, launches K1 {counts[0]}, K2 "
      f"{counts[1]}, K3 {counts[2]}")
  for name, dev in deviations.items():
    log(f"  {name}: {dev:.3e}, envelope {envelopes[name]:.3e} "
        f"({dev / envelopes[name]:.3f} of it)")
  for msg in not_run:
    log(f"  {msg}")
  if min(counts) == 0:
    raise SystemExit(f"selfcheck: launches K1/K2/K3 {counts}, each must be "
                     f"at least 1")


def p3_case(what, pos, so3, alpha):
  """P3 against its plain version at points `pos` [N, 3], timed, with its
  bound; returns (max abs err, ms, plain ms, bound ms, bound by)."""
  got = probes.so3_preacts(pos, so3, alpha)
  torch.cuda.synchronize()
  want = probes.so3_preacts_reference(pos, so3, alpha)
  layers = probes.relu_flips(got, want)
  scale = max(float(w.abs().max()) for w in want)
  err = max(r["max_dev"] for r in layers)
  del got, want
  for i, r in enumerate(layers, 1):
    log(f"  P3 {what}, layer {i}: max abs err {r['max_dev']:.3e}, ReLU "
        f"flips {r['flips']} of {r['elements']}, min |pre-activation| "
        f"{r['min_abs']:.3e}")
  if not (np.isfinite(err) and err <= P3_ATOL * scale):
    raise SystemExit(f"P3 ({what}) disagrees with its plain version: {err} "
                     f"> {P3_ATOL} * {scale}")
  ms = cuda_ms(lambda: probes.so3_preacts(pos, so3, alpha))
  plain = cuda_ms(lambda: probes.so3_preacts_reference(pos, so3, alpha))
  # Least work: the PE (~20 operations a sine) and the three layers'
  # multiply-adds (2 operations each); the points and the three layers'
  # weights read once, the three [N, width] outputs written once.
  n = pos.shape[0]
  width, in_dim = so3[0].shape
  macs = in_dim * width + 2 * width * width
  weights = macs + 3 * width
  nbytes = 12 * n + 4 * weights + 12 * n * width
  bound_ms, by = bound(nbytes, n * (2 * macs + 20 * in_dim))
  log(f"  P3 so3_preacts {what} ({n} points): {ms:.4f} ms, plain "
      f"{plain:.4f} ms, bound {bound_ms:.4f} ms by {by} "
      f"({2 * macs * n / 1e9:.3f} GFLOP of products, {nbytes / 1e6:.1f} "
      f"MB)")
  return err, ms, plain, bound_ms, by


def p3_phase(device):
  """P3 against its plain version at the probe's points, then the probe's
  path with P3's count zeroed; returns P3's report row."""
  pos = probe_so3_relu.probe_positions(device).reshape(-1, 3)
  so3 = selfcheck.default_so3_params(device)
  err, ms, plain, bound_ms, by = p3_case("probe points", pos, so3,
                                         selfcheck.ALPHA)
  del pos
  probes.so3_preacts.launches = 0
  layers = probe_so3_relu.probe()
  launches = probes.so3_preacts.launches
  log(f"P3 probe path (probe_so3_relu.probe): launches {launches}, ReLU "
      f"flips per layer {[r['flips'] for r in layers]}")
  if launches != 1:
    raise SystemExit(f"P3 probe path: {launches} launches, expected 1")
  row = report_row("so3_preacts", "scripts/debug/probe_so3_relu.py:102",
                   err, ms, plain, bound_ms, by,
                   source="samplenerfro_torch/ops/csrc/march_bwd.cu")
  row["launches"] = launches
  return row


def capture_mlp_inputs(model, rays, jitter, mlp_kernel_name):
  """The (x, cond) each fused MLP call of one forward of `model` gets with
  --mlp_kernel=mlp_kernel_name, coarse then fine."""
  calls, original = [], mlp_kernel.fused_nerf_mlp

  def capture(mlp, x, cond, **kwargs):
    calls.append((x.contiguous(), cond.contiguous()))
    return original(mlp, x, cond, **kwargs)

  saved, model.mlp_kernel = model.mlp_kernel, mlp_kernel_name
  mlp_kernel.fused_nerf_mlp = capture
  try:
    with torch.no_grad():
      model(rays, jitter, randomized=False, mlp_dtype=torch.float32)
  finally:
    mlp_kernel.fused_nerf_mlp = original
    model.mlp_kernel = saved
  return calls


def mlp_bound(spec, rows, dtype, backward=False):
  """(bound ms, by, TFLOP): 2 operations a multiply-add of every layer at
  the true widths (3x for K5: recompute, dW, dh), at the fp32 or the bf16
  tensor-core peak; inputs and outputs (the MLP's weights, K5's
  cotangent and gradients) moved once."""
  macs = sum(k * n for k, n in mlp_kernel.layer_dims(spec))
  flops = (6 if backward else 2) * macs * rows
  per_row = 4 * (6 if spec.pe is not None else spec.feat + spec.cond)
  per_row += 4 * (spec.num_rgb + spec.num_sigma)
  weight_bytes = 4 if dtype == torch.float32 else 2
  nbytes = per_row * rows + (weight_bytes + (4 if backward else 0)) * macs
  peak = FP32_FLOPS if dtype == torch.float32 else BF16_TC_FLOPS
  bound_ms, by = bound(nbytes, flops, peak)
  return bound_ms, by, flops / 1e12


def fused_kernel_phases(model, chunk_rays, batch_rays, jitter, seed):
  """K4 and K5 against their plain versions on the card at the fine calls
  of the render's first chunk and of a training batch, timed beside their
  bounds and the nn.Linear stack (unfused)."""
  mlp = model.fine_mlp
  params = [p.detach() for p in mlp_kernel.mlp_params(mlp)]
  pe = (model.max_deg_point, model.deg_view)
  render_raw = capture_mlp_inputs(model, chunk_rays, jitter, "pallas_pe")[1]
  train_raw = capture_mlp_inputs(model, batch_rays, jitter, "pallas_pe")[1]
  encode = lambda raw: (math_ops.pe_cols(raw[0], pe[0]).contiguous(),
                        math_ops.pe_cols(raw[1], pe[1]).contiguous())
  rows = []
  for what, raw, dtype, fed in (
      ("fp32 render fine call", render_raw, torch.float32, True),
      ("fp32 pe render fine call", render_raw, torch.float32, False),
      ("bf16 train fine call", train_raw, torch.bfloat16, True)):
    x, c = encode(raw) if fed else raw
    spec = mlp_kernel.mlp_spec(mlp, None if fed else pe)
    got = torch.cat(mlp_kernel.mlp_fwd(spec, params, x, c, dtype), -1)
    torch.cuda.synchronize()
    want = torch.cat(mlp_kernel.fused_nerf_mlp_reference(spec, params, x, c,
                                                         dtype), -1)
    err = (got - want).abs()
    e_max, e_mean = float(err.max()), float(err.mean())
    del got, want, err
    ok = (e_max <= K4_FP32_ATOL if dtype == torch.float32 else
          e_max <= K4_BF16_MAX and e_mean <= K4_BF16_MEAN)
    log(f"  K4 {what} ({x.shape[0]} rows): max abs err {e_max:.3e}, mean "
        f"{e_mean:.3e}")
    if not (ok and np.isfinite(e_max)):
      raise SystemExit(f"K4 {what} disagrees with its plain version")
    ms = cuda_ms(lambda: mlp_kernel.mlp_fwd(spec, params, x, c, dtype))
    plain = cuda_ms(lambda: mlp_kernel.fused_nerf_mlp_reference(
        spec, params, x, c, dtype), 3)
    with torch.no_grad():
      if fed:
        unfused = cuda_ms(lambda: mlp(x, c, dtype=dtype))
      else:
        unfused = cuda_ms(lambda: mlp(*encode(raw), dtype=dtype))
    bound_ms, by, tflop = mlp_bound(spec, x.shape[0], dtype)
    log(f"  K4 mlp_fwd {what}: {ms:.4f} ms, plain {plain:.3f} ms, unfused "
        f"(nn.Linear) {unfused:.3f} ms, bound {bound_ms:.4f} ms by {by} "
        f"({tflop:.3f} TFLOP)")
    rows.append(report_row("mlp_fwd", MLP_KERNEL + ":219", e_max, ms, plain,
                           bound_ms, by, case=what, unfused_ms=unfused))

  x, c = encode(train_raw)
  spec = mlp_kernel.mlp_spec(mlp)
  gen = torch.Generator().manual_seed(seed + 2)
  n = x.shape[0]
  drgb = (1e-3 * torch.randn((n, 3), generator=gen)).to(x.device)
  dsigma = (1e-3 * torch.randn((n, 1), generator=gen)).to(x.device)
  for what, dtype in (("bf16 train fine call", torch.bfloat16),
                      ("fp32 train fine call", torch.float32)):
    args = (spec, params, x, c, drgb, dsigma, dtype)
    got = mlp_kernel.mlp_bwd(*args)
    torch.cuda.synchronize()
    want = mlp_kernel.fused_nerf_mlp_bwd_reference(*args)
    worst, err = 0.0, 0.0
    for g, w in zip(got, want):
      scale = float(w.abs().max())
      tol = (K5_BF16_SCALE * scale if dtype == torch.bfloat16 else
             K5_ATOL_SCALE * scale + K5_RTOL * w.abs())
      if scale > 0:
        worst = max(worst, float(((g - w).abs() / tol).max()))
      err = max(err, float((g - w).abs().max()))
      if not bool(torch.isfinite(g).all()):
        raise SystemExit(f"K5 {what}: non-finite gradient")
    log(f"  K5 {what}: every tensor within {worst:.3f} of its tolerance, "
        f"max abs err {err:.3e}")
    if worst > 1.0:
      raise SystemExit(f"K5 {what} disagrees with its plain version")
    again = mlp_kernel.mlp_bwd(*args)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
      raise SystemExit(f"K5 {what} is not deterministic: two runs differ")
    del got, want, again
    ms = cuda_ms(lambda: mlp_kernel.mlp_bwd(*args))
    plain = cuda_ms(lambda: mlp_kernel.fused_nerf_mlp_bwd_reference(*args),
                    3)

    def linear_backward():
      out = mlp(x, c, dtype=dtype)
      torch.autograd.grad(out, list(mlp.parameters()), (drgb, dsigma))

    unfused = cuda_ms(linear_backward)
    bound_ms, by, tflop = mlp_bound(spec, n, dtype, backward=True)
    log(f"  K5 mlp_bwd {what}: {ms:.4f} ms, plain {plain:.3f} ms, unfused "
        f"(nn.Linear forward + autograd to the weights) {unfused:.3f} ms, "
        f"bound {bound_ms:.4f} ms by {by} ({tflop:.3f} TFLOP); two runs "
        f"agree bit for bit")
    rows.append(report_row("mlp_bwd", MLP_KERNEL + ":246", err, ms, plain,
                           bound_ms, by, case=what, unfused_ms=unfused))
  return rows


def _grads_finite(model):
  ok = torch.ones((), dtype=torch.bool, device=next(model.parameters()).device)
  for p in model.parameters():
    if p.grad is not None:
      ok = ok & torch.isfinite(p.grad).all()
  return ok


def profile_train_step(model, args, host, device, step, generator):
  """Device time by kernel for one train step (torch.profiler)."""
  from torch.profiler import ProfilerActivity
  from torch.profiler import profile as tprofile
  optimizer, _, _ = step_lib.create_optimizer(model, args)
  batch = batch_to_device(host, annealed_alpha(step, args), device)
  torch.cuda.synchronize()
  with tprofile(activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
    step_lib.train_step(model, optimizer, batch, step, args, generator)
    torch.cuda.synchronize()
  log(f"profile of one {args.stage} train step:")
  log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15))


def _train_steps(model, args, host, device, first_step, n, generator):
  """n train steps on the repeated batch; returns (losses, steps/s after
  the first, all finite, [so3 gradient norm per step])."""
  optimizer, _, _ = step_lib.create_optimizer(model, args)
  losses, so3_norms, finite, t0 = [], [], None, None
  for i in range(n):
    step = first_step + i
    if i == 1:
      torch.cuda.synchronize()
      t0 = time.time()
    batch = batch_to_device(host, annealed_alpha(step, args), device)
    stats = step_lib.train_step(model, optimizer, batch, step, args,
                                generator)
    ok = _grads_finite(model) & torch.isfinite(stats.loss)
    finite = ok if finite is None else finite & ok
    losses.append(stats.loss)
    so3_norms.append(torch.sqrt(sum(
        (p.grad**2).sum() for p in model.path_sampler.so3_mlp.parameters()
        if p.grad is not None) + 0.0))
  torch.cuda.synchronize()
  rate = (n - 1) / (time.time() - t0)
  return ([float(x) for x in losses], rate, bool(finite),
          [float(x) for x in so3_norms])


def train_path_phase(args, scene, device, seed, host, profile=False):
  """Radiance then 'all' steps through train.step.train_step; returns the
  launch counts of K1, K2 and K3 during them and the 'all' model."""
  ndim, nmin, nmax, grid, bindings = scene
  gen = torch.Generator(device=device).manual_seed(seed)
  rad_args = argparse.Namespace(**{**vars(args), "stage": "radiance"})
  all_args = argparse.Namespace(**{**vars(args), "stage": "all"})
  rad = nerf.construct_nerf(rad_args, ndim, nmin, nmax, grid, bindings,
                            device=device, seed=seed)
  allm = nerf.construct_nerf(all_args, ndim, nmin, nmax, grid, bindings,
                             device=device, seed=seed)
  torch.cuda.synchronize()
  march_kernel.march_lean.launches = 0
  march_kernel.march_full.launches = 0
  eikonal_vjp.march_bwd.launches = 0
  losses, rate_r, ok_r, _ = _train_steps(rad, rad_args, host, device,
                                         TRAIN_FROM + 1, N_RADIANCE, gen)
  convert.load_into(allm, {k: v for k, v in rad.state_dict().items()
                           if k != "path_sampler.grid"})
  losses_a, rate_a, ok_a, so3 = _train_steps(
      allm, all_args, host, device, TRAIN_FROM + N_RADIANCE + 1, N_ALL, gen)
  counts = (march_kernel.march_lean.launches, march_kernel.march_full.launches,
            eikonal_vjp.march_bwd.launches)
  if profile:
    last = TRAIN_FROM + N_RADIANCE + N_ALL
    profile_train_step(rad, rad_args, host, device, last, gen)
    profile_train_step(allm, all_args, host, device, last, gen)
  del rad
  b = args.batch_size
  log(f"train path ({args.mlp_dtype} MLPs, batch {b}, env patch "
      f"{args.bg_patch_size}^2): radiance {N_RADIANCE} steps "
      f"{rate_r:.3f} steps/s {rate_r * b:.1f} rays/s; all {N_ALL} steps "
      f"{rate_a:.3f} steps/s {rate_a * b:.1f} rays/s (first step of each "
      f"untimed); launches K1 {counts[0]}, K2 {counts[1]}, K3 {counts[2]}")
  log(f"  radiance losses {losses}")
  log(f"  all losses {losses_a}, so3 grad norms {so3}")
  if not (ok_r and ok_a and np.all(np.isfinite(losses + losses_a))):
    raise SystemExit("train path: non-finite loss or gradient")
  if not np.mean(losses[-3:]) < np.mean(losses[:3]):
    raise SystemExit("train path: the radiance loss did not fall")
  if not all(np.isfinite(so3)) or min(so3) <= 0:
    raise SystemExit("train path: so3 gradients are zero or non-finite")
  if counts != (N_RADIANCE, N_ALL, N_ALL):
    raise SystemExit(f"train path: launches K1/K2/K3 {counts}, expected "
                     f"{(N_RADIANCE, N_ALL, N_ALL)}")
  return counts, allm, all_args, rate_r


def fused_train_phase(args, scene, device, seed, host, xla_rate,
                      profile=False):
  """Radiance steps with --mlp_kernel=pallas (bf16 MLPs, K4 forward, K5
  backward), then 'all' steps of a model built with the flag set, which
  keeps nn.Linear. Returns the K4 and K5 launches of the radiance steps
  and the radiance model."""
  ndim, nmin, nmax, grid, bindings = scene
  gen = torch.Generator(device=device).manual_seed(seed)
  fargs = argparse.Namespace(**{**vars(args), "stage": "radiance",
                                "mlp_kernel": "pallas"})
  rad = nerf.construct_nerf(fargs, ndim, nmin, nmax, grid, bindings,
                            device=device, seed=seed)
  torch.cuda.synchronize()
  mlp_kernel.mlp_fwd.launches = mlp_kernel.mlp_bwd.launches = 0
  losses, rate, ok, _ = _train_steps(rad, fargs, host, device,
                                     TRAIN_FROM + 1, N_RADIANCE, gen)
  counts = (mlp_kernel.mlp_fwd.launches, mlp_kernel.mlp_bwd.launches)
  b = args.batch_size
  log(f"fused train path (--mlp_kernel=pallas, {args.mlp_dtype} MLPs): "
      f"radiance {N_RADIANCE} steps {rate:.3f} steps/s {rate * b:.1f} "
      f"rays/s (nn.Linear: {xla_rate:.3f} steps/s); launches K4 "
      f"{counts[0]}, K5 {counts[1]}")
  log(f"  radiance losses {losses}")
  if not (ok and np.all(np.isfinite(losses))):
    raise SystemExit("fused train path: non-finite loss or gradient")
  if not np.mean(losses[-3:]) < np.mean(losses[:3]):
    raise SystemExit("fused train path: the radiance loss did not fall")
  if counts != (2 * N_RADIANCE, 2 * N_RADIANCE):
    raise SystemExit(f"fused train path: launches K4/K5 {counts}, expected "
                     f"{(2 * N_RADIANCE, 2 * N_RADIANCE)}")
  fall = argparse.Namespace(**{**vars(fargs), "stage": "all"})
  allm = nerf.construct_nerf(fall, ndim, nmin, nmax, grid, bindings,
                             device=device, seed=seed)
  convert.load_into(allm, {k: v for k, v in rad.state_dict().items()
                           if k != "path_sampler.grid"})
  torch.cuda.synchronize()
  mlp_kernel.mlp_fwd.launches = mlp_kernel.mlp_bwd.launches = 0
  losses_a, _, ok_a, _ = _train_steps(allm, fall, host, device,
                                      TRAIN_FROM + N_RADIANCE + 1,
                                      N_ALL_FUSED, gen)
  counts_a = (mlp_kernel.mlp_fwd.launches, mlp_kernel.mlp_bwd.launches)
  del allm
  log(f"  'all' with --mlp_kernel=pallas: {N_ALL_FUSED} steps, losses "
      f"{losses_a}, launches K4 {counts_a[0]}, K5 {counts_a[1]}")
  if not (ok_a and np.all(np.isfinite(losses_a))) or counts_a != (0, 0):
    raise SystemExit("fused train path: the 'all' stage must keep nn.Linear")
  if profile:
    profile_train_step(rad, fargs, host, device,
                       TRAIN_FROM + N_RADIANCE + N_ALL, gen)
  return counts, rad, fargs


def allstep_cross_check(model, args, host, device, seed):
  """One 'all' step's loss and so3 gradients on XCHECK_RAYS rays, fp32
  MLPs, not randomized: the card (K2, K3) against the CPU (plain)."""
  sub = dict(host)
  sub["rays"] = rays_lib.namedtuple_map(lambda r: r[:XCHECK_RAYS],
                                        host["rays"])
  sub["pixels"] = host["pixels"][:XCHECK_RAYS]
  xargs = argparse.Namespace(**{**vars(args), "randomized": False})
  model.mlp_dtype = torch.float32
  jitter = nerf.make_jitter(args.num_coarse_samples, args.num_path_samples,
                            torch.Generator().manual_seed(seed))
  alpha = annealed_alpha(TRAIN_FROM + N_RADIANCE + N_ALL, args)
  paths = []

  def record(module, inputs, out):
    paths.append((out[0].detach(), out[4].detach()))

  def run(dev):
    model.zero_grad(set_to_none=True)
    handle = model.path_sampler.register_forward_hook(record)
    try:
      total, _ = step_lib.loss_fn(model, batch_to_device(sub, alpha, dev),
                                  xargs, jitter.to(dev))
    finally:
      handle.remove()
    total.backward()
    grads = [p.grad.detach().cpu().clone()
             for p in model.path_sampler.so3_mlp.params()]
    return float(total.detach()), grads

  loss_gpu, g_gpu = run(device)
  so3 = [p.detach() for p in model.path_sampler.so3_mlp.params()]
  card_pre = [x.cpu() for x in probes.so3_preacts(
      paths[0][0].reshape(-1, 3).contiguous(), so3, alpha)]
  model.to("cpu")
  t0 = time.time()
  loss_cpu, g_cpu = run(torch.device("cpu"))
  secs = time.time() - t0
  rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
  worst = _worst_against(g_gpu, g_cpu, K3_ATOL_SCALE, K3_RTOL)
  log(f"all-step cpu cross-check: {XCHECK_RAYS} rays in {secs:.1f} s, loss "
      f"{loss_gpu:.8f} vs {loss_cpu:.8f} (rel {rel:.3e}, tolerance "
      f"{XCHECK_LOSS_RTOL}), so3 grads at {worst:.3f} of the K3 tolerance")
  layers, card_pre, flipped = cross_check_flips(
      paths[0][1].cpu(), card_pre, *paths[1], [p.cpu() for p in so3], alpha)
  n_flips = sum(r["flips"] for r in layers)
  log(f"  P3 on those rays, K3's sums at the card's path against the plain "
      f"version's at the CPU's, per layer (ReLU flips, min |pre-activation| "
      f"on the CPU) over the ray-steps active on both: "
      f"{[(r['flips'], r['min_abs']) for r in layers]}")
  if n_flips:
    saved = march_kernel.so3_refine_fn
    march_kernel.so3_refine_fn = probe_so3_relu.replaying_refine_fn(
        card_pre, flipped)
    try:
      _, g_replayed = run(torch.device("cpu"))
    finally:
      march_kernel.so3_refine_fn = saved
    log(f"  the CPU step again with those {n_flips} masks set as on the card:"
        f" so3 grads at "
        f"{_worst_against(g_gpu, g_replayed, K3_ATOL_SCALE, K3_RTOL):.3f} of "
        f"the K3 tolerance")
  if not (rel <= XCHECK_LOSS_RTOL and worst <= 1.0):
    raise SystemExit("all-step cpu cross-check failed")


def cross_check_flips(g_card, card_pre, pos_cpu, g_cpu, so3_cpu, alpha):
  """ReLU masks that the card's 'all' step (K3's sums, P3 at K2's path)
  and the CPU's (the plain version, called a step at a time on all rays as
  the plain march calls the head) set apart, per layer 1-3, at the
  ray-steps active on both. Returns (relu_flips' summary per layer, the
  card's [B, S, W] pre-activations, the [B, S, W] masks of the flips)."""
  cpu_pre = [w for _, w in probes.so3_preacts_by_step(pos_cpu, so3_cpu,
                                                       alpha)]
  card_pre = [c.reshape(w.shape) for c, w in zip(card_pre, cpu_pre)]
  active = (g_card.norm(dim=-1) > 1e-3) & (g_cpu.norm(dim=-1) > 1e-3)
  flipped = [((c > 0) != (w > 0)) & active[..., None]
             for c, w in zip(card_pre, cpu_pre)]
  return (probes.relu_flips(card_pre, cpu_pre, mask=active), card_pre,
          flipped)


def _to_cpu(tree):
  if isinstance(tree, torch.Tensor):
    return tree.cpu()
  if isinstance(tree, tuple):
    return tuple(_to_cpu(t) for t in tree)
  return tree


def _worst_against(got, want, atol_scale=K5_ATOL_SCALE, rtol=K5_RTOL):
  """Worst |got - want| over atol_scale * max|want| + rtol * |want| (the
  K5 fp32 tolerance unless given) across tensors."""
  worst = 0.0
  for g, w in zip(got, want):
    scale = float(w.abs().max())
    if scale > 0:
      worst = max(worst, float(((g - w).abs() / (
          atol_scale * scale + rtol * w.abs())).max()))
  return worst


def fused_cross_check(model, args, host, device, seed):
  """One fused radiance step's loss and coarse/fine MLP gradients on
  XCHECK_RAYS rays, fp32, not randomized: the card (K4, K5) against the
  CPU (their plain versions), the CPU step replaying the card's march
  paths and fine-sample placement.

  Replayed, because K1 and the plain march differ by ulps, and the coarse
  weights that place the fine samples by the order of the MLP sums; the
  fine samples' 2^9 encoding turns either into weight-gradient differences
  of its own. The comparison without the replay is printed for the fused
  and for the nn.Linear step, which stand alike. Returns K5's launches on
  the card."""
  sub = dict(host)
  sub["rays"] = rays_lib.namedtuple_map(lambda r: r[:XCHECK_RAYS],
                                        host["rays"])
  sub["pixels"] = host["pixels"][:XCHECK_RAYS]
  xargs = argparse.Namespace(**{**vars(args), "randomized": False})
  model.mlp_dtype = torch.float32
  jitter = nerf.make_jitter(args.num_coarse_samples, args.num_path_samples,
                            torch.Generator().manual_seed(seed))
  alpha = annealed_alpha(TRAIN_FROM + N_RADIANCE, args)
  mlps = (model.coarse_mlp, model.fine_mlp)
  sample_pdf = render_ops.sample_pdf

  def run(dev, kernel, record=None, replay=None):
    """loss and MLP gradients of one step; record appends the march and
    sample_pdf outputs, replay returns the recorded ones."""
    def pdf(*a, **k):
      if replay is not None:
        return replay[1]
      out = sample_pdf(*a, **k)
      if record is not None:
        record.append(_to_cpu(out))
      return out

    def march(module, inputs, out):
      if replay is not None:
        return replay[0]
      if record is not None:
        record.append(_to_cpu(out))
      return None

    model.mlp_kernel = kernel
    handle = model.path_sampler.register_forward_hook(march)
    render_ops.sample_pdf = pdf
    try:
      model.zero_grad(set_to_none=True)
      total, _ = step_lib.loss_fn(model, batch_to_device(sub, alpha, dev),
                                  xargs, jitter.to(dev))
      total.backward()
    finally:
      handle.remove()
      render_ops.sample_pdf = sample_pdf
    grads = [p.grad.detach().cpu().clone() for m in mlps
             for p in m.parameters()]
    return float(total.detach()), grads

  recorded = []
  mlp_kernel.mlp_bwd.launches = 0
  loss_gpu, g_gpu = run(device, "pallas", record=recorded)
  launches = mlp_kernel.mlp_bwd.launches
  _, g_gpu_linear = run(device, "xla")
  model.to("cpu")
  t0 = time.time()
  loss_cpu, g_cpu = run(torch.device("cpu"), "pallas", replay=recorded)
  secs = time.time() - t0
  rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
  worst = _worst_against(g_gpu, g_cpu)
  own_fused = _worst_against(g_gpu, run(torch.device("cpu"), "pallas")[1])
  own_linear = _worst_against(g_gpu_linear,
                              run(torch.device("cpu"), "xla")[1])
  model.mlp_kernel = args.mlp_kernel
  log(f"fused radiance-step cpu cross-check: {XCHECK_RAYS} rays in "
      f"{secs:.1f} s, loss {loss_gpu:.8f} vs {loss_cpu:.8f} (rel "
      f"{rel:.3e}, tolerance {XCHECK_LOSS_RTOL}), MLP grads at {worst:.3f} "
      f"of the K5 tolerance, K5 launches {launches}; each device placing "
      f"its own samples: fused step at {own_fused:.3f}, nn.Linear step at "
      f"{own_linear:.3f} of it")
  if not (rel <= XCHECK_LOSS_RTOL and worst <= 1.0 and launches == 2):
    raise SystemExit("fused radiance-step cpu cross-check failed")
  return launches


def main():
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--seed", type=int, default=0)
  p.add_argument("--profile", action="store_true",
                 help="print device time by kernel for one render chunk "
                 "and one train step of each stage")
  ns = p.parse_args()

  t_start = time.time()
  card = device_phase()
  device = torch.device("cuda")
  build_phase()
  probe_rows = probe_phase(device)
  selfcheck_phase()
  probe_rows.append(p3_phase(device))
  torch.cuda.empty_cache()
  args, model, scene = model_phase(device, ns.seed)
  view = camera_rays(RES)
  jitter = nerf.make_jitter(args.num_coarse_samples, args.num_path_samples,
                            torch.Generator().manual_seed(ns.seed), device)

  perm, _ = render_lib.tile_order(RES, RES, render_lib.TILE)
  first = rays_lib.namedtuple_map(
      lambda r: torch.from_numpy(
          r.reshape(-1, r.shape[-1])[perm[:args.chunk]].copy()).to(device),
      view)
  host = synthetic_batch(args, ns.seed)
  with torch.no_grad():
    k1 = kernel_phase(model, first, jitter)
  k2, k3 = so3_kernel_phases(model, host, ns.seed)
  batch_rays = batch_to_device(host, 1.0, device)["rays"]
  k4, k4_pe, k4_bf16, k5_bf16, k5_fp32 = fused_kernel_phases(
      model, first, batch_rays, jitter, ns.seed)
  del first, batch_rays
  torch.cuda.empty_cache()

  rgb, acc, k1["launches"], rate = main_path_phase(model, view, jitter,
                                                   args.chunk, device,
                                                   ns.profile)
  fused = fused_render_phase(model, view, jitter, args.chunk, device, rgb,
                             acc, rate, ns.profile)
  k4["launches"], k4_pe["launches"] = fused["pallas"], fused["pallas_pe"]
  counts, all_model, all_args, rate_r = train_path_phase(
      args, scene, device, ns.seed, host, ns.profile)
  k2["launches"], k3["launches"] = counts[1], counts[2]
  fcounts, fused_model, fused_args = fused_train_phase(
      args, scene, device, ns.seed, host, rate_r, ns.profile)
  k4_bf16["launches"], k5_bf16["launches"] = fcounts
  del scene
  torch.cuda.empty_cache()
  allstep_cross_check(all_model, all_args, host, device, ns.seed)
  del all_model
  k5_fp32["launches"] = fused_cross_check(fused_model, fused_args, host,
                                          device, ns.seed)
  del fused_model
  cross_check_phase(model, view, jitter, rgb, acc)

  report = probe_rows + [k1, k2, k3, k4, k4_pe, k4_bf16, k5_bf16, k5_fp32]
  log(f"total: {time.time() - t_start:.1f} s")
  log(f"card: {card}")
  print(json.dumps({"kernels": report}))
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
  sys.exit(main())
