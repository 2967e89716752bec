"""The forward marches (K1, K2) at every shape chip_smoke.py runs them,
K3 and P3 in each arm at the 'all' batch, and the radiance and 'all'
train steps, on inputs made from a seed.

    python -m samplenerfro_torch.debug.march_parity [--seed N] [--steps N]

For each march shape it prints a sha256 digest of the kernel's outputs
(and of a sample of its inputs), the max abs error against the plain
version, the call's time (CUDA events) and the kernel's device time
(torch.profiler); for K3 and P3, their outputs' digests. Then, for each
stage, one train step's device time and the steps/s of `--steps` steps
through train.step.train_step. With --fused, the radiance stage through
the fused MLP (--mlp_kernel=pallas, the ship's bf16 MLPs: K4/K5) instead:
a step's device ms at K = 1 and at K = 10 (make_train_step_multi; a
replay of the captured window traced), and the steps/s of each.

Its marches call only what the march wrappers have taken since the port
began (march_lean with a host jitter, march_full; march_bwd and
so3_preacts with their arm since the precision arms), so a copy of this
file in an earlier checkout of the port measures that checkout's kernels on
the same inputs: equal digests show the kernels bit for bit equal, and
runs in the order parent, change, change, parent in one call compare
their times. Its train steps take their batches as train/loop.step_batch
assembles them. chip_smoke.py builds its inputs here.
"""

import argparse
import hashlib
import re
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from samplenerfro_torch.data import rays as rays_lib
from samplenerfro_torch.models import nerf
from samplenerfro_torch.models.path_sampler import SO3_MAX_DEG
from samplenerfro_torch.ops import grid as grid_ops
from samplenerfro_torch.ops import march_kernel
from samplenerfro_torch.ops import mlp as mlp_ops
from samplenerfro_torch.train import selfcheck
from samplenerfro_torch.train import step as step_lib
from samplenerfro_torch.train.loop import annealed_alpha
from samplenerfro_torch.utils import config as config_lib
from samplenerfro_torch.utils import grid_io
from samplenerfro_torch.utils import render as render_lib

SHIP = "configs/tpu/ship_skydome-bkgd_no-partial-reflect_cycles"
GRID_N = 512
RES = 256
CAMERA_ANGLE_X = 0.6911112070083618  # the Blender scenes' field of view
SO3_STD = 1e-2     # so3 output init for the kernel phases (ship: 1e-5)
SO3_ALPHA = 0.7    # annealing progress for the kernel phases
TRAIN_FROM = 80000  # train steps continue a run at this step
# Scenes marched at their own grid and steps (configs/tpu/*.{yaml,gin}):
# (grid n, extent, near, far, coarse bins, path samples a bin, prefilter
# size, sigma). Glass: voxelize_uni384_bbox-3.5; ball:
# voxelize_uni256_bbox-2.0, the grid size of ball and dolphin.
GLASS = (384, 3.5, 0.2, 14.0, 64, 24, 5, 3.0)
BALL = (256, 2.0, 0.2, 12.0, 64, 24, 5, 3.0)


def log(msg):
  print(msg, flush=True)


def card_name():
  """The card's name and power limit, as nvidia-smi reports them."""
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, timeout=60, check=True)
  return smi.stdout.strip().splitlines()[0]


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


def device_us(event, self_only=False):
  names = (("self_device_time_total", "self_cuda_time_total") if self_only
           else ("device_time_total", "cuda_time_total"))
  for name in names:
    value = getattr(event, name, None)
    if value is not None:
      return value
  raise SystemExit("torch.profiler reports no device time")


def step_device_us(events):
  """The device time of a profile's `key_averages()`: its kernels' and
  copies' own time, as the profiler's table sums it (user annotations on
  the device's timeline, such as the optimizer's step, span kernels
  counted already)."""
  return sum(device_us(e, self_only=True) for e in events
             if e.device_type == DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False))


def kernel_launches(events, names):
  """{name: launches of the kernel `name` in a profile's
  `key_averages()`}: its device records, kernels captured in a CUDA graph
  included (each replay records its kernels), matched by the function's
  name."""
  pats = {n: re.compile(r"(^|[\s:])" + n + r"[(<]") for n in names}
  out = dict.fromkeys(names, 0)
  for e in events:
    if e.device_type != DeviceType.CUDA:
      continue
    for n, pat in pats.items():
      if pat.search(e.key):
        out[n] += e.count
  return out


def kernel_device_ms(fn, kernel, reps=5, tries=4):
  """(mean device ms of one launch of the kernel whose name holds
  `kernel`, its launches the profiler recorded a call): torch.profiler
  over `reps` calls of fn() after one warm-up. The profiler can drop a
  kernel's record; the mean is over the records it kept, and a window
  with none is profiled again, up to `tries` times."""
  from torch.profiler import ProfilerActivity
  from torch.profiler import profile as tprofile
  fn()
  torch.cuda.synchronize()
  for _ in range(tries):
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
      for _ in range(reps):
        fn()
      torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
      if kernel in e.key and device_us(e) > 0:
        total += device_us(e)
        count += e.count
    if count:
      return total / 1e3 / count, count / reps
  raise SystemExit(f"torch.profiler saw no {kernel} launch in {tries} "
                   f"windows of {reps} calls")


def ship_model(device, seed, grid_n=GRID_N, **overrides):
  """The ship-configured NerfModel on a prefiltered synthetic blob grid:
  (args, model, (ndim, nmin, nmax, grid, bindings))."""
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


def ship_inputs(args, seed, device):
  """The ship view (RES x RES), its jitter (on the host, from `seed`), the
  render's first chunk of rays on the card, a host training batch and its
  rays on the card: (view, jitter, first, host, batch_rays)."""
  view = camera_rays(RES)
  jitter = nerf.make_jitter(args.num_coarse_samples, args.num_path_samples,
                            torch.Generator().manual_seed(seed))
  perm, _ = render_lib.tile_order(RES, RES, render_lib.TILE)
  first = rays_lib.namedtuple_map(
      lambda r: torch.from_numpy(
          r.reshape(-1, r.shape[-1])[perm[:args.chunk]].copy()).to(device),
      view)
  host = synthetic_batch(args, seed)
  batch_rays = rays_lib.namedtuple_map(
      lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device),
      host["rays"])
  return view, jitter, first, host, batch_rays


def so3_params_for(seed, dev):
  """so3 weights drawn from `seed` at output std SO3_STD."""
  head = mlp_ops.So3MLP(6 * SO3_MAX_DEG, output_init_std=SO3_STD,
                        generator=torch.Generator().manual_seed(seed))
  return [p.detach().to(dev) for p in head.params()]


def scene_grid(device, seed, scene):
  """A scene's march on a synthetic blob grid prefiltered as its config
  says, its jitter from `seed`: (spec, grid with its gradient, near, step
  size, steps, jitter)."""
  n, extent, near, far, coarse, per, ksize, sigma = scene
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(n, extent, 0.33)
  spec = grid_ops.GridSpec(ndim, nmin, nmax)
  vals = grid_ops.gaussian_prefilter(torch.from_numpy(values).to(device),
                                     tuple(ndim), ksize, sigma)
  grid = torch.cat([vals, grid_ops.central_difference_grad(spec, vals)],
                   -1).contiguous()
  steps = coarse * per
  jitter = nerf.make_jitter(coarse, per, torch.Generator().manual_seed(seed))
  return spec, grid, near, (far - near) / (steps - 1), steps, jitter


def scene_rays(device, seed, count):
  """`count` rays of a RES x RES camera at radius 4 and a seeded pose."""
  rng = np.random.RandomState(seed + 3)
  view = camera_rays(RES, theta=rng.uniform(0, 2 * np.pi),
                     phi=rng.uniform(0.2, 0.8))
  idx = rng.choice(RES * RES, count, replace=False)
  flat = rays_lib.namedtuple_map(
      lambda r: torch.from_numpy(np.ascontiguousarray(
          r.reshape(-1, r.shape[-1])[idx])).to(device), view)
  return flat.origins, flat.viewdirs


def glass_inputs(device, seed):
  """Glass's march shape (configs/tpu/glass.{yaml,gin}: 64x24 = 1536 march
  steps, near 0.2, far 14, a 384^3 grid of extent 3.5 prefiltered 5/3) on
  a synthetic blob, and a 1024-ray batch of a camera at radius 4:
  (spec, grid, origins, directions, near, step_size, steps, jitter)."""
  spec, grid, near, step_size, steps, jitter = scene_grid(device, seed, GLASS)
  o, d = scene_rays(device, seed, 1024)
  return spec, grid, o, d, near, step_size, steps, jitter


def march_cases(device, seed, model, first, batch_rays, jitter):
  """Every shape at which chip_smoke.py runs K1 and K2, with its inputs:
  [(shape, "lean" or "so3", wrapper args)]. The ship chunk (the render's
  first 8192 rays), the radiance / 'all' batch (1024 rays), glass's
  shape (1024 rays, and an 8192-ray render chunk: the real scenes'
  validation render and radiance eval (K1), their `all` eval (K2)), ball's (a 256^3 grid, 1536 steps) at
  the radiance batch and a render chunk, and the self-check's (its 128^3
  blob, 512 rays of 768 steps; the 'all' arm's 256 rays of 192
  steps)."""
  ps = model.path_sampler
  ship = (ps.spec, ps.grid)
  cases = [
      ("ship chunk", "lean", (*ship, first.origins, first.viewdirs, ps.near,
                              ps.step_size, ps.num_samples, jitter)),
      ("radiance batch", "lean", (*ship, batch_rays.origins,
                                  batch_rays.viewdirs, ps.near, ps.step_size,
                                  ps.num_samples, jitter)),
      ("ship 'all' batch", "so3", (*ship, batch_rays.origins,
                                   batch_rays.viewdirs, ps.near, ps.step_size,
                                   ps.num_samples,
                                   so3_params_for(seed, device), SO3_ALPHA,
                                   SO3_MAX_DEG))]
  spec, grid, o, d, near, step_size, steps, gjit = glass_inputs(device, seed)
  cases += [("glass", "lean", (spec, grid, o, d, near, step_size, steps,
                               gjit)),
            ("glass", "so3", (spec, grid, o, d, near, step_size, steps,
                              so3_params_for(seed, device), SO3_ALPHA,
                              SO3_MAX_DEG))]
  o, d = scene_rays(device, seed, 8192)
  cases += [("glass chunk", "lean", (spec, grid, o, d, near, step_size,
                                     steps, gjit)),
            ("glass chunk", "so3", (spec, grid, o, d, near, step_size, steps,
                                    so3_params_for(seed, device), SO3_ALPHA,
                                    SO3_MAX_DEG))]
  spec, grid, near, step_size, steps, bjit = scene_grid(device, seed, BALL)
  for shape, count in (("ball batch", 1024), ("ball chunk", 8192)):
    o, d = scene_rays(device, seed, count)
    cases.append((shape, "lean", (spec, grid, o, d, near, step_size, steps,
                                  bjit)))
  n = 128
  spec = grid_ops.GridSpec([n] * 3, [-1.5] * 3, [1.5] * 3)
  grid = torch.from_numpy(selfcheck._blob_grid3d(spec, n)).to(device)
  o, d = (torch.from_numpy(a).to(device)
          for a in selfcheck._center_tile_rays(512))
  h = (selfcheck.FAR - selfcheck.NEAR) / (768 - 1)
  rng = np.random.RandomState(11)
  sjit = torch.from_numpy(np.arange(0, 768, 12) + rng.randint(0, 12, 64))
  so3 = selfcheck.default_so3_params(device)
  cases += [("self-check", "lean", (spec, grid, o, d, selfcheck.NEAR, h, 768,
                                    sjit)),
            ("self-check", "so3", (spec, grid, o, d, selfcheck.NEAR, h, 768,
                                   so3, selfcheck.ALPHA, SO3_MAX_DEG)),
            ("self-check 'all' arm", "so3", (spec, grid, o[:256], d[:256],
                                             selfcheck.NEAR, h, 192, so3,
                                             selfcheck.ALPHA, SO3_MAX_DEG))]
  return cases


def march_call(kind):
  """(wrapper, plain version, kernel name) of a march kind: "lean" (K1),
  "so3" (K2) or "plain" (K2 with the head off; chip_smoke.py's cases, not
  march_cases', so that this file still runs in a checkout without it)."""
  if kind == "lean":
    return (march_kernel.march_lean, march_kernel.march_lean_reference,
            "march_lean_kernel")
  if kind == "plain":
    return (march_kernel.march_full_plain,
            march_kernel.march_full_plain_reference,
            "march_full_plain_kernel")
  return (march_kernel.march_full, march_kernel.march_full_reference,
          "march_so3_kernel")


def digest(*tensors):
  """The first 16 hex digits of the sha256 of the tensors' bytes."""
  h = hashlib.sha256()
  for t in tensors:
    h.update(t.detach().contiguous().cpu().numpy().tobytes())
  return h.hexdigest()[:16]


def march_report(shape, kind, args):
  """One march case: the digest of the wrapper's outputs and of a sample
  of its inputs, the max abs error per output (K1) or channel (K2)
  against the plain version (`err`), the largest |arclength| in the
  plain version (`dist_max`), the call's ms and the kernel's device ms."""
  fn, ref, kernel = march_call(kind)
  with torch.no_grad():
    got = fn(*args)
    torch.cuda.synchronize()
    want = ref(*args)
    if kind == "lean":
      err = [max((a - b).abs().reshape(-1, a.shape[-1] if a.dim() == 3
                                       else 1).amax(dim=0).tolist())
             for a, b in zip(got, want)]
      outs, dist_max = got, float(want[2].abs().max())
    else:
      err = (got - want).abs().reshape(-1, 11).amax(dim=0).tolist()
      outs, dist_max = (got,), float(want[..., 6].abs().max())
    report = {"digest": digest(*outs),
              "inputs": digest(args[1][::997], args[2], args[3]),
              "err": err, "dist_max": dist_max}
    del got, want, outs
    report["call_ms"] = cuda_ms(lambda: fn(*args))
    report["kernel_ms"], report["recorded"] = kernel_device_ms(
        lambda: fn(*args), kernel)
  log(f"  march {kind} {shape} ({args[2].shape[0]} rays x {args[6]} steps): "
      f"output digest {report['digest']}, inputs {report['inputs']}; max "
      f"abs err per {'output' if kind == 'lean' else 'channel'} {err}")
  log(f"  march {kind} {shape}: call {report['call_ms']:.4f} ms, kernel "
      f"{report['kernel_ms']:.4f} ms a launch (profiler: "
      f"{report['recorded']:g} launches a call recorded)")
  return report


def sweep_digests(path_sampler, batch_rays, seed):
  """K3 in each arm and P3 in each arm at the ship 'all' batch, on the
  plain march's trajectory and a seeded cotangent: the digest of each
  output (K3's five tensors and its so3 gradients; P3's pre-activations at
  the trajectory's active ray-steps). K3 and P3 in fp32 must equal an
  earlier checkout's; their bf16 arm is printed beside them."""
  # Imported here, as step_rates' imports, for copies of this file in
  # earlier checkouts.
  from samplenerfro_torch.ops import eikonal_vjp
  from samplenerfro_torch.utils import probes
  ps = path_sampler
  so3 = so3_params_for(seed, ps.grid.device)
  o, d = batch_rays.origins, batch_rays.viewdirs
  with torch.no_grad():
    traj = march_kernel.march_full_reference(
        ps.spec, ps.grid, o, d, ps.near, ps.step_size, ps.num_samples, so3,
        SO3_ALPHA, SO3_MAX_DEG)
  dtraj = torch.randn(traj.shape, generator=torch.Generator().manual_seed(
      seed + 1)).to(traj.device)
  pts = traj[..., 0:3][traj[..., 8:11].norm(dim=-1) > 1e-3].contiguous()
  out = {}
  for arm in ("float32", "bfloat16"):
    cfg = eikonal_vjp.MarchConfig(ps.spec, ps.near, ps.step_size,
                                  ps.num_samples, SO3_MAX_DEG, "highest", arm)
    r = eikonal_vjp.march_bwd(cfg, ps.grid, o, d, so3, SO3_ALPHA, traj,
                              dtraj)
    pre = probes.so3_preacts(pts, so3, SO3_ALPHA, SO3_MAX_DEG, arm)
    torch.cuda.synchronize()
    out[arm] = (digest(r[0], r[1], r[2], *r[3]), digest(*pre))
    log(f"  K3 [{arm}] digest {out[arm][0]}, P3 [{arm}] digest "
        f"{out[arm][1]} ({pts.shape[0]} active ray-steps)")
  return out


def step_rates(args, scene, device, seed, host, steps):
  """For each stage, one train step's device time (torch.profiler) after
  two untimed steps, then the steps/s of `steps` more (and of each
  quarter of them), on the repeated host batch. Each step's jitter comes
  from torch's default host generator, and its batch goes to the card
  with it, as loop.step_batch assembles it."""
  # Imported here, so that the marches run from a copy of this file in a
  # checkout that predates them.
  from samplenerfro_torch.data import prefetch
  from samplenerfro_torch.train.loop import step_batch
  from torch.profiler import ProfilerActivity
  from torch.profiler import profile as tprofile
  ndim, nmin, nmax, grid, bindings = scene
  gen = torch.Generator(device=device).manual_seed(seed)
  for stage in ("radiance", "all"):
    sargs = argparse.Namespace(**{**vars(args), "stage": stage})
    model = nerf.construct_nerf(sargs, ndim, nmin, nmax, grid, bindings,
                                device=device, seed=seed)
    optimizer, _, _ = step_lib.create_optimizer(model, sargs)

    def run(first, n):
      for step in range(first, first + n):
        jitter = nerf.make_jitter(sargs.num_coarse_samples,
                                  sargs.num_path_samples)
        batch = prefetch.to_device(step_batch(
            host, annealed_alpha(step, sargs),
            step_lib.learning_rates(optimizer, step - 1), jitter, sargs),
            device)
        step_lib.train_step(model, optimizer, batch, sargs, gen)

    run(TRAIN_FROM + 1, 2)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
      run(TRAIN_FROM + 3, 1)
      torch.cuda.synchronize()
    windows, first = [], TRAIN_FROM + 4
    for n in (steps // 4,) * 3 + (steps - 3 * (steps // 4),):
      t0 = time.time()
      run(first, n)
      torch.cuda.synchronize()
      windows.append((n, time.time() - t0))
      first += n
    rate = steps / sum(t for _, t in windows)
    step_ms = step_device_us(prof.key_averages()) / 1e3
    log(f"{stage} step: {step_ms:.3f} ms of device time, "
        f"{rate:.3f} steps/s (wall, {steps} steps; by quarter "
        f"{[round(n / t, 3) for n, t in windows]})")
    del model, optimizer
    torch.cuda.empty_cache()


def fused_step_ms(args, scene, device, seed, host, k, windows=3):
  """The radiance stage with --mlp_kernel=pallas at K = k steps a dispatch
  (train.step.make_train_step_multi: the first window eager, the second
  captured, then replays): (device ms a step of the last window, traced
  by torch.profiler, and steps/s of `windows` windows after the first
  two), on the repeated host batch with jitters from `seed`."""
  from samplenerfro_torch.data import prefetch
  from samplenerfro_torch.train import loop
  from torch.profiler import ProfilerActivity
  from torch.profiler import profile as tprofile
  ndim, nmin, nmax, grid, bindings = scene
  sargs = argparse.Namespace(**{**vars(args), "stage": "radiance",
                                "mlp_kernel": "pallas",
                                "steps_per_dispatch": k})
  model = nerf.construct_nerf(sargs, ndim, nmin, nmax, grid, bindings,
                              device=device, seed=seed)
  optimizer, _, _ = step_lib.create_optimizer(model, sargs)
  run = step_lib.make_train_step_multi(
      model, optimizer, sargs, k,
      torch.Generator(device=device).manual_seed(seed))
  jit = torch.Generator().manual_seed(seed + 1)
  dataset = iter(lambda: host, None)
  first = TRAIN_FROM + 1
  batches = []
  for _ in range(windows + 3):
    batches.append(prefetch.to_device(loop.host_window(
        dataset, first, first + k - 1, sargs, optimizer, jit), device))
    first += k
  run(batches[0])
  run(batches[1])
  torch.cuda.synchronize()
  t0 = time.time()
  for b in batches[2:2 + windows]:
    run(b)
  torch.cuda.synchronize()
  rate = windows * k / (time.time() - t0)
  with tprofile(activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
    run(batches[-1])
    torch.cuda.synchronize()
  step_ms = step_device_us(prof.key_averages()) / 1e3 / k
  del model, optimizer, run, batches
  torch.cuda.empty_cache()
  return step_ms, rate


def main():
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--seed", type=int, default=0)
  p.add_argument("--steps", type=int, default=200,
                 help="train steps timed per stage")
  p.add_argument("--fused", action="store_true",
                 help="time the fused-MLP radiance step at K = 1 and 10 "
                 "instead")
  ns = p.parse_args()
  if not torch.cuda.is_available():
    raise SystemExit("march_parity: no CUDA device")
  t_start = time.time()
  card = card_name()
  device = torch.device("cuda")
  if ns.fused:
    args, model, scene = ship_model(device, ns.seed)
    host = ship_inputs(args, ns.seed, device)[3]
    del model
    for k in (1, 10):
      step_ms, rate = fused_step_ms(args, scene, device, ns.seed, host, k)
      log(f"fused radiance step (--mlp_kernel=pallas, {args.mlp_dtype} "
          f"MLPs), K = {k}: {step_ms:.3f} ms of device time a step, "
          f"{rate:.3f} steps/s")
    log(f"total: {time.time() - t_start:.1f} s")
    log(f"card: {card}")
    return
  args, model, scene = ship_model(device, ns.seed, march_bwd_dtype="float32",
                                  march_interp="highest")
  _, jitter, first, host, batch_rays = ship_inputs(args, ns.seed, device)
  for case in march_cases(device, ns.seed, model, first, batch_rays, jitter):
    march_report(*case)
  sweep_digests(model.path_sampler, batch_rays, ns.seed)
  del model, first, batch_rays
  torch.cuda.empty_cache()
  step_rates(args, scene, device, ns.seed, host, ns.steps)
  log(f"total: {time.time() - t_start:.1f} s")
  log(f"card: {card}")


if __name__ == "__main__":
  main()
