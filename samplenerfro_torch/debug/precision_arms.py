"""The shipped configs' reduced-precision arms on the card, each kernel
against its plain version of the same arm (ops/precision.py).

    python -m samplenerfro_torch.debug.precision_arms [--seed N]

At the ship configuration's shapes (its 512^3 blob grid, 768 march steps;
the radiance and 'all' batch of 1024 rays, the render chunk of 8192):
K1 and K2 with the head off at march_interp "default" and "high" against
their plain versions (the same interpolation's rounding points, the same
order: chip_smoke.py holds them at K1_ATOL); K2 with its bf16 head at
"default" and "highest", teacher-forced (teacher_forced: one plain step
from each of the kernel's own states, held at K2_ATOL) and free-running,
and its pre-activations against P3's bf16 arm, which must be equal bit for
bit (k2_preacts_case);
K3's bf16 arm on the plain march's trajectory against
ops/eikonal_vjp.march_bwd_passes_reference in the same arm, with the ReLU
masks that P3's bf16 arm and the plain version set apart replayed in the
plain version (k3_bf16_case), per tensor at K3_BF16_FORM, and bit for bit
across two runs. chip_smoke.py's shipped-arms phase runs these; alone,
this module prints them with the call and kernel times.

Why the free-running K2 is not held at K2_ATOL: a bf16 interpolation
rounds the (x, y) weights, whose last fp32 bits follow the position's. K2
sums its head in the tensor core and the plain version through cuBLAS;
the ulps that leaves in a direction move the next positions by ulps, which
at a 512^3 grid move a fraction by ~3e-5 of a cell, and that rounds a
weight to the next bf16 value (2^-9 of it) a few times in a hundred. So
the two marches part by a bf16 rounding of n and grad n, ~1e-3, and carry
it. The teacher-forced check holds every step's arithmetic at its own
inputs.
"""

import argparse
import time

import torch

from samplenerfro_torch.debug import march_parity
from samplenerfro_torch.models.path_sampler import SO3_MAX_DEG
from samplenerfro_torch.ops import eikonal as eik_ops
from samplenerfro_torch.ops import eikonal_vjp
from samplenerfro_torch.ops import march_kernel
from samplenerfro_torch.utils import probes

TEACHER_RAYS = 1024  # rays a teacher-forced step takes at a time
# K3's bf16 arm against its plain version, per tensor: |got - want| <=
# K3_BF16_FORM * max|want|, K5's bf16 form.
K3_BF16_FORM = 2e-3
K3_NAMES = ["origins", "directions", "alpha"] + [
    f"so3 {n}.{k}" for n in ("Dense_0", "Dense_1", "Dense_2", "Dense_3",
                             "Dense_out") for k in ("weight", "bias")]


def log(msg):
  print(msg, flush=True)


def sync(t):
  """Wait for the card where t lies on it (a kernel's faults show here)."""
  if t.is_cuda:
    torch.cuda.synchronize()


def timed(fn):
  """(fn(), its milliseconds): CUDA events around the call on the card,
  the host clock on the CPU."""
  if not torch.cuda.is_available():
    t0 = time.time()
    return fn(), 1e3 * (time.time() - t0)
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  out = fn()
  end.record()
  torch.cuda.synchronize()
  return out, start.elapsed_time(end)


def max_err(got, want):
  """Largest |got - want| over tensors of the same shapes."""
  return max(float((a - b).abs().max()) for a, b in zip(got, want))


def k1_arm(spec, grid, o, d, near, step_size, steps, jitter, interp):
  """K1 at `interp` and its plain version: (max abs error, outputs, the
  plain version's ms)."""
  args = (spec, grid, o, d, near, step_size, steps, jitter, interp)
  with torch.no_grad():
    got = march_kernel.march_lean(*args)
    sync(got[0])
    want, plain_ms = timed(lambda: march_kernel.march_lean_reference(*args))
  return max_err(got, want), got, plain_ms


def head_off_arm(spec, grid, o, d, near, step_size, steps, interp):
  """K2 with the head off at `interp` and its plain version: (max abs
  error, trajectory, the plain version's ms)."""
  args = (spec, grid, o, d, near, step_size, steps, interp)
  with torch.no_grad():
    got = march_kernel.march_full_plain(*args)
    sync(got)
    want, plain_ms = timed(
        lambda: march_kernel.march_full_plain_reference(*args))
  return max_err([got], [want]), got, plain_ms


def teacher_forced(spec, grid, traj, step_size, so3, alpha, max_deg, interp,
                   bwd_dtype):
  """One plain step from each of a K2 trajectory's states [B, S, 11] in
  the same arm: {"n, grad n": max |plain interpolation at p_s - the
  kernel's (n_s, g_s)|, "pos", "dir", "dist": max |plain step from state s
  with the kernel's (n_s, g_s) - the kernel's state s + 1|}."""
  out = {"n, grad n": 0.0, "pos": 0.0, "dir": 0.0, "dist": 0.0}
  h = torch.full((), step_size, dtype=torch.float32, device=traj.device)
  refine = march_kernel.so3_refine_fn(so3, alpha, max_deg, dtype=bwd_dtype)
  with torch.no_grad():
    for i in range(0, traj.shape[0], TEACHER_RAYS):
      p, d, t, n, g = march_kernel.split_trajectory(
          traj[i:i + TEACHER_RAYS])
      n_p, g_p = eik_ops.grid_n_and_grad(spec, grid, p, interp)
      nxt = eik_ops.euler_step(p[:, :-1], d[:, :-1], t[:, :-1], n[:, :-1],
                               g[:, :-1], h, step_size, refine)
      for k, err in (("n, grad n", max_err([n_p, g_p], [n, g])),
                     ("pos", max_err([nxt[0]], [p[:, 1:]])),
                     ("dir", max_err([nxt[1]], [d[:, 1:]])),
                     ("dist", max_err([nxt[2]], [t[:, 1:]]))):
        out[k] = max(out[k], err)
  return out


def k2_arm(spec, grid, o, d, near, step_size, steps, so3, alpha, interp,
           bwd_dtype):
  """K2 in an arm: (teacher_forced's errors, the free-running plain
  version's max abs error per channel, the trajectory, the plain version's
  trajectory and ms)."""
  args = (spec, grid, o, d, near, step_size, steps, so3, alpha, SO3_MAX_DEG,
          interp, bwd_dtype)
  with torch.no_grad():
    traj = march_kernel.march_full(*args)
    sync(traj)
    want, plain_ms = timed(lambda: march_kernel.march_full_reference(*args))
    free = (traj - want).abs().reshape(-1, 11).amax(dim=0).tolist()
  forced = teacher_forced(spec, grid, traj, step_size, so3, alpha,
                          SO3_MAX_DEG, interp, bwd_dtype)
  return forced, free, traj, want, plain_ms


def k2_preacts_case(spec, grid, o, d, near, step_size, steps, so3, alpha,
                    interp, max_deg=SO3_MAX_DEG, traj=None):
  """K2's bf16 head against P3's bf16 arm (K3's forward): the
  pre-activations of hidden layers 1-3 as K2 summed them
  (march_kernel.march_full_preacts, its trial build) at every active
  ray-step of its own trajectory, against P3's at the same points. Returns
  ({"active": active ray-steps, "flips": ReLU masks that differ per layer,
  "differ": elements not equal bit for bit per layer}, whether the trial
  build's trajectory is `traj` bit for bit, None without traj)."""
  flips, differ = [0, 0, 0], [0, 0, 0]
  with torch.no_grad():
    got, pre = march_kernel.march_full_preacts(spec, grid, o, d, near,
                                               step_size, steps, so3, alpha,
                                               max_deg, interp)
    active = got[..., 8:11].norm(dim=-1) > 1e-3
    pts = got[..., 0:3][active].contiguous()
    if pts.shape[0]:
      p3 = probes.so3_preacts(pts, so3, alpha, max_deg, "bfloat16")
      for layer in range(3):
        a, b = pre[layer][active], p3[layer]
        flips[layer] = int(((a > 0) != (b > 0)).sum())
        differ[layer] = int((a != b).sum())  # a NaN: a step not run
      del p3
    same = None if traj is None else torch.equal(got, traj)
    out = {"active": pts.shape[0], "flips": flips, "differ": differ}
    del got, pre, pts
  return out, same


def k3_flat(r):
  """K3's (origins_bar, directions_bar, alpha_bar, [so3 grads]) flat."""
  return [r[0], r[1], r[2]] + list(r[3])


def k3_bf16_case(cfg, grid, o, d, so3, alpha, traj, dtraj):
  """K3's bf16 arm on traj against march_bwd_passes_reference in the same
  arm, the ReLU masks of layers 1-3 that P3's bf16 arm (K3's own forward)
  and the plain version set apart taken from P3 in the plain version.
  Returns ({tensor: (max abs err, its share of the form)}, the flips per
  layer, whether two runs agree bit for bit, the kernel's outputs, the
  plain version's ms)."""
  replay, flips = None, [0, 0, 0]
  with torch.no_grad():
    swept = traj[..., 8:11].norm(dim=-1) > 1e-3
    pts = traj[..., 0:3][swept].contiguous()
    if pts.shape[0]:  # no swept point, no mask to replay
      k3_pre = probes.so3_preacts(pts, so3, alpha, cfg.max_deg, "bfloat16")
      plain_pre = probes.so3_preacts_reference(pts, so3, alpha, cfg.max_deg,
                                               "bfloat16")
      flipped = [(a > 0) != (b > 0) for a, b in zip(k3_pre, plain_pre)]
      flips = [int(f.sum()) for f in flipped]
      replay = (k3_pre, flipped)
      del plain_pre
    del pts
  got = eikonal_vjp.march_bwd(cfg, grid, o, d, so3, alpha, traj, dtraj)
  sync(got[0])
  want, plain_ms = timed(lambda: eikonal_vjp.march_bwd_passes_reference(
      cfg, grid, o, d, so3, alpha, traj, dtraj, replay=replay))
  errs = {}
  for name, a, b in zip(K3_NAMES, k3_flat(got), k3_flat(want)):
    err, scale = float((a - b).abs().max()), float(b.abs().max())
    errs[name] = (err, err / (K3_BF16_FORM * scale) if scale > 0 else
                  (0.0 if err == 0 else float("inf")))
  del want
  again = eikonal_vjp.march_bwd(cfg, grid, o, d, so3, alpha, traj, dtraj)
  same = all(torch.equal(a, b) for a, b in zip(k3_flat(got), k3_flat(again)))
  return errs, flips, same, got, plain_ms


# The edges of the bf16 arm's partition (ops/eikonal_vjp.k3_tile_ranges)
# that k3_edge_trajectory makes.
K3_EDGES = ("none", "all", "over", "under", "few")


def k3_edge_trajectory(traj, case, num_blocks,
                       rows=eikonal_vjp.K3_BF16_ROWS):
  """traj [B, S, 11] with its active ray-steps (|g| > 1e-3) set at an edge
  of K3's bf16 partition: "none", no active ray-step (g zeroed); "all",
  every one (g = 1e-2 on each axis where it was not active); "over" and
  "under", the first active ones in ray-major order kept, one over and
  one under a multiple of the tile's rows (g zeroed at the rest); "few",
  fewer tiles than num_blocks. K3 is a function of traj, so its plain
  version is held on the same edited trajectory."""
  out = traj.clone()
  g = out[..., 8:11]
  active = g.norm(dim=-1) > 1e-3
  if case == "none":
    g.zero_()
    return out
  if case == "all":
    g[~active] = 1e-2
    return out
  n = int(active.sum())
  keep = {"over": (n - 1) // rows * rows + 1,
          "under": n // rows * rows - 1,
          "few": min(n, (num_blocks // 2) * rows) - 5}[case]
  if not 0 < keep <= n:
    raise ValueError(f"k3_edge_trajectory: {n} active ray-steps cannot "
                     f"give the edge {case!r}")
  rank = active.reshape(-1).cumsum(0).reshape(active.shape)
  g[active & (rank > keep)] = 0.0
  return out


K3_KERNELS = ("k3_pieces", "k3_jacobians", "k3_sweep", "k3_params",
              "k3_reduce")


def k3_split(fn, tries=4):
  """Device ms of each of K3's five kernels in one fn() (torch.profiler).
  The profiler can drop a kernel's record: a call that misses one is
  profiled again, up to `tries` times; the last call's records are
  returned as they are. The caching allocator's free blocks are released
  first: with the plain versions' tensors of the ship shapes cached, the
  profiler recorded none of K3's kernels (chip_smoke.py, phase 16)."""
  from torch.profiler import ProfilerActivity
  from torch.profiler import profile as tprofile
  fn()
  torch.cuda.synchronize()
  torch.cuda.empty_cache()
  for _ in range(tries):
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
      fn()
      torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
      for k in K3_KERNELS:
        if k in e.key and march_parity.device_us(e) > 0:
          out[k] = out.get(k, 0.0) + march_parity.device_us(e) / 1e3
    if len(out) == len(K3_KERNELS):
      break
  return out


def main():
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--seed", type=int, default=0)
  ns = p.parse_args()
  if not torch.cuda.is_available():
    raise SystemExit("precision_arms: no CUDA device")
  t0 = time.time()
  card = march_parity.card_name()
  device = torch.device("cuda")
  args, model, _ = march_parity.ship_model(device, ns.seed,
                                           march_bwd_dtype="float32",
                                           march_interp="highest")
  _, jitter, first, _, batch = march_parity.ship_inputs(args, ns.seed,
                                                        device)
  ps = model.path_sampler
  geo = (ps.spec, ps.grid)
  for name, rays in (("chunk", first), ("batch", batch)):
    for interp in ("default", "high"):
      err, _, _ = k1_arm(*geo, rays.origins, rays.viewdirs, ps.near,
                         ps.step_size, ps.num_samples, jitter, interp)
      err2, _, _ = head_off_arm(*geo, rays.origins, rays.viewdirs, ps.near,
                                ps.step_size, ps.num_samples, interp)
      log(f"{name} {interp}: K1 err {err:.3e}, head off err {err2:.3e}")
  so3 = march_parity.so3_params_for(ns.seed, device)
  alpha = march_parity.SO3_ALPHA
  o, d = batch.origins, batch.viewdirs
  for interp in ("default", "highest"):
    forced, free, _, _, _ = k2_arm(*geo, o, d, ps.near, ps.step_size,
                                   ps.num_samples, so3, alpha, interp,
                                   "bfloat16")
    log(f"K2 {interp} bf16 head: teacher-forced {forced}, free-running "
        f"per channel {free}")
    pre, _ = k2_preacts_case(*geo, o, d, ps.near, ps.step_size,
                             ps.num_samples, so3, alpha, interp)
    log(f"K2 {interp} bf16 head against P3 bf16: {pre}")
  cfg = eikonal_vjp.MarchConfig(ps.spec, ps.near, ps.step_size,
                                ps.num_samples, SO3_MAX_DEG, "default",
                                "bfloat16")
  with torch.no_grad():
    traj = march_kernel.march_full_reference(
        *geo, o, d, ps.near, ps.step_size, ps.num_samples, so3, alpha,
        SO3_MAX_DEG, "default", "bfloat16")
  dtraj = torch.randn(traj.shape, generator=torch.Generator().manual_seed(
      ns.seed + 1)).to(device)
  errs, flips, same, _, _ = k3_bf16_case(cfg, ps.grid, o, d, so3, alpha,
                                         traj, dtraj)
  log(f"K3 bf16: flips {flips}, bit for bit {same}")
  for k, (e, share) in errs.items():
    log(f"  {k}: {e:.3e} ({share:.3f} of the form)")
  for arm in ("float32", "bfloat16"):
    c = cfg._replace(bwd_dtype=arm)
    fn = lambda: eikonal_vjp.march_bwd(c, ps.grid, o, d, so3, alpha, traj,
                                       dtraj)
    log(f"K3 {arm}: {march_parity.cuda_ms(fn):.4f} ms, split {k3_split(fn)}")
  log(f"total {time.time() - t0:.1f} s; card: {card}")


if __name__ == "__main__":
  main()
