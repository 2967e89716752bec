"""A training cell: the port's train loop, closed, K steps a dispatch.

Set-up writes the seeded capture under TMPDIR, makes the grid and the
weights on the card, and builds what train/loop._train builds: the model
(models/nerf.construct_nerf), Adam (train/step.create_optimizer),
data/datasets.TrainBatches, train/loop.host_window's windows through
data/prefetch.device_prefetch, and make_train_step_multi's K-step run.
It drives that one object through its first steps: step 1 and steps 2-3
as windows of their own (shorter than K, so run step by step, bit for bit
a replay's), the rest of the K grid, the eager full window and the
window that captures the CUDA graph. The timed window then replays
windows of K until --seconds have passed, at most two windows ahead of
the card, and ends at a synchronised window boundary.

`correct` holds two stretches of that object against the plain reference
(portbench/reference), which follows them from the same capture, grid
values, jitter seed and noise seed:
  - the start, from the benchmark's weights: each of the first three
    steps' loss, the first gradient as Adam got it (its first moment over
    1 - b1), and each leaf's change after step 3;
  - the timed window's first replay, from the leaves and Adam moments the
    program held before it (copied on the card inside the window): each
    of its K steps' loss, each leaf's change and its moments' changes over
    the K steps, and Adam's counts after it.
Gaps are taken by the worst leaf and by the median leaf.
"""

import collections
import os
import shutil
import statistics
import tempfile
import time

import numpy as np
import torch

from portbench import harness
from portbench import trace as trace_lib
from portbench.counts import nerf as counts
from portbench.reference import model as ref_model
from portbench.reference import scene as ref_scene
from portbench.traffic import capture
from portbench.traffic import weights as weights_lib

# The kernels each stage's path launches (samplenerfro_torch/ops/csrc).
KERNELS = {"radiance": ["march_lean"], "all": ["march_so3", "march_bwd"]}
IN_FLIGHT = 2


def seeds(seed):
  """(batch RandomState seed, noise seed, jitter seed) of a run."""
  return (seed * 2 + 1) % 2**32, seed + 101, seed + 202


def sync(device):
  if torch.device(device).type == "cuda":
    torch.cuda.synchronize(device)


def port_args(cfg, stage, data_dir):
  """The port's flag namespace, gin Config and bindings of `cfg`."""
  from samplenerfro_torch.utils import config as config_lib
  gin = [f"{k} = {v!r}" for k, v in cfg["gin"].items()]
  args, gcfg, bindings = config_lib.load_args(None, [], gin, stage=stage,
                                              **cfg["flags"])
  # The port picks the boundary cut's box, and nothing else, by the
  # config's path.
  args.config = cfg["port_config_name"]
  args.data_dir = data_dir
  return args, gcfg, bindings


def build_model(cfg, args, gcfg, bindings, device, seed, raw):
  """The port's model on the card: the raw grid prefiltered by the port,
  models/nerf.construct_nerf, then the benchmark's weights."""
  from samplenerfro_torch.models import nerf
  from samplenerfro_torch.ops import grid as grid_ops
  sc = cfg["scene"]
  ndim, e = [sc["grid_n"]] * 3, sc["grid_extent"]
  grid = grid_ops.gaussian_prefilter(raw.reshape(-1, 1), tuple(ndim),
                                     gcfg.kernel_size, gcfg.kernel_sigma)
  model = nerf.construct_nerf(args, ndim, [-e] * 3, [e] * 3, grid, bindings,
                              device=device)
  del grid
  shapes = ref_model.param_shapes(cfg)
  mine = dict(model.named_parameters())
  if {k: tuple(v.shape) for k, v in mine.items()} != shapes:
    raise SystemExit("portbench: the port's parameters are not the "
                     "reference's leaves")
  weights = weights_lib.make(shapes, seed, device, cfg["scene"].get(
      "so3_std", 1e-2))
  with torch.no_grad():
    for k, p in mine.items():
      p.copy_(weights[k])
  return model, weights


def leaf_gaps(prog, ref, names):
  """{leaf: |norm(prog) - norm(ref)| over max(norm(ref), the median leaf's
  norm of ref)}."""
  rn = {k: float(ref[k].norm()) for k in names}
  med = statistics.median(rn.values())
  return {k: abs(float(prog[k].norm()) - rn[k]) / max(rn[k], med, 1e-30)
          for k in names}


def leaf_gap(prog, ref, names):
  """The worst leaf's gap (leaf_gaps)."""
  return max(leaf_gaps(prog, ref, names).values())


def worst_leaves(prog, ref, key, top=3):
  """The `top` leaves of ref[key] whose gap is widest, with their gaps."""
  gaps = leaf_gaps(prog[key], ref[key], sorted(ref[key]))
  return sorted(gaps.items(), key=lambda kv: -kv[1])[:top]


def _moved(ref_grad):
  """The leaves whose reference gradient is at least a thousandth of the
  median leaf's; the others move by round-off alone."""
  gn = {k: float(g.norm()) for k, g in ref_grad.items()}
  med = statistics.median(gn.values())
  return sorted(k for k in gn if gn[k] >= 1e-3 * med)


def _rel(prog, ref):
  return [abs(a - b) / abs(b) for a, b in zip(prog, ref)]


def compare(prog, ref):
  """The numbers of the start, program against reference.

  prog, ref: {"losses": [3], "grad": {leaf: first gradient},
  "change": {leaf: change after step 3}}. Leaves whose reference gradient
  is under a thousandth of the median leaf's are left out of the change.
  Each gap is taken by the worst leaf (and, as *_med, by the median leaf);
  the loss by the worst step (and, as loss1_gap, the first). The cell's
  limits name the ones compared."""
  names = sorted(ref["grad"])
  rel = _rel(prog["losses"], ref["losses"])
  moved = _moved(ref["grad"])
  grad = leaf_gaps(prog["grad"], ref["grad"], names)
  change = leaf_gaps(prog["change"], ref["change"], moved)
  return {"loss_gap": max(rel), "loss1_gap": rel[0],
          "grad_gap": max(grad.values()),
          "grad_gap_med": statistics.median(grad.values()),
          "change_gap": max(change.values()),
          "change_gap_med": statistics.median(change.values())}


def compare_window(prog, ref):
  """The numbers of the window's first replay, program against reference.

  prog: {"offset", "losses" [K], "before", "after" ({"params", "mu",
  "nu"}, dicts by leaf), "counts"}; ref: Trainer.steps' result from
  prog["before"]. The change of the leaves and of each moment over the
  window, by the worst and the median moved leaf; the loss by the worst
  step; Adam's counts against the updates made (exact)."""
  before, after = prog["before"], prog["after"]
  moved = _moved(ref["grad"])
  ref_after = {"params": ref["final"], "mu": ref["mu"], "nu": ref["nu"]}
  out = {"win_loss_gap": max(_rel(prog["losses"], ref["losses"]))}
  for key, tag in (("params", "change"), ("mu", "mu"), ("nu", "nu")):
    d = lambda side: {k: side[key][k] - before[key][k] for k in moved}
    gaps = leaf_gaps(d(after), d(ref_after), moved)
    out[f"win_{tag}_gap"] = max(gaps.values())
    out[f"win_{tag}_gap_med"] = statistics.median(gaps.values())
  want = prog["offset"] + len(prog["losses"])
  out["win_count_gap"] = max(abs(c - want) for c in prog["counts"])
  return out


def reference_batches(cfg, data_dir, seed, device, wanted):
  """{index: batch} of the run's batches at `wanted` indices (0 for the
  first step), each with its fine samples' noise: the capture's batches
  in draw order, one uniform draw of [batch, fine samples] a step from a
  generator on `device` seeded as the program's."""
  data_seed, noise_seed, jitter_seed = seeds(seed)
  f = cfg["flags"]
  batches = ref_scene.Batches(cfg, data_dir, data_seed, jitter_seed)
  gen = torch.Generator(device=device).manual_seed(noise_seed)
  out = {}
  for i in range(max(wanted) + 1):
    b = batches.next(device)
    b["noise"] = torch.rand((f["batch_size"], f["num_fine_samples"]),
                            generator=gen, device=device)
    if i in wanted:
      out[i] = b
  return out


def reference_run(cfg, stage, data_dir, raw, weights, seed, first_step, n,
                  device, window=None, variants=(), stats=None):
  """The reference's start (its first n steps from `weights`) and, given
  the program's `window` (compare_window's prog), the window's K steps
  from the program's leaves and moments before it.

  variants: (name, Prec, keep) run the same way in the program's place;
  the first is the reference. Returns {name: (start, window or None)},
  start = {"losses", "grad", "change"}, window = Trainer.steps'."""
  ref_model.check_supported(cfg)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  sc = ref_scene.Scene(cfg, raw, stage, device)
  steps = len(window["losses"]) if window else 0
  wanted = set(range(n))
  if window:
    wanted |= set(range(window["offset"], window["offset"] + steps))
  bl = reference_batches(cfg, data_dir, seed, device, wanted)
  start = [bl[i] for i in range(n)]
  if stats is not None:
    march_counts(sc, weights, start, first_step, stats)
  out = {}
  for name, prec, keep in variants:
    trainer = ref_model.Trainer(sc, weights, start[0], prec, keep)
    got = trainer.steps(weights, start, first_step)
    got["change"] = {k: got["final"][k] - weights[k] for k in trainer.names}
    win = None
    if window:
      b = window["before"]
      win = trainer.steps(
          b["params"], [bl[window["offset"] + i] for i in range(steps)],
          first_step + window["offset"],
          moments=(b["mu"], b["nu"], window["offset"]))
    out[name] = (got, win)
    del trainer
  return out


def numbers_of(prog, win, got):
  """compare and, given the program's window, compare_window."""
  start, w = got
  out = compare(prog, start)
  if win is not None:
    out.update(compare_window(win, w))
  return out


@torch.no_grad()
def march_counts(sc, weights, batches, first_step, stats):
  """Active ray-steps and distinct voxels of the batches' paths, as the
  reference marches them, averaged over the batches."""
  f = sc.cfg["flags"]
  act, dist = [], []
  for i, b in enumerate(batches):
    s = f["num_coarse_samples"] * f["num_path_samples"]
    h = (f["far"] - f["near"]) / (s - 1)
    alpha = torch.tensor(ref_model.annealed_alpha(first_step + i, f),
                         device=sc.device)
    pos, _, _, g = ref_model.march(
        sc.lat, sc.data, b["origins"], b["viewdirs"], f["near"], s, h,
        weights if sc.stage == "all" else None, alpha)
    act.append(int((g.norm(dim=-1) > 1e-3).sum()))
    dist.append(counts.distinct_voxels(sc.spec, pos))
  stats["active"] = float(np.mean(act))
  stats["distinct"] = float(np.mean(dist))


def _windows(first, k):
  """(first, last) of the run's windows: step `first` alone, the next two,
  then windows on the K grid."""
  from samplenerfro_torch.train import loop
  yield first, first
  yield first + 1, first + 2
  yield from loop.dispatch_windows(first + 3, first + 10**7, k)


def run(cell, cfg, mix, seed, seconds, trace, device, t_start, log,
        variants=()):
  """One run of the cell; `variants` (control, half_batch, bf16_witness)
  are also put in the program's place and compared (calibrate.py)."""
  from samplenerfro_torch.data import datasets
  from samplenerfro_torch.data import prefetch
  from samplenerfro_torch.ops import cuda_build
  from samplenerfro_torch.train import loop
  from samplenerfro_torch.train import step as step_lib
  from samplenerfro_torch.utils import config as config_lib
  split = {"imports": time.perf_counter() - t_start}
  device = torch.device(device)
  stage = mix["stage"]
  cuda = device.type == "cuda"
  if cuda:
    t = time.perf_counter()
    cuda_build.build(KERNELS[stage])
    split["kernels"] = time.perf_counter() - t
  data_seed, noise_seed, jitter_seed = seeds(seed)
  tmp = tempfile.mkdtemp(prefix="portbench-", dir=os.environ.get("TMPDIR"))
  try:
    t = time.perf_counter()
    data_dir = capture.write_capture(cfg, os.path.join(tmp, "scene"), seed)
    split["capture"] = time.perf_counter() - t
    t = time.perf_counter()
    args, gcfg, bindings = port_args(cfg, stage, data_dir)
    config_lib.apply_matmul_precision(args.matmul_precision)
    raw = capture.raw_grid(cfg, device)
    model, weights = build_model(cfg, args, gcfg, bindings, device, seed, raw)
    optimizer, _, _ = step_lib.create_optimizer(model, args)
    dataset = datasets.TrainBatches(args, np.random.RandomState(data_seed))
    s0 = int(mix["resume_step"])
    dataset.train_it = s0
    k = max(1, args.steps_per_dispatch)
    generator = torch.Generator(device=device).manual_seed(noise_seed)
    jitter_gen = torch.Generator().manual_seed(jitter_seed)
    train_step = step_lib.make_train_step_multi(model, optimizer, args, k,
                                                generator)
    sync(device)
    split["model"] = time.perf_counter() - t

    spans = harness.Spans()
    windows = _windows(s0 + 1, k)

    def next_window():
      first, last = next(windows)
      with spans("host_window"):
        return loop.host_window(dataset, first, last, args, optimizer,
                                jitter_gen)

    batches = prefetch.device_prefetch(next_window, device,
                                       size=loop.PREFETCH, stacked=True)
    trained = {n: p for g in optimizer.param_groups
               for n, p in model.named_parameters()
               if any(p is q for q in g["params"])}
    try:
      t = time.perf_counter()
      steps = [train_step(next(batches))]
      b1 = optimizer.b1
      grad = {n: optimizer.state[p]["exp_avg"] / (1 - b1)
              for n, p in trained.items()}
      steps.append(train_step(next(batches)))
      change = {n: p.detach() - weights[n] for n, p in trained.items()}
      losses = [float(v) for st in steps for v in st.loss.reshape(-1)]
      prog = {"losses": losses, "grad": {n: g.clone()
                                         for n, g in grad.items()},
              "change": {n: c.clone() for n, c in change.items()}}
      offset = len(losses)
      del grad, change
      # The rest of the K grid, the eager full window, the capture.
      while True:
        st = train_step(next(batches))
        offset += st.loss.shape[0]
        if getattr(train_step, "graph", None) is not None or not cuda:
          break
      sync(device)
      split["warm-up"] = time.perf_counter() - t
      setup_s = time.perf_counter() - t_start

      stats, inflight, n_steps = [], collections.deque(), 0
      waits = []
      win = None
      t0 = time.perf_counter()
      while True:
        w0 = time.perf_counter()
        with spans("prefetch_wait"):
          batch = next(batches)
        waits.append(time.perf_counter() - w0)
        if win is None:
          win = {"offset": offset, "before": _state(trained, optimizer)}
        with spans("replay"):
          st = train_step(batch)
        if "after" not in win:
          win["after"] = _state(trained, optimizer)
          win["counts"] = [c.clone() for c in optimizer.counts]
        del batch
        stats.append(st.loss)
        n_steps += st.loss.shape[0]
        if cuda:
          ev = torch.cuda.Event()
          ev.record()
          inflight.append(ev)
          if len(inflight) > IN_FLIGHT:
            inflight.popleft().synchronize()
        if time.perf_counter() - t0 >= seconds:
          break
      sync(device)
      elapsed = time.perf_counter() - t0
      win["losses"] = [float(v) for v in stats[0].reshape(-1)]
      win["counts"] = [float(c) for c in win["counts"]]
      losses_w = torch.cat([s.reshape(-1) for s in stats])
      failed = int((~torch.isfinite(losses_w)).sum())
      peak = torch.cuda.max_memory_allocated(device) if cuda else 0
      replays = getattr(train_step, "replays", 0)

      tr = None
      if trace:
        tr = _trace(train_step, batches, spans, int(mix["traced_windows"]),
                    device)
    finally:
      batches.close()
    e2e = {"train_rays_per_s": n_steps * args.batch_size / elapsed,
           "setup_s": setup_s}
    log(f"set-up {setup_s:.3f} s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items()))
    log(f"window: {n_steps} steps ({replays} replays) in {elapsed:.4f} s, "
        f"{e2e['train_rays_per_s']:.1f} rays/s")
    del model, optimizer, train_step, stats, steps, st, trained, next_window
    if cuda:
      torch.cuda.empty_cache()

    t = time.perf_counter()
    mstats = {}
    half = slice(0, args.batch_size // 2)
    runs = [("reference", ref_model.Prec(), None)] + [
        {"control": ("control", ref_model.control_prec(cfg), None),
         "half_batch": ("half_batch", ref_model.Prec(), half),
         "bf16_witness": ("bf16_witness", ref_model.config_prec(cfg), None),
         }[v] for v in variants]
    got = reference_run(cfg, stage, data_dir, raw, weights, seed, s0 + 1,
                        int(mix["check_steps"]), device, win, runs,
                        stats=mstats)
    ref = got.pop("reference")
    numbers = numbers_of(prog, win, ref)
    log(f"reference: {time.perf_counter() - t:.3f} s; losses program "
        f"{prog['losses']} reference {ref[0]['losses']}; window (steps "
        f"{s0 + 1 + offset}-) program {win['losses']} reference "
        f"{ref[1]['losses']}")
    for key in ("grad", "change"):
      log(f"widest {key} gaps: " + ", ".join(
          f"{k} {v:.4g}" for k, v in worst_leaves(prog, ref[0], key)))
    for key in ("params", "mu", "nu"):
      log(f"widest window {key} changes (gap, program norm, reference "
          "norm): " + ", ".join(
              f"{k} {g:.4g} {p:.4g} {r:.4g}"
              for k, g, p, r in _window_widest(win, ref[1], key)))
    log("numbers: " + ", ".join(f"{k} {v:.4g}" for k, v in numbers.items()))
    # Each variant in the program's place: its start and window against
    # the reference's (the window from the same leaves and moments).
    faults = {}
    for name, (start, w) in got.items():
      faults[name] = numbers_of(start, dict(win, losses=w["losses"],
                                            after={"params": w["final"],
                                                   "mu": w["mu"],
                                                   "nu": w["nu"]}), ref)
    checks = {k: (numbers[k], lim) for k, lim in mix["limits"].items()}

    ctx = None
    breakdown = None
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda
                   else "cpu", "count": 1, "memory_peak_bytes": int(peak)}
    if tr is not None:
      ctx = _context(cfg, mix, args, tr, mstats, waits, trained_count=sum(
          int(np.prod(w.shape)) for n, w in weights.items()
          if n in prog["grad"]))
      breakdown = trace_lib.breakdown(tr["trace"])
      device_info["busy_s"] = trace_lib.busy_s(tr["trace"])
      device_info["window_s"] = tr["trace"].window_s
    return {"e2e": e2e, "checks": checks, "numbers": numbers,
            "variants": faults, "attempted": n_steps,
            "failed": failed, "device": device_info, "ctx": ctx,
            "breakdown": breakdown}
  finally:
    shutil.rmtree(tmp, ignore_errors=True)


def _window_widest(win, ref, key, top=2):
  """The `top` moved leaves whose change of `key` over the window has the
  widest gap: (leaf, gap, program's norm, reference's norm)."""
  before = win["before"][key]
  after = {"params": ref["final"], "mu": ref["mu"], "nu": ref["nu"]}[key]
  moved = _moved(ref["grad"])
  p = {k: win["after"][key][k] - before[k] for k in moved}
  r = {k: after[k] - before[k] for k in moved}
  gaps = sorted(leaf_gaps(p, r, moved).items(), key=lambda kv: -kv[1])
  return [(k, g, float(p[k].norm()), float(r[k].norm()))
          for k, g in gaps[:top]]


def _state(trained, optimizer):
  """Copies of the trained leaves and their Adam moments, by leaf."""
  return {"params": {n: p.detach().clone() for n, p in trained.items()},
          "mu": {n: optimizer.state[p]["exp_avg"].clone()
                 for n, p in trained.items()},
          "nu": {n: optimizer.state[p]["exp_avg_sq"].clone()
                 for n, p in trained.items()}}


def _trace(train_step, batches, spans, windows, device):
  """`windows` more windows under torch.profiler, in one pb:traced span
  that ends after a synchronise."""
  from torch.profiler import ProfilerActivity
  from torch.profiler import profile
  acts = [ProfilerActivity.CPU]
  if torch.device(device).type == "cuda":
    acts.append(ProfilerActivity.CUDA)
  spans.traced = True
  steps = 0
  sync(device)
  with profile(activities=acts) as prof:
    with spans("traced"):
      for _ in range(windows):
        with spans("prefetch_wait"):
          batch = next(batches)
        with spans("replay"):
          st = train_step(batch)
        steps += st.loss.shape[0]
        del batch
      with spans("copy_back"):
        sync(device)
  spans.traced = False
  return {"trace": trace_lib.from_profile(prof), "steps": steps}


class Context:
  """What a per-layer reader reads: the trace, spans and counts."""

  def __init__(self, **kw):
    self.__dict__.update(kw)


def _context(cfg, mix, args, tr, mstats, waits, trained_count):
  f = cfg["flags"]
  b = args.batch_size
  env = args.bg_patch_size**2
  active = mstats.get("active", 0.0)
  distinct = mstats.get("distinct", 0.0)
  step_ops = counts.train_step_ops(f, mix["stage"], b, env, active,
                                   trained_count)
  bounds = {"k1": counts.k1(f, b, distinct),
            "k2": counts.k2(f, b, active, distinct),
            "k3": counts.k3(f, b, active, distinct),
            "mlp": counts.mlp_bound(f, b, env, True)}
  return Context(trace=tr["trace"], steps=tr["steps"], stage=mix["stage"],
                 cfg=cfg, step_ops=step_ops, bounds=bounds,
                 input_wait_ms=1e3 * float(np.mean(waits)) if waits else None,
                 active=active, distinct=distinct)
