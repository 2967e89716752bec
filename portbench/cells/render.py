"""A render cell: test views of the 'all' model, one after another.

Set-up makes the grid and the weights on the card, the port's model of
the stage (models/nerf.construct_nerf), eval's render function
(eval.make_render_fn: fp32 MLPs, annealing alpha 1, one jitter drawn as
eval draws it) and each view's rays from its seeded pose on the test ring
(data/rays.generate_pinhole_rays or generate_opencv_rays, the loaders'
own), and renders the first view. The timed window renders views through
utils/render.render_image at the config's chunk and chunks a dispatch
until --seconds have passed; a view ends when its pixels are back on the
host.

`correct` holds a sample of the window's views, drawn from the seed,
against the plain reference's render of the same rays: the worst view's
mean square error of rgb, and mean absolute errors of acc and of distance
over far - near.
"""

import os
import time

import numpy as np
import torch

from portbench import harness
from portbench import trace as trace_lib
from portbench.cells import train as train_cell
from portbench.counts import nerf as counts
from portbench.reference import model as ref_model
from portbench.reference import scene as ref_scene
from portbench.traffic import capture


def view_size(cfg):
  sc = cfg["scene"]
  div = 2 if cfg["flags"]["factor"] == 2 else 1
  return sc["width"] // div, sc["height"] // div


def port_rays(cfg, c2w):
  """Rays [h, w, C] of one view through the port's ray generation."""
  from samplenerfro_torch.data import rays as rays_lib
  w, h = view_size(cfg)
  sc = cfg["scene"]
  if cfg["flags"]["dataset"] == "opencv":
    f = sc["focal_scale"] * sc["width"]
    k = [[f, 0.0, 0.5 * sc["width"] + sc["principal_offset"][0]],
         [0.0, f, 0.5 * sc["height"] + sc["principal_offset"][1]],
         [0.0, 0.0, 1.0]]
    rays = rays_lib.generate_opencv_rays(w, h, k, c2w[None], True)
  else:
    focal = 0.5 * w / np.tan(0.5 * sc["camera_angle_x"])
    rays = rays_lib.generate_pinhole_rays(w, h, focal, c2w[None], True)
  return rays_lib.namedtuple_map(lambda r: r[0], rays)


def reference_rays(cfg, c2w):
  w, h = view_size(cfg)
  sc = cfg["scene"]
  focal = 0.5 * w / np.tan(0.5 * sc["camera_angle_x"])
  o, d = ref_scene.pinhole_rays(w, h, focal, c2w[None].astype(np.float32))
  return o.reshape(-1, 3), d.reshape(-1, 3)


def compare(prog, ref, span):
  """One view's gaps: rgb's mean square error, acc's and distance's (over
  span) mean absolute errors."""
  (pr, pd, pa), (rr, rd, ra) = prog, ref
  return {"rgb_mse": float(((pr - rr)**2).mean()),
          "acc_mae": float((pa - ra).abs().mean()),
          "dist_mae": float((pd - rd).abs().mean()) / span}


def reference_views(cfg, raw, weights, poses, jitter, device,
                    prec=ref_model.Prec(), stats=None):
  """The reference's (rgb, distance, acc) of each pose's view."""
  ref_model.check_supported(cfg)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  sc = ref_scene.Scene(cfg, raw, "all", device)
  out = []
  for c2w in poses:
    o, d = reference_rays(cfg, c2w)
    o, d = torch.from_numpy(o).to(device), torch.from_numpy(d).to(device)
    if stats is not None and "active" not in stats:
      _march_counts(cfg, sc, weights, o, d, stats)
    out.append(ref_model.render(sc, weights, o, d, jitter.to(device), prec))
  return out


@torch.no_grad()
def _march_counts(cfg, sc, weights, o, d, stats):
  """Active ray-steps and distinct voxels of one chunk of the render's
  first rays in its tile order, as the reference marches them."""
  f = cfg["flags"]
  w, h = view_size(cfg)
  rows = torch.from_numpy(counts.tile_order(h, w)[:f["chunk"]]).to(o.device)
  s = f["num_coarse_samples"] * f["num_path_samples"]
  pos, _, _, g = ref_model.march(
      sc.lat, sc.data, o[rows], d[rows], f["near"], s,
      (f["far"] - f["near"]) / (s - 1), weights,
      torch.tensor(1.0, device=o.device))
  stats["active"] = float((g.norm(dim=-1) > 1e-3).sum())
  stats["distinct"] = float(counts.distinct_voxels(sc.spec, pos))
  stats["rays"] = int(rows.shape[0])


def run(cell, cfg, mix, seed, seconds, trace, device, t_start, log):
  from samplenerfro_torch.eval import make_render_fn
  from samplenerfro_torch.models import nerf
  from samplenerfro_torch.ops import cuda_build
  from samplenerfro_torch.utils import config as config_lib
  from samplenerfro_torch.utils import render as render_lib
  split = {"imports": time.perf_counter() - t_start}
  device = torch.device(device)
  cuda = device.type == "cuda"
  stage = mix["stage"]
  if cuda:
    t = time.perf_counter()
    cuda_build.build(train_cell.KERNELS[stage][:1])
    split["kernels"] = time.perf_counter() - t
  t = time.perf_counter()
  args, gcfg, bindings = train_cell.port_args(cfg, stage, None)
  config_lib.apply_matmul_precision(args.matmul_precision)
  raw = capture.raw_grid(cfg, device)
  model, weights = train_cell.build_model(cfg, args, gcfg, bindings, device,
                                          seed, raw)
  jitter = nerf.make_jitter(args.num_coarse_samples, args.num_path_samples,
                            torch.Generator().manual_seed(seed + 303))
  render_fn = make_render_fn(model, jitter)
  poses = capture.test_poses(cfg, seed, int(mix["views"]))
  views = [port_rays(cfg, c2w) for c2w in poses]
  split["model"] = time.perf_counter() - t
  spans = harness.Spans()

  def render(i):
    with spans("render_group"):
      return render_lib.render_image(
          render_fn, views[i % len(views)], False, chunk=args.chunk,
          device=device, chunks_per_dispatch=args.render_chunks_per_dispatch)

  t = time.perf_counter()
  render(0)
  split["first view"] = time.perf_counter() - t
  setup_s = time.perf_counter() - t_start
  outs, done = [], 0
  t0 = time.perf_counter()
  while time.perf_counter() - t0 < seconds:
    outs.append(render(1 + done))
    done += 1
  elapsed = time.perf_counter() - t0
  w, h = view_size(cfg)
  e2e = {"render_rays_per_s": done * w * h / elapsed, "setup_s": setup_s}
  failed = sum(int(not all(np.isfinite(a).all() for a in o)) for o in outs)
  peak = torch.cuda.max_memory_allocated(device) if cuda else 0
  tr = _trace(render, done + 1, int(mix["traced_views"]), spans,
              device) if trace else None
  log(f"set-up {setup_s:.3f} s: " + ", ".join(
      f"{k} {v:.3f}" for k, v in split.items()))
  log(f"window: {done} views in {elapsed:.4f} s, "
      f"{e2e['render_rays_per_s']:.1f} rays/s")

  rng = np.random.RandomState((seed * 3 + 5) % 2**32)
  pick = sorted(rng.choice(done, min(done, int(mix["sample_views"])),
                           replace=False).tolist())
  prog = [tuple(torch.from_numpy(a.reshape(h * w, -1)).squeeze(-1)
                for a in outs[i]) for i in pick]
  del model, render_fn, outs
  if cuda:
    torch.cuda.empty_cache()
  t = time.perf_counter()
  mstats = {}
  refs = reference_views(cfg, raw, weights,
                         [poses[(1 + i) % len(poses)] for i in pick], jitter,
                         device, stats=mstats)
  span = cfg["flags"]["far"] - cfg["flags"]["near"]
  worst = {}
  for p, r in zip(prog, refs):
    for k, v in compare(p, tuple(x.cpu() for x in r), span).items():
      worst[k] = max(worst.get(k, 0.0), v)
  log(f"reference: {time.perf_counter() - t:.3f} s for views {pick}")
  checks = {k: (worst[k], lim) for k, lim in mix["limits"].items()}
  device_info = {"platform": "gpu" if cuda else "cpu",
                 "kind": torch.cuda.get_device_name(device) if cuda
                 else "cpu", "count": 1, "memory_peak_bytes": int(peak)}
  ctx, breakdown = None, None
  if tr is not None:
    f = cfg["flags"]
    chunk_rays = mstats.get("rays", f["chunk"])
    ctx = train_cell.Context(
        trace=tr["trace"], rays=tr["rays"], cfg=cfg, stage=stage,
        ops_per_ray={c: n / chunk_rays for c, n in counts.render_ops(
            f, chunk_rays, mstats.get("active", 0.0)).items()},
        bounds={"k2": counts.k2(f, chunk_rays, mstats.get("active", 0.0),
                                mstats.get("distinct", 0.0)),
                "mlp": counts.mlp_bound(f, chunk_rays, 0, False,
                                        render_fp32=True)},
        chunk=f["chunk"])
    breakdown = trace_lib.breakdown(tr["trace"])
    device_info["busy_s"] = trace_lib.busy_s(tr["trace"])
    device_info["window_s"] = tr["trace"].window_s
  return {"e2e": e2e, "checks": checks, "numbers": worst,
          "attempted": done, "failed": failed,
          "device": device_info, "ctx": ctx, "breakdown": breakdown}


def _trace(render, first, count, spans, device):
  from torch.profiler import ProfilerActivity
  from torch.profiler import profile
  acts = [ProfilerActivity.CPU]
  if torch.device(device).type == "cuda":
    acts.append(ProfilerActivity.CUDA)
  spans.traced = True
  rays = 0
  with profile(activities=acts) as prof:
    with spans("traced"):
      for i in range(count):
        rgb, _, _ = render(first + i)
        rays += rgb.shape[0] * rgb.shape[1]
  spans.traced = False
  return {"trace": trace_lib.from_profile(prof), "rays": rays}
