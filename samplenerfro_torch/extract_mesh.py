"""Extract a trained scene's density mesh and dump one pixel's curved path.

    python -m samplenerfro_torch.extract_mesh --data_dir=<scene> \
        --train_dir=<out> --config=configs/<scene> \
        --gin_file=configs/<scene>.gin --stage=radiance \
        [--resolution=256] [--range=1.2] [--threshold=0.1] [--img_idx=35] \
        [--pixel=210 --pixel=244] [--device=cuda] [--<flag>=<value> ...]

The port's counterpart of extract_mesh.py, with its flags and outputs,
written to <train_dir>/<stage>/debug/:
  1. color.png and acc.npy: test view min(img_idx, views) (the 1-based
     view, or the first for 0) rendered through eval's render function
     (K1 in a radiance stage, K2 in an `all` stage).
  2. ray_<img_idx-1:03d>_<row:03d>_<col:03d>.pkl: the path of --pixel in
     that view marched without a jitter (K2 with the so3 head off in a
     radiance stage, K2 in `all`), with the keys ray_pos, ray_dir,
     idx_grad (grad n), transform (None) and ray_pos_c (every
     num_path_samples-th vertex); and its plots top.png, right.png,
     front.png and free.png (utils/plt_utils.plot_path).
  3. mesh_<resolution>_<range>_<threshold>.obj: marching tetrahedra of the
     fine MLP's alpha (NerfModel.sample_points, zero view directions) on
     the (resolution + 1)^3 lattice of np.meshgrid(t, t, t) over
     [-range, range], queried in chunks of --chunk with the tail chunk
     padded, vertices written as index / resolution - 0.5. These
     conventions are the JAX tool's output format.
The weights are the stage's checkpoint, as eval reads them.
"""

import argparse
import os
import pickle
import time

import numpy as np
import torch

from samplenerfro_torch import resolve_device
from samplenerfro_torch.data import datasets
from samplenerfro_torch.eval import build_model
from samplenerfro_torch.eval import make_render_fn
from samplenerfro_torch.eval import save_img
from samplenerfro_torch.models import nerf
from samplenerfro_torch.tools import isosurface
from samplenerfro_torch.tools import objio
from samplenerfro_torch.train import checkpoints
from samplenerfro_torch.utils import config as config_lib
from samplenerfro_torch.utils import plt_utils
from samplenerfro_torch.utils import render as render_lib


def dump_path(model, view, pixel, num_path_samples, device):
  """The pixel's path marched without a jitter, as the dump's dict."""
  r, c = pixel
  h, w = np.asarray(view.origins).shape[:2]
  if not (0 <= r < h and 0 <= c < w):
    raise ValueError(f"pixel {pixel} lies outside the {h}x{w} view")
  origins, viewdirs = (
      torch.from_numpy(np.ascontiguousarray(
          np.asarray(x)[r:r + 1, c:c + 1].reshape(1, -1))).to(device)
      for x in (view.origins, view.viewdirs))
  with torch.no_grad():
    ray_pos, ray_dir, _, _, idx_grad, _ = model.path_sampler(
        origins, viewdirs, None, 1.0)
  ray_pos = ray_pos.cpu().numpy()
  return {
      "ray_pos": ray_pos,
      "ray_dir": ray_dir.cpu().numpy(),
      "idx_grad": idx_grad.cpu().numpy(),
      "transform": None,
      "ray_pos_c": ray_pos[:, np.arange(0, ray_pos.shape[1],
                                        num_path_samples)],
  }


def density_grid(model, resolution, extent, chunk, device):
  """Alpha of NerfModel.sample_points on np.meshgrid(t, t, t) (xy
  indexing), t = linspace(-extent, extent, resolution + 1): a
  [resolution + 1]^3 float32 array."""
  t = np.linspace(-extent, extent, resolution + 1)
  query_pts = np.stack(np.meshgrid(t, t, t), -1).astype(np.float32)
  sh = query_pts.shape
  flat = torch.from_numpy(query_pts.reshape([-1, 3])).to(device)
  sigma = []
  with torch.no_grad():
    for i in range(0, flat.shape[0], chunk):
      pts = flat[i:i + chunk, None, :]
      pad = chunk - pts.shape[0]
      if pad:  # pad the tail chunk to a fixed shape with its last point
        pts = torch.cat([pts, pts[-1:].expand(pad, 1, 3)], dim=0)
      alpha = model.sample_points(pts, torch.zeros_like(pts))[1]
      sigma.append(alpha[:alpha.shape[0] - pad])
  return torch.cat(sigma, 0).reshape(list(sh[:-1])).cpu().numpy()


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--data_dir", required=True)
  p.add_argument("--train_dir", required=True)
  p.add_argument("--config", default=None,
                 help="flag overlay path without .yaml")
  p.add_argument("--gin_file", action="append", default=[])
  p.add_argument("--gin_param", action="append", default=[])
  p.add_argument("--device", default=None, help="cuda (default) or cpu")
  p.add_argument("--seed", type=int, default=0,
                 help="seed of the debug view's coarse-subsample jitter")
  p.add_argument("--resolution", type=int, default=256,
                 help="voxel grid resolution for marching cubes")
  p.add_argument("--range", type=float, default=1.2,
                 help="bounding box range for marching cubes")
  p.add_argument("--threshold", type=float, default=0.1,
                 help="threshold of isosurface")
  p.add_argument("--img_idx", type=int, default=35,
                 help="dataset view to render for debugging")
  p.add_argument("--pixel", type=int, action="append", default=None,
                 help="pixel (row, col) whose curved path is dumped: twice")
  ns, rest = p.parse_known_args(argv)
  pixel = tuple(ns.pixel or (210, 244))

  device = resolve_device(ns.device)
  args, cfg, bindings = config_lib.load_args(
      ns.config, ns.gin_file, ns.gin_param,
      **config_lib.parse_flag_overrides(rest))
  args.data_dir, args.train_dir = ns.data_dir, ns.train_dir
  datasets.check_dataset(args)
  rays, images = datasets.load_split(args, "test")
  model = build_model(args, cfg, bindings, ns.data_dir, device)
  checkpoints.load_stage_weights(model, ns.train_dir, cfg, args.stage)
  out_dir = os.path.join(ns.train_dir, args.stage, "debug")
  os.makedirs(out_dir, exist_ok=True)
  times = {}

  # 1. The debug view: the img_idx-th view counted from 1 (the first for 0).
  t0 = time.time()
  img_idx = min(ns.img_idx, images.shape[0])
  view, _ = datasets.eval_view(args, rays, images, max(img_idx - 1, 0))
  jitter = nerf.make_jitter(args.num_coarse_samples, args.num_path_samples,
                            torch.Generator().manual_seed(ns.seed))
  rgb, _, acc = render_lib.render_image(
      make_render_fn(model, jitter), view, args.dataset == "llff",
      chunk=args.chunk, device=device)
  save_img(rgb, os.path.join(out_dir, "color.png"))
  np.save(os.path.join(out_dir, "acc.npy"), acc)
  times["view_s"] = time.time() - t0

  # 2. The curved path of the chosen pixel.
  t0 = time.time()
  dump = dump_path(model, view, pixel, args.num_path_samples, device)
  dump_file = os.path.join(
      out_dir, f"ray_{(img_idx - 1):03d}_{pixel[0]:03d}_{pixel[1]:03d}.pkl")
  with open(dump_file, "wb") as f:
    pickle.dump(dump, f)
  plt_utils.plot_path(dump["ray_pos"], out_dir=out_dir)
  times["path_s"] = time.time() - t0

  # 3. The density field's iso-surface.
  t0 = time.time()
  n = ns.resolution
  sigma = density_grid(model, n, ns.range, args.chunk, device)
  times["density_s"] = time.time() - t0
  times["points_per_s"] = sigma.size / times["density_s"]
  print("fraction occupied", np.mean(sigma > ns.threshold))
  t0 = time.time()
  vertices, triangles = isosurface.marching_cubes(sigma, ns.threshold)
  times["isosurface_s"] = time.time() - t0
  print("done", vertices.shape, triangles.shape)
  mesh_file = os.path.join(
      out_dir, f"mesh_{ns.resolution}_{ns.range}_{ns.threshold}.obj")
  objio.Trimesh(vertices / n - 0.5, triangles).export(mesh_file)
  print(f"extract_mesh: view {times['view_s']:.3f} s, path "
        f"{times['path_s']:.3f} s, density {times['density_s']:.3f} s "
        f"({times['points_per_s']:.1f} points/s), isosurface "
        f"{times['isosurface_s']:.3f} s", flush=True)
  return {"out_dir": out_dir, "dump": dump_file, "mesh": mesh_file,
          "sigma": sigma, "vertices": vertices, "faces": triangles,
          "times": times}


if __name__ == "__main__":
  main()
