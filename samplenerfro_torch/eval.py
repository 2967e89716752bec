"""Render the test split of a Blender scene on the GPU and score it.

    python -m samplenerfro_torch.eval --data_dir=<scene> \
        --config=configs/tpu/<scene> --gin_file=configs/tpu/<scene>.gin \
        --train_dir=<out> [--params_npz=<weights.npz>] [--device=cuda]

Writes <train_dir>/<stage>/test_preds/NNN.png and psnr.txt (mean PSNR).
Weights come from --params_npz (models/convert.py's flat format) or, without
it, are drawn from --seed. Rendering is deterministic (randomized=False);
the jittered coarse subsample is drawn once per run from --seed and shared
by every chunk, as the JAX renderer shares one key across chunks.
"""

import argparse
import os

import numpy as np
import torch

from samplenerfro_torch import resolve_device
from samplenerfro_torch.data import datasets
from samplenerfro_torch.models import convert
from samplenerfro_torch.models import nerf
from samplenerfro_torch.utils import config as config_lib
from samplenerfro_torch.utils import grid_io
from samplenerfro_torch.utils import metrics
from samplenerfro_torch.utils import render as render_lib


def make_render_fn(model, jitter):
  """Chunk renderer for utils/render.render_image: final-level outputs."""
  def render_fn(rays):
    return model(rays, jitter, randomized=False)[-1]
  return render_fn


def build_model(args, cfg, bindings, data_dir, device, seed=0,
                params_npz=None):
  """Grid from the scene's mesh.pkl + NerfModel with loaded or seeded weights."""
  grid, ndim, nmin, nmax = grid_io.load_ior_grid(data_dir, cfg, args.config,
                                                 device)
  model = nerf.construct_nerf(args, ndim, nmin, nmax, grid, bindings,
                              device=device, seed=seed)
  if params_npz:
    convert.load_into(model, convert.params_from_npz(params_npz))
  return model


def save_img(img, pth):
  from PIL import Image
  Image.fromarray((np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)).save(
      pth, "PNG")


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--data_dir", required=True)
  p.add_argument("--train_dir", required=True)
  p.add_argument("--config", default=None,
                 help="flag overlay path without .yaml")
  p.add_argument("--gin_file", action="append", default=[])
  p.add_argument("--gin_param", action="append", default=[])
  p.add_argument("--params_npz", default=None)
  p.add_argument("--device", default=None, help="cuda (default) or cpu")
  p.add_argument("--seed", type=int, default=0)
  p.add_argument("--chunk", type=int, default=None)
  ns = p.parse_args(argv)

  device = resolve_device(ns.device)
  overrides = {} if ns.chunk is None else {"chunk": ns.chunk}
  args, cfg, bindings = config_lib.load_args(ns.config, ns.gin_file,
                                             ns.gin_param, **overrides)
  rays, images = datasets.load_blender_test(
      ns.data_dir, args.factor, args.use_pixel_centers, args.white_bkgd,
      args.skip_frames)
  model = build_model(args, cfg, bindings, ns.data_dir, device, ns.seed,
                      ns.params_npz)
  gen = torch.Generator().manual_seed(ns.seed)
  jitter = nerf.make_jitter(args.num_coarse_samples, args.num_path_samples,
                            gen, device)
  render_fn = make_render_fn(model, jitter)

  out_dir = os.path.join(ns.train_dir, args.stage, "test_preds")
  os.makedirs(out_dir, exist_ok=True)
  psnrs = []
  for idx in range(images.shape[0]):
    view = type(rays)(*[r[idx] for r in rays])
    rgb, _, _ = render_lib.render_image(render_fn, view,
                                        args.dataset == "llff",
                                        chunk=args.chunk, device=device)
    psnr = metrics.compute_psnr(((rgb - images[idx])**2).mean())
    psnrs.append(psnr)
    print(f"Evaluating {idx + 1}/{images.shape[0]}: PSNR = {psnr:.4f}")
    save_img(rgb, os.path.join(out_dir, f"{idx:03d}.png"))
  with open(os.path.join(out_dir, "psnr.txt"), "w") as f:
    f.write(f"{np.mean(psnrs)}")
  return psnrs


if __name__ == "__main__":
  main()
