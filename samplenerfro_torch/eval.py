"""Render the test split of a scene on the GPU and score it.

    python -m samplenerfro_torch.eval --data_dir=<scene> \
        --config=configs/tpu/<scene> --gin_file=configs/tpu/<scene>.gin \
        --train_dir=<out> [--params_npz=<weights.npz>] [--device=cuda] \
        [--stage=all] [--<flag>=<value> ...]

Writes <train_dir>/<stage>/test_preds/NNN.png, disp_NNN.png (the
rendered distance, clipped to [0, 1] as the JAX eval writes it) and the
depth suite depth_NNN.png, depth_mod_NNN.png and depth_normals_NNN.png
(utils/vis.visualize_suite), psnrs_<step>.txt and ssims_<step>.txt (one
value a view), psnr.txt and ssim.txt (their means);
with --eval_train it renders the train split into train_preds/. OpenCV
views are centrally cropped as the JAX loader crops them. Any flag of
utils/config.py may be given as --name=value; an `all*` stage marches with
the so3 head (K2), a radiance or `ior` stage with K1.
--render_path renders the test split's camera path instead, LLFF's
spiral (or orbit, with --spherify), into path_renders/ and scores nothing;
on the other datasets it raises ValueError, as the JAX loaders do.
--save_output=False writes no file. --eval_once=False runs the JAX eval's
checkpoint-watching loop: it reloads the stage's newest checkpoint, sleeps
while its step is no later than the last one evaluated, and stops after
evaluating a step at or past --max_steps; it writes no tensorboard
summaries (the card's machine has no tensorboard package).
The weights are the stage's trained ones: the newest checkpoint under
<train_dir>/<Config.radiance_weight_name> (radiance stages),
<train_dir>/<Config.all_weight_name> (`all` stages), or those radiance
weights and the path sampler of <train_dir>/<Config.ior_weight_name>
(`ior` stages), as the JAX eval's load_stage_variables takes them; eval
raises when there is none. Or they come from --params_npz
(models/convert.py's flat format), whose step is written as 0 and which
is evaluated once. Rendering is deterministic (randomized=False); the
jittered coarse subsample is drawn once per run from --seed and shared by
every chunk, as the JAX renderer shares one key across chunks.
Under torchrun (`torchrun --nproc_per_node=N -m samplenerfro_torch.eval
...`) every rank renders its share of each view's rays (parallel/mesh.py,
utils/render.py), rank 0 scores, prints and writes, as the JAX eval's
process 0 does; with --eval_once=False rank 0 reads the newest
checkpoint's step and decides, and every rank takes its step and rank
0's weights.
"""

import argparse
import collections
import os
import time

import numpy as np
import torch

from samplenerfro_torch.data import datasets
from samplenerfro_torch.data.rays import namedtuple_map
from samplenerfro_torch.models import convert
from samplenerfro_torch.models import nerf
from samplenerfro_torch.parallel import mesh
from samplenerfro_torch.train import checkpoints
from samplenerfro_torch.utils import config as config_lib
from samplenerfro_torch.utils import grid_io
from samplenerfro_torch.utils import metrics
from samplenerfro_torch.utils import render as render_lib
from samplenerfro_torch.utils import vis


def make_render_fn(model, jitter):
  """Chunk renderer for utils/render.render_image: final-level outputs.

  Rendering computes the MLPs in fp32 whatever the training dtype, and at
  annealing alpha 1, as samplenerfro_tpu/train/step.py:make_render_fn does.
  """
  def render_fn(rays):
    return model(rays, jitter, randomized=False,
                 mlp_dtype=torch.float32)[0][-1]
  return render_fn


EvalResult = collections.namedtuple("EvalResult", ("psnrs", "ssims", "step"))
POLL_SECONDS = 10  # eval.py:110's wait for a newer checkpoint


def build_model(args, cfg, bindings, data_dir, device, seed=0,
                params_npz=None):
  """Grid from the scene's mesh.pkl + NerfModel with the weights of
  params_npz or, without it, drawn from `seed`."""
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
  p.add_argument("--params_npz", default=None,
                 help="weights to render instead of the stage's checkpoint")
  p.add_argument("--device", default=None, help="cuda (default) or cpu")
  p.add_argument("--seed", type=int, default=0,
                 help="seed of the coarse subsample's jitter")
  ns, rest = p.parse_known_args(argv)
  with mesh.process_group(ns.device) as device:
    return _eval(ns, rest, device)


def _eval(ns, rest, device):
  """main's run on `device`, as a rank of the process group if any."""
  args, cfg, bindings = config_lib.load_args(
      ns.config, ns.gin_file, ns.gin_param,
      **config_lib.parse_flag_overrides(rest))
  args.data_dir, args.train_dir = ns.data_dir, ns.train_dir
  config_lib.apply_matmul_precision(args.matmul_precision)
  datasets.check_dataset(args)
  if args.render_path:
    rays, images = datasets.load_render_path(args), None
  else:
    rays, images = datasets.load_split(args, "test")
  model = build_model(args, cfg, bindings, ns.data_dir, device, ns.seed,
                      ns.params_npz)
  gen = torch.Generator().manual_seed(ns.seed)
  jitter = nerf.make_jitter(args.num_coarse_samples, args.num_path_samples,
                            gen)
  render_fn = make_render_fn(model, jitter)

  out_dir = os.path.join(
      ns.train_dir, args.stage,
      "train_preds" if args.eval_train else
      "path_renders" if args.render_path else "test_preds")
  last_step = 0
  while True:
    step = 0
    if not ns.params_npz:
      step = checkpoints.load_stage_weights(model, ns.train_dir, cfg,
                                            args.stage)
      # Rank 0's step and weights: a checkpoint written between two
      # ranks' reads cannot set them apart.
      step = mesh.broadcast_object(step)
      mesh.broadcast_module_state(model)
      if step <= last_step:
        time.sleep(POLL_SECONDS)
        continue
    result = evaluate(args, render_fn, rays, images, step, device,
                      out_dir if args.save_output else None)
    if args.eval_once or ns.params_npz or step >= args.max_steps:
      return result
    last_step = step


def evaluate(args, render_fn, rays, images, step, device, out_dir):
  """Render every view of `rays` ([n, h, w, C]) and score it against
  `images` (None: a render path, scored against nothing); writes the
  images and scores into out_dir unless it is None. Under ranks every
  rank renders, and rank 0 alone scores, prints and writes (the others
  return no scores)."""
  if mesh.rank() != 0:
    out_dir = None
  if out_dir is not None:
    os.makedirs(out_dir, exist_ok=True)
  psnrs, ssims = [], []
  n = rays.origins.shape[0]
  for idx in range(n):
    if images is None:
      view, pixels = namedtuple_map(lambda r: r[idx], rays), None
    else:
      view, pixels = datasets.eval_view(args, rays, images, idx)
    rgb, disp, acc = render_lib.render_image(
        render_fn, view, args.dataset == "llff", chunk=args.chunk,
        device=device, chunks_per_dispatch=args.render_chunks_per_dispatch)
    if mesh.rank() != 0:
      continue
    if pixels is None:
      print(f"Rendering {idx + 1}/{n}")
    else:
      psnrs.append(metrics.compute_psnr(((rgb - pixels)**2).mean()))
      ssims.append(float(metrics.compute_ssim(rgb, pixels, 1.0)))
      print(f"Evaluating {idx + 1}/{n}: PSNR = {psnrs[-1]:.4f}, "
            f"SSIM = {ssims[-1]:.4f}")
    if out_dir is not None:
      save_img(rgb, os.path.join(out_dir, f"{idx:03d}.png"))
      save_img(disp[..., 0], os.path.join(out_dir, f"disp_{idx:03d}.png"))
      for k, v in vis.visualize_suite(disp[..., 0], acc[..., 0]).items():
        save_img(v.numpy(), os.path.join(out_dir, f"{k}_{idx:03d}.png"))
  if out_dir is not None and images is not None:
    for name, values in (("psnr", psnrs), ("ssim", ssims)):
      with open(os.path.join(out_dir, f"{name}s_{step}.txt"), "w") as f:
        f.write(" ".join(str(v) for v in values))
      with open(os.path.join(out_dir, f"{name}.txt"), "w") as f:
        f.write(f"{np.mean(values)}")
  return EvalResult(psnrs, ssims, step)


if __name__ == "__main__":
  main()
