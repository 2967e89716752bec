"""Train a stage of the refractive NeRF on a Blender or OpenCV scene on a GPU.

    python -m samplenerfro_torch.train --data_dir=<scene> \\
        --train_dir=<out> --config=configs/tpu/<scene> \\
        --gin_file=configs/tpu/<scene>.gin --stage=radiance [--device=cuda]

The flags and stage names are train.py's: any flag of utils/config.py may
be given as --name=value and wins over the --config overlay. Stages
`radiance*` train the radiance MLPs through the lean march (K1); stages
`all*` train everything, the so3 head through the differentiable march
(K2 forward, K3 backward). Checkpoints go to <train_dir>/<stage>/
checkpoint_<step> every --save_every steps and at the end; a rerun resumes
from the newest. Every --print_every steps one line reports the loss and
rays/s; every --render_every steps a view of the val split (OpenCV views
centrally cropped, as eval crops its test views) is rendered through
samplenerfro_torch.eval's render function and its PSNR and SSIM printed.
The `all` stage starts from --params_npz or weights drawn from --seed, as
train.py starts it from its initialisation; eval then reads what this
writes.

Not ported from train.py: the TPU march calibration and out-of-window
ladder (the CUDA marches have no window), multi-step dispatch, threaded
prefetch and tensorboard summaries.
"""

import argparse
import os
import time

import numpy as np
import torch

from samplenerfro_torch import resolve_device
from samplenerfro_torch.data import datasets
from samplenerfro_torch.data.rays import namedtuple_map
from samplenerfro_torch.eval import build_model
from samplenerfro_torch.eval import make_render_fn
from samplenerfro_torch.models import nerf
from samplenerfro_torch.train import checkpoints
from samplenerfro_torch.train import step as step_lib
from samplenerfro_torch.utils import config as config_lib
from samplenerfro_torch.utils import metrics
from samplenerfro_torch.utils import render as render_lib

DATA_SEED = 20201473   # train.py:47 seeds numpy's global state with it
NOISE_SEED = 20200823  # train.py:46's PRNGKey


def batch_to_device(batch, alpha, device):
  """A host batch of numpy arrays -> the train step's tensors."""
  move = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
  return {"pixels": move(batch["pixels"]),
          "rays": namedtuple_map(move, batch["rays"]),
          "env_rays": (namedtuple_map(move, batch["env_rays"])
                       if batch["env_rays"] is not None else None),
          "annealed_alpha": alpha}


def annealed_alpha(step, args):
  """PE annealing progress of a step (train.py:189-191), in float32."""
  return float(np.float32(max(step - args.anneal_delay_steps, 0))
               / np.float32(args.anneal_max_steps - args.anneal_delay_steps))


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--data_dir", required=True)
  p.add_argument("--train_dir", required=True)
  p.add_argument("--config", default=None,
                 help="flag overlay path without .yaml")
  p.add_argument("--gin_file", action="append", default=[])
  p.add_argument("--gin_param", action="append", default=[])
  p.add_argument("--params_npz", default=None,
                 help="initial weights (models/convert.py's format)")
  p.add_argument("--device", default=None, help="cuda (default) or cpu")
  p.add_argument("--seed", type=int, default=0,
                 help="seed of the initial weights")
  ns, rest = p.parse_known_args(argv)

  device = resolve_device(ns.device)
  args, cfg, bindings = config_lib.load_args(
      ns.config, ns.gin_file, ns.gin_param,
      **config_lib.parse_flag_overrides(rest))
  args.data_dir, args.train_dir = ns.data_dir, ns.train_dir
  datasets.check_dataset(args)
  step_lib.check_supported(args)

  rng = np.random.RandomState(DATA_SEED)
  dataset = datasets.TrainBatches(args, rng)
  model = build_model(args, cfg, bindings, ns.data_dir, device, ns.seed,
                      ns.params_npz)
  optimizer, lr_fn, _ = step_lib.create_optimizer(model, args)
  stage_dir = os.path.join(ns.train_dir, args.stage)
  os.makedirs(stage_dir, exist_ok=True)
  init_step = checkpoints.restore_checkpoint(stage_dir, model, optimizer) + 1
  dataset.train_it = init_step - 1
  generator = torch.Generator(device=device).manual_seed(NOISE_SEED)
  jitter_gen = torch.Generator().manual_seed(NOISE_SEED)

  val = None
  if args.render_every > 0:
    val = datasets.load_split(args, "val")
  val_it = init_step // args.render_every if args.render_every > 0 else 0

  stats_trace = []
  t_loop = time.time()
  for step in range(init_step, args.max_steps + 1):
    batch = batch_to_device(next(dataset), annealed_alpha(step, args),
                            device)
    jitter = nerf.make_jitter(args.num_coarse_samples,
                              args.num_path_samples, jitter_gen)
    stats_trace.append(step_lib.train_step(model, optimizer, batch, step,
                                           args, generator, jitter))
    if step % args.print_every == 0:
      trace = [s.as_floats() for s in stats_trace]
      avg = lambda name: float(np.mean([getattr(s, name) for s in trace]))
      rays_per_sec = (len(trace) * args.batch_size) / (time.time() - t_loop)
      width = int(np.ceil(np.log10(args.max_steps))) + 1
      print(f"{step:{width}d}/{args.max_steps:d}: "
            f"i_loss={trace[-1].loss:0.4f}, avg_loss={avg('loss'):0.4f}, "
            f"avg_loss_c={avg('loss_c'):0.4f}, "
            f"avg_loss_bg={avg('loss_bg'):0.4f}, "
            f"weight_l2={trace[-1].weight_l2:0.2e}, lr={lr_fn(step):0.2e}, "
            f"{rays_per_sec:0.0f} rays/sec", flush=True)
      stats_trace = []
      t_loop = time.time()
    if step % args.save_every == 0:
      checkpoints.save_checkpoint(stage_dir, model, optimizer, step)
    if args.render_every > 0 and step % args.render_every == 0:
      rays, images = val
      idx = val_it % images.shape[0]
      val_it += 1
      t0 = time.time()
      jitter = nerf.make_jitter(args.num_coarse_samples,
                                args.num_path_samples, jitter_gen)
      view, pixels = datasets.eval_view(args, rays, images, idx)
      rgb, _, _ = render_lib.render_image(
          make_render_fn(model, jitter), view, args.dataset == "llff",
          chunk=args.chunk, device=device)
      secs = time.time() - t0
      psnr = metrics.compute_psnr(((rgb - pixels)**2).mean())
      ssim = float(metrics.compute_ssim(rgb, pixels, 1.0))
      rays_per_sec = rgb.shape[0] * rgb.shape[1] / secs
      print(f"Eval {step}: {secs:0.3f}s., {rays_per_sec:0.0f} rays/sec, "
            f"PSNR = {psnr:.4f}, SSIM = {ssim:.4f}", flush=True)
      t_loop += secs
  if args.max_steps % args.save_every != 0:
    checkpoints.save_checkpoint(stage_dir, model, optimizer, args.max_steps)
  return model
