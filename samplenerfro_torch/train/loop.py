"""Train a stage of the refractive NeRF on a scene on a GPU.

    python -m samplenerfro_torch.train --data_dir=<scene> \\
        --train_dir=<out> --config=configs/tpu/<scene> \\
        --gin_file=configs/tpu/<scene>.gin --stage=radiance [--device=cuda]

The flags and stage names are train.py's: any flag of utils/config.py may
be given as --name=value and wins over the --config overlay; --dataset is
blender, llff, nsvf or opencv. Stages `radiance*` train the radiance MLPs
through the lean march (K1); stages `ior*` train the so3 head alone on
boundary points of the IOR grid (data/datasets.Grid), marching nothing;
stages `all*` train everything, the so3 head through the differentiable
march (K2 forward, K3 backward). Where a loss term reads boundary points
(the sparsity term, the `all` stage's normal terms) each batch carries a
Grid batch too, drawn from a RandomState of its own. Checkpoints go to
<train_dir>/<stage>/checkpoint_<step> every --save_every steps and at the
end; a rerun resumes from the newest, whether the port wrote it or the
JAX package's train.py did (an orbax directory or a legacy flax msgpack
file, train/checkpoints.py): its step, weights and Adam state (moments,
counts, so the learning-rate schedule goes on at the restored count) are
carried over, it starts at step + 1 with the batches positioned as
train.py positions them, and it writes the port's torch checkpoints into
the same directory. The JAX PRNG chain is not carried: after a resume the
port's noise, jitters and batch draws are its own, as they are from the
first step (the port draws them from torch and numpy generators seeded
from --seed). Every --print_every steps one line
reports the loss and rays/s; every --render_every steps a view of the
val split (OpenCV views centrally cropped, as eval crops its test views)
is rendered through samplenerfro_torch.eval's render function (K1 in the
radiance and `ior` stages), with a jitter of its own generator's (the
train jitters are drawn ahead on the prefetch thread), and its PSNR and
SSIM printed.
The `ior` and `all` stages start from --params_npz or weights drawn from
--seed, as train.py starts them from its initialisation; eval then reads
what this writes. --seed also offsets the seeds of the batches, the
noise, the jitters and the validation renders (0 keeps train.py's).

--steps_per_dispatch=K runs K steps a dispatch, as train.py:115-128 and
181-221 do: dispatch windows align to the K grid (a resume from an
off-grid checkpoint gets one shorter first window, max_steps one shorter
last window), and --print_every, --save_every, --gc_every and
--render_every must be multiples of K. On the card each full window is
one replay of a CUDA graph of K steps (train/step.make_train_step_multi),
after a first full window run step by step; windows shorter than K run
step by step, which is bit for bit the same; on the CPU every window
does. A daemon thread assembles each window's batches (with their
annealing alpha, learning rates and jitter, drawn on the host in step
order and checked there) and copies them to the card ahead of the steps
(data/prefetch.py). --render_chunks_per_dispatch groups the validation
render's chunks (utils/render.render_image). The garbage collector runs
every --gc_every steps only, as in train.py.

Under torchrun (`torchrun --nproc_per_node=N -m samplenerfro_torch.train
...`) the run is data-parallel over the N ranks (parallel/mesh.py): each
rank draws batch_size // N rays from its own RandomState (DATA_SEED +
seed + rank, as train.py:47 seeds each process), rank 0's replicated
leaves are broadcast to every rank on this thread once the prefetch
thread hands a window over, and the step is the global batch's. Rank 0
prints and writes the checkpoints; every rank restores, then takes rank
0's weights and Adam state, and renders its share of each validation
view. The noise and jitter generators are seeded alike on every rank:
train.py:167's per-process noise key (rng + process_index) is not
reproduced, since it would make the N-rank step differ from the global
batch's step, which tests/test_multiprocess.py holds the JAX package to.

Not ported from train.py: the TPU march calibration and out-of-window
ladder (the CUDA marches have no window) and tensorboard summaries (the
card's machine has no tensorboard package).
"""

import argparse
import gc
import os
import time

import numpy as np
import torch

from samplenerfro_torch.data import datasets
from samplenerfro_torch.data import prefetch
from samplenerfro_torch.eval import build_model
from samplenerfro_torch.eval import make_render_fn
from samplenerfro_torch.models import nerf
from samplenerfro_torch.ops import march_kernel
from samplenerfro_torch.parallel import mesh
from samplenerfro_torch.train import checkpoints
from samplenerfro_torch.train import step as step_lib
from samplenerfro_torch.utils import config as config_lib
from samplenerfro_torch.utils import metrics
from samplenerfro_torch.utils import render as render_lib

DATA_SEED = 20201473   # train.py:47 seeds numpy's global state with it
GRID_SEED = DATA_SEED + 1  # a Grid beside the image batches
NOISE_SEED = 20200823  # train.py:46's PRNGKey
VAL_SEED = NOISE_SEED + 1  # the validation renders' jitters
PREFETCH = 3           # windows held ready (train.py:211, 214)
CADENCES = ("print_every", "save_every", "gc_every", "render_every")


def annealed_alpha(step, args):
  """PE annealing progress of a step (train.py:189-191), in float32."""
  return float(np.float32(max(step - args.anneal_delay_steps, 0))
               / np.float32(args.anneal_max_steps - args.anneal_delay_steps))


def dispatch_windows(init_step, max_steps, k):
  """(first, last) step of each dispatch, aligned to the K grid
  (train.py:216-221)."""
  s = init_step
  while s <= max_steps:
    e = min(max_steps, ((s - 1) // k + 1) * k)
    yield s, e
    s = e + 1


def check_cadences(args, k):
  """Raise unless each cadence is a multiple of K (train.py:115-121)."""
  for name in CADENCES:
    val = getattr(args, name)
    if k > 1 and val > 0 and val % k != 0:
      raise ValueError(f"--{name}={val} must be a multiple of "
                       f"--steps_per_dispatch={k}.")


def step_batch(host, alpha, lr, jitter, args):
  """One train step's host batch, as train/step.train_step reads it.

  Args:
    host: a dataset batch (numpy): "pixels", "rays" and "env_rays" of an
      image dataset, "pts" and "grads" of a Grid, or both.
    alpha: the step's annealing alpha.
    lr: the [groups] learning rates of its update (step.learning_rates),
      or None for a batch that only loss_fn reads.
    jitter: its coarse subsample (nerf.make_jitter), checked here; None in
      the `ior` stage, which marches nothing.
    args: flags namespace.
  """
  batch = {k: host[k] for k in ("pixels", "rays", "env_rays", "pts", "grads")
           if k in host}
  batch["annealed_alpha"] = np.float32(alpha)
  if lr is not None:
    batch["lr"] = np.asarray(lr, np.float32)
  if jitter is not None:
    batch["jitter"] = march_kernel.checked_jitter(
        jitter, args.num_coarse_samples * args.num_path_samples)
  return batch


def host_window(dataset, first, last, args, optimizer, jitter_gen,
                grid=None):
  """The stacked host batch of steps first..last: step_batch of each,
  its jitter drawn from jitter_gen in step order (none in the `ior`
  stage, whose dataset is the Grid); a batch of `grid` merged into each
  step's when given."""
  ior = args.stage.startswith("ior")
  batches = []
  for s in range(first, last + 1):
    host = dict(next(dataset))
    if grid is not None:
      host.update(next(grid))
    jitter = None if ior else nerf.make_jitter(
        args.num_coarse_samples, args.num_path_samples, jitter_gen)
    batches.append(step_batch(host, annealed_alpha(s, args),
                              step_lib.learning_rates(optimizer, s - 1),
                              jitter, args))
  return prefetch.stack(batches)


def model_grid(model, args, rng):
  """The boundary-point batches (data/datasets.Grid) of the model's IOR
  grid, from `rng`."""
  ps = model.path_sampler
  values = ps.grid[:, 0].cpu().numpy()
  return datasets.Grid(args, values, ps.spec.ndim, ps.spec.nmax,
                       ps.spec.nmin, rng)


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
                 help="seed of the initial weights, and offset of the "
                 "batch, noise, jitter and validation seeds (0: train.py's)")
  ns, rest = p.parse_known_args(argv)
  with mesh.process_group(ns.device) as device:
    return _train(ns, rest, device)


def _train(ns, rest, device):
  """main's run on `device`, as a rank of the process group if any."""
  args, cfg, bindings = config_lib.load_args(
      ns.config, ns.gin_file, ns.gin_param,
      **config_lib.parse_flag_overrides(rest))
  args.data_dir, args.train_dir = ns.data_dir, ns.train_dir
  config_lib.apply_matmul_precision(args.matmul_precision)
  datasets.check_dataset(args)
  step_lib.check_supported(args)

  k = max(1, args.steps_per_dispatch)
  check_cadences(args, k)

  model = build_model(args, cfg, bindings, ns.data_dir, device, ns.seed,
                      ns.params_npz)
  grid = None
  rank = mesh.rank()
  if args.stage.startswith("ior"):
    dataset = model_grid(model, args,
                         np.random.RandomState(DATA_SEED + ns.seed + rank))
  else:
    dataset = datasets.TrainBatches(
        args, np.random.RandomState(DATA_SEED + ns.seed + rank))
    if step_lib.needs_grid(args):
      grid = model_grid(model, args,
                        np.random.RandomState(GRID_SEED + ns.seed + rank))
  optimizer, lr_fn, _ = step_lib.create_optimizer(model, args)
  stage_dir = os.path.join(ns.train_dir, args.stage)
  os.makedirs(stage_dir, exist_ok=True)
  init_step = checkpoints.restore_checkpoint(stage_dir, model, optimizer) + 1
  mesh.broadcast_module_state(model, optimizer)
  dataset.train_it = init_step - 1
  if grid is not None:
    grid.train_it = init_step - 1
  # Alike on every rank (not train.py:167's rng + process_index): the
  # noise of a rank's rows is its rows' share of the global batch's draw.
  generator = torch.Generator(device=device).manual_seed(
      NOISE_SEED + ns.seed)
  jitter_gen = torch.Generator().manual_seed(NOISE_SEED + ns.seed)
  val_gen = torch.Generator().manual_seed(VAL_SEED + ns.seed)
  train_step = step_lib.make_train_step_multi(model, optimizer, args, k,
                                              generator)

  val = None
  if args.render_every > 0:
    val = datasets.load_split(args, "val")
  val_it = init_step // args.render_every if args.render_every > 0 else 0

  windows = list(dispatch_windows(init_step, args.max_steps, k))
  pending = iter(windows)

  def next_window():
    first, last = next(pending, (None, None))
    if first is None:
      return None
    return host_window(dataset, first, last, args, optimizer, jitter_gen,
                       grid)

  batches = prefetch.device_prefetch(next_window, device, size=PREFETCH,
                                     stacked=True)
  gc_was_enabled = gc.isenabled()
  gc.disable()
  gc.collect()
  stats_trace = []
  t_loop = time.time()
  try:
    for (_, step), batch in zip(windows, batches):
      # Rank 0's replicated leaves, on this thread (no collective may be
      # issued from the prefetch thread).
      mesh.broadcast_replicated(batch)
      # Stacked [n] Stats of the window, left on the device until printed
      # (rank 0 prints, as train.py's process 0).
      stats = train_step(batch)
      if rank == 0:
        stats_trace.append(stats)
      del batch
      if step % args.gc_every == 0:
        gc.collect()
      if step % args.print_every == 0 and rank == 0:
        trace = [s for st in stats_trace for s in st.per_step()]
        avg = lambda name: float(np.mean([getattr(s, name) for s in trace]))
        rays_per_sec = (len(trace) * args.batch_size) / (time.time()
                                                         - t_loop)
        width = int(np.ceil(np.log10(args.max_steps))) + 1
        print(f"{step:{width}d}/{args.max_steps:d}: "
              f"i_loss={trace[-1].loss:0.4f}, avg_loss={avg('loss'):0.4f}, "
              f"avg_loss_c={avg('loss_c'):0.4f}, "
              f"avg_loss_bg={avg('loss_bg'):0.4f}, "
              f"weight_l2={trace[-1].weight_l2:0.2e}, "
              f"lr={lr_fn(step):0.2e}, {rays_per_sec:0.0f} rays/sec",
              flush=True)
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
                                  args.num_path_samples, val_gen)
        view, pixels = datasets.eval_view(args, rays, images, idx)
        rgb, _, _ = render_lib.render_image(
            make_render_fn(model, jitter), view, args.dataset == "llff",
            chunk=args.chunk, device=device,
            chunks_per_dispatch=args.render_chunks_per_dispatch)
        secs = time.time() - t0
        if rank == 0:
          psnr = metrics.compute_psnr(((rgb - pixels)**2).mean())
          ssim = float(metrics.compute_ssim(rgb, pixels, 1.0))
          rays_per_sec = rgb.shape[0] * rgb.shape[1] / secs
          print(f"Eval {step}: {secs:0.3f}s., {rays_per_sec:0.0f} "
                f"rays/sec, PSNR = {psnr:.4f}, SSIM = {ssim:.4f}",
                flush=True)
        t_loop += secs
  finally:
    batches.close()
    if gc_was_enabled:
      gc.enable()
  if args.max_steps % args.save_every != 0:
    checkpoints.save_checkpoint(stage_dir, model, optimizer, args.max_steps)
  return model
