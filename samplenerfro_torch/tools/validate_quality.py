"""End-to-end training quality on the synthetic exact-ground-truth scene.

    python -m samplenerfro_torch.tools.validate_quality [--steps 2000] \
        [--batching single_image|tile] [--tile_stride 1] [--tile_images] \
        [--batch_size 1024] [--mlp_dtype float32|bfloat16] \
        [--march_interp highest|high|default] \
        [--all_steps 0] [--march_interp_all inherit|highest|high|default] \
        [--march_bwd_dtype float32|bfloat16] [--all_tag TAG] [--ipe] \
        [--seed 0] [--workdir DIR] [--skip_scene] [--device cuda]

The port's counterpart of scripts/validate_quality.py: writes the scene
(tools/synth.make_scene at its defaults) unless it exists, trains the
radiance stage for --steps through `python -m samplenerfro_torch.train`'s
main, evaluates the test views through eval's main, and prints
`RESULT <tag>: PSNR = <mean>, SSIM = <mean>`. --ipe featurizes the
samples with mip-NeRF's integrated positional encoding
(`NerfModel.use_ipe = True` in the gin file, as the JAX script writes it)
and tags the run `_ipe`. --seed seeds the weights, the batches, the
density noise and the jitters (train's and eval's --seed) and tags the
run `_s<seed>`; 0 keeps the draws of a run without it. --march_interp
trains and scores the radiance stage at that interpolation precision
(tagged `_interp-<value>`). With --all_steps the `all` stage starts from
the radiance stage's checkpoint (a copy of its directory, `all_quality`
or `all_quality_<all_tag>`, so that arms share one radiance run), trains
that many more steps with --march_interp_all and --march_bwd_dtype, and
is scored the same way, its view marched at highest as the JAX script
scores it. A finished radiance stage (its checkpoint and psnr.txt) is
reused, as the JAX script reuses it. The config is the JAX script's text
(CONFIG_YAML, GIN) without its TPU march keys; the JAX script's march
window, refetch, skip, reverse-sweep implementation and dispatch knobs
have no counterpart (utils/config.IGNORED_FLAGS).
"""

import argparse
import os
import shutil
import tempfile
import time

from samplenerfro_torch import eval as eval_lib
from samplenerfro_torch.tools import synth
from samplenerfro_torch.train import loop as train_loop

CONFIG_YAML = """\
dataset: blender
batching: {batching}
factor: 0
batch_size: {batch_size}
num_coarse_samples: 64
num_fine_samples: 128
num_path_samples: 12
use_viewdirs: true
white_bkgd: false
use_pixel_centers: true
randomized: true
max_steps: {steps}
lr_delay_steps: 500
lr_init: 0.0005
render_every: 0
save_every: {steps}
print_every: 100
sh_deg: -1
sh_direnc_deg: -1
sparsity_weight: 0.0
use_online_sparsity: false
extra_batch_size: 16
bg_weight: 0.025
bg_smooth_weight: 1.0
bg_patch_size: 64
anneal_delay_steps: 500
anneal_max_steps: {anneal_max}
net_depth: 8
net_width: 256
chunk: 8192
tile_size: 16
"""

GIN = """\
VoxMLP.interp_method = 'linear3'
VoxMLP.use_direct_output = True
VoxMLP.use_residual = True
VoxMLP.annealed = True
PathSampler.normal_radius_scale = 0.1
Config.kernel_size = 0
Config.kernel_sigma = 1.0
Config.voxel_grid = 'voxelize'
NerfModel.use_mask_bbox = False
"""

RADIANCE_STAGE = "radiance_quality"
ALL_STAGE = "all_quality"


def parse_args(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--steps", type=int, default=2000)
  p.add_argument("--batch_size", type=int, default=1024)
  p.add_argument("--batching", default="single_image",
                 choices=["single_image", "tile"])
  p.add_argument("--tile_stride", type=int, default=1,
                 help="pixel stride inside each training tile")
  p.add_argument("--tile_images", action="store_true",
                 help="sample each training tile from an independent image")
  p.add_argument("--mlp_dtype", default="float32",
                 choices=["float32", "bfloat16"])
  p.add_argument("--all_steps", type=int, default=0,
                 help="after the radiance stage, train the 'all' stage "
                 "from its checkpoint for this many more steps")
  p.add_argument("--march_interp", default="highest",
                 choices=["highest", "high", "default"],
                 help="the marches' interpolation precision")
  p.add_argument("--march_interp_all", default="inherit",
                 choices=["inherit", "highest", "high", "default"],
                 help="the 'all' stage's training interpolation (its eval "
                 "marches at highest)")
  p.add_argument("--march_bwd_dtype", default="float32",
                 choices=["float32", "bfloat16"],
                 help="the 'all' stage's reverse sweep (and so3 head) arm")
  p.add_argument("--all_tag", default="",
                 help="suffix of the 'all' stage's directory, so that "
                 "several arms share one radiance checkpoint")
  p.add_argument("--workdir",
                 default=os.path.join(tempfile.gettempdir(),
                                      "samplenerfro_quality"))
  p.add_argument("--skip_scene", action="store_true",
                 help="do not write the scene, even where it is missing")
  p.add_argument("--ipe", action="store_true",
                 help="mip-NeRF IPE featurization (NerfModel.use_ipe)")
  p.add_argument("--seed", type=int, default=0,
                 help="seed of the weights, batches, noise and jitters")
  p.add_argument("--device", default=None, help="cuda (default) or cpu")
  return p.parse_args(argv)


def run_tag(args):
  tag = args.batching
  if args.batch_size != 1024:
    tag += f"_b{args.batch_size}"
  if args.mlp_dtype != "float32":
    tag += f"_{args.mlp_dtype}"
  if args.tile_stride != 1:
    tag += f"_ts{args.tile_stride}"
  if args.tile_images:
    tag += "_timg"
  if args.ipe:
    tag += "_ipe"
  if args.march_interp != "highest":
    tag += f"_interp-{args.march_interp}"
  if args.seed:
    tag += f"_s{args.seed}"
  return tag


def write_config(args, cfg_base):
  """The run's flag overlay and gin file at <cfg_base>.yaml / .gin. The
  annealing window grows with the budget; runs of up to 2000 steps keep
  the JAX anchors' schedule."""
  anneal_max = max(2000, int(0.8 * args.steps))
  with open(cfg_base + ".yaml", "w") as f:
    f.write(CONFIG_YAML.format(batching=args.batching, steps=args.steps,
                               batch_size=args.batch_size,
                               anneal_max=anneal_max))
    f.write(f"mlp_dtype: {args.mlp_dtype}\n")
  with open(cfg_base + ".gin", "w") as f:
    f.write(GIN)
    if args.ipe:
      f.write("NerfModel.use_ipe = True\n")


def _read(pth):
  with open(pth) as f:
    return float(f.read())


def main(argv=None):
  """Returns {stage: {"psnr", "ssim", "train_s", "eval_s"}} of the stages
  this run trained or scored."""
  args = parse_args(argv)
  os.makedirs(args.workdir, exist_ok=True)
  data_dir = os.path.join(args.workdir, "scene")
  if not args.skip_scene and not os.path.exists(
      os.path.join(data_dir, "transforms_train.json")):
    print("generating synthetic scene...", flush=True)
    t0 = time.time()
    synth.make_scene(data_dir, device=args.device)
    print(f"scene written in {time.time() - t0:.1f} s", flush=True)

  tag = run_tag(args)
  cfg_base = os.path.join(args.workdir, f"cfg_{tag}")
  write_config(args, cfg_base)
  train_dir = os.path.join(args.workdir, f"logs_{tag}")
  common = [f"--data_dir={data_dir}", f"--train_dir={train_dir}",
            f"--config={cfg_base}", f"--gin_file={cfg_base}.gin",
            f"--tile_stride={args.tile_stride}",
            f"--tile_images={str(args.tile_images).lower()}",
            f"--seed={args.seed}", f"--march_interp={args.march_interp}"]
  if args.device is not None:
    common.append(f"--device={args.device}")

  results = {}

  def run(stage, train_extra, eval_extra):
    t0 = time.time()
    print(f"running train ({stage}) ...", flush=True)
    train_loop.main(common + [f"--stage={stage}"] + train_extra)
    t1 = time.time()
    print(f"running eval ({stage}) ...", flush=True)
    res = eval_lib.main(common + [f"--stage={stage}", "--eval_once=true"]
                        + eval_extra)
    results[stage] = {"psnr": float(sum(res.psnrs) / len(res.psnrs)),
                      "ssim": float(sum(res.ssims) / len(res.ssims)),
                      "train_s": t1 - t0, "eval_s": time.time() - t1}
    print(f"{stage}: train {t1 - t0:.1f} s, eval "
          f"{results[stage]['eval_s']:.1f} s", flush=True)

  preds = os.path.join(train_dir, RADIANCE_STAGE, "test_preds")
  ckpt = os.path.join(train_dir, RADIANCE_STAGE, f"checkpoint_{args.steps}")
  if os.path.exists(os.path.join(preds, "psnr.txt")) and os.path.exists(ckpt):
    print(f"radiance stage complete ({ckpt}); skipping to all stage",
          flush=True)
    results[RADIANCE_STAGE] = {"psnr": _read(os.path.join(preds, "psnr.txt")),
                               "ssim": _read(os.path.join(preds, "ssim.txt")),
                               "train_s": None, "eval_s": None}
  else:
    run(RADIANCE_STAGE, [],
        [f"--gin_param=Config.radiance_weight_name='{RADIANCE_STAGE}'"])
  r = results[RADIANCE_STAGE]
  print(f"RESULT {tag}: PSNR = {r['psnr']}, SSIM = {r['ssim']}", flush=True)

  if args.all_steps > 0:
    # The 'all' stage resumes from a copy of the radiance stage's
    # directory; max_steps extends past the radiance budget.
    all_stage = ALL_STAGE + (f"_{args.all_tag}" if args.all_tag else "")
    all_dir = os.path.join(train_dir, all_stage)
    if not os.path.exists(all_dir):
      shutil.copytree(os.path.join(train_dir, RADIANCE_STAGE), all_dir)
      shutil.rmtree(os.path.join(all_dir, "test_preds"), ignore_errors=True)
    total = args.steps + args.all_steps
    steps = [f"--max_steps={total}", f"--save_every={total}",
             f"--march_bwd_dtype={args.march_bwd_dtype}"]
    run(all_stage, steps + [f"--march_interp_all={args.march_interp_all}"],
        steps + [f"--gin_param=Config.all_weight_name='{all_stage}'",
                 "--march_interp_all=highest"])
    r = results[all_stage]
    print(f"RESULT {tag} all-stage(+{args.all_steps}): PSNR = {r['psnr']}, "
          f"SSIM = {r['ssim']}", flush=True)
  return results


if __name__ == "__main__":
  main()
