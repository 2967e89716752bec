"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed N] [--profile]

--profile adds torch.profiler tables: one K3 call at the ship and at
glass's shape (its split over its launches), one render chunk and one
radiance train step with the nn.Linear MLPs and again with the fused MLP
(K4/K5), and one 'all' train step, each with its total device time.
The march inputs and their digests come from
samplenerfro_torch.debug.march_parity, which also runs alone, and in an
earlier checkout, to compare K1 and K2 across trees.

Phases, each of which must pass or the script exits non-zero:
  1. device: a CUDA card is required; prints its name and power limit.
  2. build: compiles every kernel under samplenerfro_torch/ops/csrc, and
     K4 with its tensor-core trial switch (the F2 count below), one nvcc
     per source, all started together. P1 (x + 1) must then come back
     exact; P2 (sinf at argument scales 1 to 2048) within 1e-6 of float64.
     Each is timed with its host call (CUDA events around the Python call)
     and by device time alone (a CUDA graph of 100 launches), beside x + 1
     and torch.sin timed the same two ways.
     Then the selfcheck: samplenerfro_torch.train.selfcheck.check_march at
     its defaults (the JAX gate's 128^3 blob, 512 rays of 768 steps, the
     'all' arm on 256 rays of 192 steps, the so3 head at ship width 4x128);
     K1, K2 and K3 must each launch, every deviation inside its envelope
     (forward 2e-3, gradients 5e-3, loss 1e-4 of scale), and K2 with the
     head off at march_interp "default" within the JAX gate's bf16
     envelope (0.05 of scale). Then P3 (the so3
     head's pre-activations summed as K3 sums them) against its plain
     version (cuBLAS) at the probe's 49,152 points, with the ReLU masks the
     two set apart, and the probe's own path (samplenerfro_torch.debug.
     probe_so3_relu.probe), which must launch P3 once.
  3. model: the ship configuration (configs/tpu/ship_*.yaml + .gin) at full
     width with weights drawn from --seed, on a synthetic 512^3 IOR blob
     grid prefiltered 9/3 on the card.
  3b. forward marches: K1 and K2 at every shape this script runs them at
     (K1: the render's first 8192-ray chunk, the 1024-ray radiance batch,
     glass's shape at 1024 rays and at an 8192-ray render chunk (the
     real-scene validation render's), ball's (256^3 grid, 1536 steps) at
     1024 and 8192 rays, the self-check's 512 rays; K2: the 1024-ray 'all'
     batch, glass's shape at 1024 rays and at an 8192-ray render chunk (the
     real-scene eval's), the self-check's 512 x 768 and 256 x 192): a sha256
     digest of the outputs, the max abs error against the plain version,
     held at K1_ATOL or K2_ATOL (the arclength of 1536-step marches
     relative, as K2's at glass in 4),
     the call's time (CUDA events) and the kernel's device time alone
     (torch.profiler), the launch geometry. Then one march_lean and one
     march_full call under torch.cuda.set_sync_debug_mode("error"):
     neither may read back from the card. Then K2 with the so3 head off
     (march_full_plain, K1's template with the full emit) the same way at
     one ray of the ship's march (extract_mesh's path dump), the ship's
     radiance batch (a train step with online sparsity), synth's
     ground-truth chunk (8192 rays x 768 steps, its 64^3 grid), glass's
     shape and ball's 8192-ray chunk, held at K2_ATOL (the arclength of
     1536-step marches relative), with its bound (the bytes it writes,
     B x S x 44, and reads); and its positions, directions and arclength
     against K1's dense outputs at the 1024-ray radiance batch, bit for
     bit.
  4. kernels: each kernel against its plain PyTorch version on the card, at
     the shapes its path gives it, timed beside its bound: K1 at the
     render's first 8192-ray chunk; K2 (so3 march) and K3 (its reverse
     sweep) at a 1024-ray training batch, with so3 weights drawn from
     --seed at output std 1e-2 so that the head bends the paths; P3 at
     that batch's active ray-steps, the points K3 recomputes. K4 (the
     fused NerfMLP forward) in fp32, fed with features and with raw samples
     (pe), at the render's first chunk's fine call, and in bf16 at a
     training batch's fine call; K5 (its parameter backward) in bf16 and
     fp32 at that call, twice, bit for bit, after a stage-by-stage
     comparison of the bf16 K5 with its plain version and of both with a
     float64 twin (debug/mlp_rounding.stage_report, printed, not a
     gate) and the count of activations where K4 and K5's recompute
     differ (fault F2: must be 0; with K4 on tensor cores, printed). Each
     timed with its weights packed (as the path packs them once a step)
     and as a call that packs them, with its TFLOP/s and share of its
     bound, beside the time of the port's nn.Linear stack for the same
     work (unfused); K5 with the bytes its partial and scratch move. Then
     K1, K2 and K3 again at glass's shape (configs/tpu/glass.*: 1536 march
     steps on a 384^3 grid), and K4/K5 in fp32 and bf16 at the geometries
     past the ship MLP's that supports admits (fault F1: widths 384, 512,
     1024, pe with max_deg_point 16) on 4,096 random rows.
  5. render path: one 256x256 view rendered through samplenerfro_torch.eval's
     render function (8 chunks of 8192 rays); K1 must have been launched
     once per chunk. Then the same view with --mlp_kernel=pallas and
     pallas_pe: K4 twice per chunk, K5 never, colours and opacity within
     1e-4 of the nn.Linear render.
  6. train path: radiance steps, then 'all' steps, through
     samplenerfro_torch.train.step.train_step (what `python -m
     samplenerfro_torch.train` calls) on a repeated synthetic 1024-ray
     batch with a 128x128 env-ray patch, bf16 MLPs, as a run resumed at
     step 80000 takes them. Losses and gradients must be finite, the
     radiance loss must fall, the so3 gradients must be non-zero, and K1
     must run once per radiance step, K2 and K3 once per 'all' step. Then
     radiance steps with --mlp_kernel=pallas (bf16): K4 and K5 twice a
     step, the loss falling; and 'all' steps with the flag set, which must
     launch neither (the 'all' stage keeps nn.Linear).
  6b. dispatch: each stage of the ship configuration at full width from
     step 80000 (the annealing alpha non-zero and changing every step),
     30 steps through train.step.make_train_step_multi one at a time and
     10 a dispatch (its steps_per_dispatch: an eager window, then a CUDA
     graph of 10 steps captured and replayed twice), on distinct seeded
     batches through data/prefetch.py, from the same weights, jitters and
     generator seeds. Every Stats field of every step, every parameter,
     Adam moment and count must be equal bit for bit; the wrappers must
     count K1 (radiance), K2 and K3 ('all') once a step run in Python
     (at K=10: the eager window and the capture), and a replay after
     them, traced by torch.profiler, must launch each 10 times, as 10
     eager steps traced the same way do (up to 3 windows are traced, one
     at a time, since the profiler can drop a record; none may show more).
     Prints the steps/s of steps 21-30 (K=10: a replay) and the device ms
     a step of the last traced window both ways, with the card's name and
     power limit.
  7. CPU cross-checks: 256 rays of the view rendered on the CPU (the plain
     march) against the card; one 'all' step's loss and so3 gradients on
     128 rays, fp32 MLPs, on the CPU (plain K2 and K3) against the card,
     with P3's count of the ReLU masks the two set apart, and the plain
     versions on the card against both (printed, not a gate);
     one fused radiance step's loss and MLP gradients on 128 rays, fp32,
     on the CPU (plain K1, K4, K5) against the card, the CPU replaying the
     card's paths, samples and the ReLU masks of K4's activations.
  8. real-scene path: glass's shipped configuration (configs/tpu/glass.*:
     batch 1024 in 16x16 tiles, 128x128 env patch, 64 + 128 samples,
     64x24 = 1536 march steps, far 14, prefilter 5/3, bf16 training MLPs,
     the boundary cut) at full width on a synthetic OpenCV capture
     (debug/real_scene.py: 8 train views, one val, one test, 320x240, an
     off-centre principal point, a 384^3 blob of extent 3.5 that fills
     the view), written to a
     temporary directory, through the entry points, at its shipped
     dispatch (10 steps a dispatch, 4 render chunks a dispatch):
     train.loop.main --stage=radiance for 20 steps with one validation
     render, --stage=all for 20 steps (each stage an eager window, then a
     replayed one), then eval.main --stage=all on the test view. Losses and
     so3 gradients must be finite and the so3 gradients non-zero (the
     capture's object fills the view; the gradients checked after each
     eager step and after each replay), the checkpoints written, eval's PSNR and
     SSIM equal to those of the model train returned rendered here on the
     same view with the same seeded jitter (eval read the checkpoint), and
     that render bit for bit the same view rendered one chunk a call, the
     cut's mask neither all ones nor all zeros over the view, and K1, K2
     and K3 launched through their wrappers as the steps run in Python
     (eager and captured) and the chunks imply. Between the two
     stages, one radiance step of the trained model on a train batch at
     annealed alpha 0.5, its density lowered (sigma_bias -4) so that the
     cut's transmittance passes 0.5 and the background loss counts, on the
     card and on the CPU (plain K1), fp32 MLPs: loss and loss_bg to 1e-4
     relative, loss_bg > 0, the same rays over trans 0.5, bkgd_mlp's
     gradients at the K5 fp32 tolerance.
  9. the Quickstart (README.md) through the port's entry points, on a copy
     of example_data in a temporary directory: voxelize_mesh with the
     README's flags (128^3 voxels x 4^3 containment queries on the host;
     mesh.pkl's values in [1, 1.33], its occupied fraction at 1.165 within
     10% of the icosphere's volume share of the (2 x 1.5)^3 box), 200
     `radiance` steps of configs/example.* at full width (factor 2:
     400x400 views), eval of the test view (its PSNR and SSIM those of the
     returned model on that view; the colour, disp and depth-suite PNGs
     written), then extract_mesh at resolution 128, range 1.2 and a
     threshold the trained density crosses (the 99th percentile of the
     alpha of a 33^3 lattice): the debug view (K1), the path dump of S
     vertices (K2 with the head off, one launch), a surface with faces.
     Prints each step's seconds and the density query's points/s.
  10. the first quality figure: tools/synth.make_scene at its defaults (16 /
     2 / 2 views of 128^2, a 64^3 grid, 768 steps; its ground truth marched
     by the head-off kernel, 40 launches), then 2000 `radiance` steps with
     single_image batching and fp32 MLPs through tools/validate_quality and
     eval of the 2 test views: the test PSNR must reach 29.5 dB, 1 dB under
     the JAX package's 30.49 dB for that budget and batching.
  11. the `ior` stage at ship width (phase 6b's model, its 512^3 grid;
     the so3 head 4x128; the shipped extra_batch_size 16): the Grid
     (data/datasets.Grid) built on the host from the model's grid, timed;
     30 steps from step 80000 at K=1 and at K=10 (a CUDA graph) on the
     same Grid batches, offsets and weights, with weight_decay_mult 0 as
     shipped (every parameter and Adam moment bit for bit where it
     started, loss_nrm 0) and 1e-2 (the so3 head moves, the radiance MLPs
     do not, K=1 and K=10 bit for bit); no march kernel launches; steps/s
     of the last 10 and the device ms a step of 10 more, traced. Then the
     ungated smoothness and its so3 gradients on a Grid batch, card
     against CPU (the value within 1e-6 of its terms' size; the
     gradients printed against the K3 form per tensor, not held), and
     the val render the loop runs at --render_every, in the `ior` stage,
     of the ship view: K1 once per chunk.
  12. LLFF: a forward-facing capture (debug/llff_scene.py: 16 views of
     160x136 in images_2, a 128^3 blob) in the ship configuration at full
     width with --dataset=llff (NDC rays, near 0, far 1) through the
     entry points: train.loop.main --stage=radiance for 20 steps at K=10
     with a val render, --stage=ior for 20 steps with a val render, eval
     --render_path=True of the radiance stage (the 120-frame spiral into
     path_renders/, five images a frame, no score file), eval of the
     `ior` stage's test views; K1 as the steps and chunks imply; eval
     --render_path=True on a Blender scene must raise ValueError.
  13. the model options that no shipped config turns on, at ship width
     (run after phase 11, on its scene): each of OPTION_PATHS (radiance
     with online sparsity; with IPE on nn.Linear and on the fused MLP;
     with SH colour and SH direction encoding; with SH direction encoding
     on the fused MLP; 'all' with IPE and online sparsity; 'all' with
     online sparsity) for 30 steps from step 80000 at K=1 and K=10 as
     phase 6b runs them, bit for bit between the two, with steps/s and
     device ms a step: K2 with the head off must run each online-sparsity
     radiance step and K1 none, by wrapper and in a traced window; K4 and
     K5 twice a fused step; with online sparsity gated at 0 (the
     annealing rate), as shipped, every parameter and Adam moment of each
     stage's 30 steps bit for bit phase 6b's. The radiance batch's coarse
     subsample from K2 with the head off gathered at the jitter against
     K1's in-kernel one (bit for bit, or within K1_ATOL with the largest
     difference per channel printed); K4 and K5 at IPE's 60 features and
     the SH direction encoding's 16 condition values against their plain
     versions (K4 fp32 and bf16, K5 bf16 and fp32, twice, bit for bit);
     one 'all' step with the spherical residual head on the plain march
     under autograd (no K1, K2 or K3 launch), its loss card against CPU
     on 128 rays at 1e-4 relative (its so3 gradients printed against the
     K3 form, not held: no port kernel on that path).
  14. flax checkpoints (run after phase 13, before phase 7's CPU
     cross-check moves the ship model to the CPU), with none of flax,
     orbax, msgpack, tensorstore or a zstd package: (1) the JAX-written fixture (debug/flax_fixture.py: a
     narrow ship model's TrainState after 3 radiance steps as an orbax
     OCDBT directory and as a legacy msgpack file, and its params in the
     reference layout) restored with the port's readers and its libzstd
     binding, every leaf bit for bit the leaves.npz the JAX package wrote;
     (2) the ship model at full width (the so3 head included) exported as
     a reference-layout msgpack checkpoint (train/flax_checkpoints.py),
     stage-loaded for `all` into a copy whose weights were moved
     (checkpoints.load_stage_weights: every tensor equal, the step
     returned), and rendered: the view's digest and a K2 march's equal the
     source model's; (3) the fixture's orbax state resumed in a stage
     directory (checkpoints.restore_checkpoint: Adam's counts 3) for one
     window of 10 radiance steps at K = 10: the counts 13, every loss
     finite, K1 once a step, the port's torch checkpoint_13 written beside
     the orbax checkpoint_3, which keep=1 then prunes. Prints one
     flax_ckpt line (its checks and seconds).
  15. data parallelism (parallel/mesh.py; run after phase 13, on its
     scene): (i) phase 6b's dispatch (both stages, 30 steps at K=10 from
     step 80000, then its traced replays) as rank 0 of an NCCL group of
     world 1 that parallel/mesh.process_group makes from torchrun's
     variables, the gradients' all-reduce and the Stats' captured in the
     graph: every Stats field, parameter and Adam moment bit for bit phase
     6b's, the launches as there, steps/s beside phase 6b's; (ii) two
     ranks of debug/dist_worker.py on the one card over gloo with CUDA
     tensors (NCCL refuses two ranks on one device), each 4 radiance and
     4 'all' steps of the ship model at K=1 on its 512 rays of each
     1024-ray batch, the radiance batch's forward and the 256x256 view
     split across the ranks, against one process on the whole batches:
     Stats within 1e-6 relative, every gradient per tensor at K3's form,
     the view within 1e-6, both ranks' states equal bit for bit, each
     rank's K1/K2/K3 launches as its steps and chunks imply; prints
     whether the forward rows are bit for bit, and the seconds.
  16. the shipped configs' reduced-precision arms (ops/precision.py): the
     ship configuration as shipped, march_interp "default" and
     march_bwd_dtype "bfloat16" (every phase before it runs the shipped
     configs pinned to march_interp "highest" and march_bwd_dtype
     "float32", FP32_ARMS, so that their digests and gates stand as they
     were). Each reduced arm's kernel against its plain version of the
     same arm at the ship shapes (debug/precision_arms.py): K1 and K2 with
     the head off at "default" on the render chunk (8192 rays) and the
     1024-ray batch, at K1_ATOL; K2 with its bf16 head at the 'all' batch
     and the render chunk, every step at K2_ATOL teacher-forced (one plain step from each of
     the kernel's states) and the free-running march within the JAX
     self-check's bf16 envelope (0.05 of scale); K3's bf16 arm on the
     plain march's trajectory against march_bwd_passes_reference's bf16
     arm with the ReLU flips of P3's bf16 arm replayed, per tensor at
     2e-3 x max|want|, and bit for bit across two runs; each timed with
     its kernel's device time (K3's split over its five kernels), its
     plain version's and its bound (the so3 head's products, bf16
     operands summed in fp32, at the dense bf16 tensor-core rate: K2's
     forward, K3's three). Then the path as shipped: each stage's 30 steps
     at K = 1 and at its K = 10 (a CUDA graph), bit for bit, with steps/s
     and device ms a step; the radiance stage with online sparsity on (K2
     with the head off at "default", where a shipped config's user runs
     it) at K = 10; and the 256x256 view (beside the same view at
     "highest"). Every reduced arm's kernel must launch on these paths and
     no fp32 arm may.
The last two lines are the kernel report and {"ok": true, "device": ...}.
"""

import argparse
import copy
import dataclasses
import json
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch
from PIL import Image

from samplenerfro_torch import eval as eval_lib
from samplenerfro_torch import extract_mesh
from samplenerfro_torch import voxelize_mesh
from samplenerfro_torch.data import datasets
from samplenerfro_torch.data import prefetch
from samplenerfro_torch.data import rays as rays_lib
from samplenerfro_torch.debug.march_parity import BALL
from samplenerfro_torch.debug.march_parity import GLASS
from samplenerfro_torch.debug.march_parity import RES
from samplenerfro_torch.debug.march_parity import SO3_ALPHA
from samplenerfro_torch.debug.march_parity import TRAIN_FROM
from samplenerfro_torch.debug.march_parity import card_name
from samplenerfro_torch.debug.march_parity import cuda_ms
from samplenerfro_torch.debug.march_parity import digest
from samplenerfro_torch.debug.march_parity import glass_inputs
from samplenerfro_torch.debug.march_parity import kernel_device_ms
from samplenerfro_torch.debug.march_parity import kernel_launches
from samplenerfro_torch.debug.march_parity import march_call
from samplenerfro_torch.debug.march_parity import march_cases
from samplenerfro_torch.debug.march_parity import march_report
from samplenerfro_torch.debug.march_parity import scene_grid
from samplenerfro_torch.debug.march_parity import scene_rays
from samplenerfro_torch.debug.march_parity import ship_inputs
from samplenerfro_torch.debug.march_parity import ship_model
from samplenerfro_torch.debug.march_parity import so3_params_for
from samplenerfro_torch.debug.march_parity import step_device_us
from samplenerfro_torch.debug.march_parity import synthetic_batch
from samplenerfro_torch.debug import dist_worker
from samplenerfro_torch.debug import flax_fixture
from samplenerfro_torch.debug import llff_scene
from samplenerfro_torch.debug import mlp_rounding
from samplenerfro_torch.debug import precision_arms
from samplenerfro_torch.debug import probe_so3_relu
from samplenerfro_torch.debug import real_scene
from samplenerfro_torch.eval import make_render_fn
from samplenerfro_torch.models import convert
from samplenerfro_torch.models import mlp as mlp_modules
from samplenerfro_torch.models import nerf
from samplenerfro_torch.models.path_sampler import SO3_MAX_DEG
from samplenerfro_torch.ops import cuda_build
from samplenerfro_torch.ops import eikonal_vjp
from samplenerfro_torch.ops import grid as grid_ops
from samplenerfro_torch.ops import march_kernel
from samplenerfro_torch.ops import math as math_ops
from samplenerfro_torch.ops import mlp_kernel
from samplenerfro_torch.ops import render as render_ops
from samplenerfro_torch.parallel import mesh
from samplenerfro_torch.tools import objio
from samplenerfro_torch.tools import synth
from samplenerfro_torch.tools import validate_quality
from samplenerfro_torch.train import checkpoints
from samplenerfro_torch.train import flax_checkpoints
from samplenerfro_torch.train import loop as train_loop
from samplenerfro_torch.train import selfcheck
from samplenerfro_torch.train import step as step_lib
from samplenerfro_torch.train.loop import annealed_alpha
from samplenerfro_torch.train.loop import step_batch
from samplenerfro_torch.utils import config as config_lib
from samplenerfro_torch.utils import metrics
from samplenerfro_torch.utils import probes
from samplenerfro_torch.utils import render as render_lib

MARCH_KERNEL = "samplenerfro_tpu/ops/pallas/march_kernel.py:248"
MLP_KERNEL = "samplenerfro_tpu/ops/pallas/mlp_kernel.py"
HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12                   # H100 SXM fp32 outside tensor cores
BF16_TC_FLOPS = 989e12               # H100 SXM dense bf16 tensor cores,
                                     # NVIDIA data sheet
# K1 (fp32, FMA contraction off in both versions) against its plain
# version over 768 Euler steps: the only differences left are the order
# of the 3-term sums, a few ulp that the march carries forward.
K1_ATOL = 1e-4
# Whole render, card against CPU: cuBLAS and the CPU BLAS sum the MLP
# products in different orders (fp32, no TF32) and the march differs by
# the ulps above; a fine sample may move by those, so colours and opacity
# agree to ~1e-5 and are held at 1e-4.
XCHECK_ATOL = 1e-4
# K2 against its plain version: the march as K1, plus the so3 MLP, whose
# products K2 sums in its own order (fp32 FMA, no TF32) where cuBLAS sums
# in another; the refined gradient differs by ~1e-7 relative a step, and
# 768 steps carry that forward. Held at K1's 1e-4.
K2_ATOL = 1e-4
# The arclength sums |p_s - p_s+1|, whose 3-term sum the plain version
# rounds in another order: a last-ulp difference in a step's length can
# move the running sum by an ulp of its value, and over 1536 steps
# (glass's and ball's marches) these walk past K1_ATOL (K1 at ball's 8192
# rays: 1.45e-4, with every position bit for bit the plain version's, on
# NVIDIA H100 80GB HBM3, chip_smoke.py). On marches that long the
# arclength is held at the tolerance of its largest value.
LONG_MARCH = 1536
# K3 against autograd of the plain march: the JAX package's own tolerance
# for its reverse sweep (tests/test_eikonal_vjp.py:108-111), per tensor:
# |got - want| <= 2e-4 * max|want| + 2e-3 * |want|.
K3_ATOL_SCALE, K3_RTOL = 2e-4, 2e-3
N_RADIANCE, N_ALL = 12, 4
N_ALL_FUSED = 2  # 'all' steps with --mlp_kernel=pallas, which keep nn.Linear
# The dispatch phase: each stage's first N_DISPATCH steps from TRAIN_FROM
# one at a time and K (the ship configuration's steps_per_dispatch) a
# dispatch, held bit for bit; then windows of K steps each way under
# torch.profiler (up to TRACE_TRIES) for the launches and the device time
# of a step.
N_DISPATCH = 30
# Every phase before the shipped-arms phase (16) runs the shipped configs
# in the fp32 arms they were written and gated for (march_interp highest,
# march_bwd_dtype float32), so that honouring the shipped flags moves none
# of their digests; phase 16 runs the configs as shipped.
FP32_ARMS = {"march_bwd_dtype": "float32", "march_interp": "highest"}
FP32_FLAGS = [f"--{k}={v}" for k, v in FP32_ARMS.items()]
# The real-scene path: glass's shipped configuration on a synthetic OpenCV
# capture of 8 train views (and one val, one test view) of 320x240; its
# K = 10 steps a dispatch, so each stage's second window is a replay.
GLASS_CONFIG = "configs/tpu/glass"
N_REAL_RADIANCE, N_REAL_ALL = 20, 20
# The Quickstart (README.md): example_data voxelized with the README's
# flags, then `radiance` steps with configs/example.* at full width
# (factor 2: 400x400 views), eval, and extract_mesh at this resolution.
EXAMPLE_CONFIG = "configs/example"
VOXELIZE_FLAGS = ["--num_samples=4", "--num_voxels=128", "--extent=1.5",
                  "--threshold=1.165"]
N_QUICK_STEPS = 200
EXTRACT_RESOLUTION, EXTRACT_RANGE = 128, 1.2
EXTRACT_PERCENTILE = 99
# The icosphere's volume share of the (2 * 1.5)^3 box: the voxelized
# grid's occupied fraction at the threshold is held within this relative
# distance of it.
OCCUPIED_RTOL = 0.1
# The first quality figure: 2000 radiance steps, single_image batching,
# fp32 MLPs on the synthetic exact-ground-truth scene; the JAX package's
# anchor for the same budget and batching is 30.49 dB (STATUS.md:398-405),
# and the port is held 1 dB under it.
N_QUALITY_STEPS = 2000
QUALITY_MIN_PSNR = 29.5
XCHECK_RAYS = 128
# One 'all' step, card against CPU, fp32 MLPs, not randomized: the loss to
# 1e-4 relative (K1's and K2's ulps moved through the MLPs), the so3
# gradients at the K3 tolerance.
XCHECK_LOSS_RTOL = 1e-4
# The real-scene cross-check's annealing progress: past anneal_delay_steps,
# where the background losses count (train/step.py's gate).
CUT_ALPHA = 0.5
# A barely trained model's density, softplus(raw - 1) ~ 0.3 over the ~10
# units of path inside glass's box, leaves the cut's transmittance at ~0.04
# on every ray, and trans > 0.5 selects none: at a sigma_bias of -4 the
# density is ~0.02 and every ray passes 0.5, so the background loss counts.
CUT_SIGMA_BIAS = -4.0
# P2: CUDA documents sinf at 2 ulp, <= 1e-6 of a value in [-1, 1] at these
# arguments.
P2_ATOL = 1e-6
# The ior stage (phase 11): N_IOR steps from TRAIN_FROM a run, each way,
# then a traced window of IOR_SPAN steps; the second run of each way at
# this weight decay (the shipped configs set 0). The ungated smoothness,
# card against CPU, within SMOOTH_TOL of the size of its terms.
N_IOR, IOR_SPAN = 30, 10
IOR_WEIGHT_DECAY = 1e-2
SMOOTH_TOL = 1e-6
# The LLFF path (phase 12): a forward-facing capture of LLFF_VIEWS views,
# N_LLFF radiance and N_LLFF ior steps at the ship's K, each a capture
# and a replay.
LLFF_VIEWS, N_LLFF = 16, 20
# The flax checkpoint phase (14): the committed fixture's radiance state
# resumed for one dispatch window of FLAX_K steps on a FLAX_GRID_N^3 grid.
FLAX_K, FLAX_GRID_N = 10, 128
# The data-parallel phase (15): phase 6b's dispatch through an NCCL group
# of world 1; then two gloo ranks on the one card (NCCL refuses two ranks
# on one device), N_PARALLEL radiance and N_PARALLEL 'all' steps at K = 1
# and one view, against one process on the whole batches: Stats at
# PARALLEL_STATS_RTOL, gradients at K3's form, the view within
# PARALLEL_RENDER_ATOL. The held steps compute the MLPs in fp32: in bf16
# each rank's partial weight gradient is rounded to bf16 before the
# all-reduce (the single process rounds the whole sum once), which moves
# a gradient whose partials cancel by ~2^-8 of their size, past K3's
# form (6.2x on the CPU at the tests' size); the ship's bf16 radiance
# steps are run and printed beside them.
N_PARALLEL = 4
PARALLEL_STATS_RTOL = 1e-6
PARALLEL_RENDER_ATOL = 1e-6
PARALLEL_TIMEOUT_S = 300
# P3 against its plain version, max abs error over the largest
# |pre-activation|: both sum the same fp32 products, in other orders.
P3_ATOL = 1e-5
# K4 against its plain version. fp32: both sum fp32 products, in other
# orders (cuBLAS without TF32 for the plain version). bf16: the products
# are exact on both sides; a sum in another order can round a
# pre-activation to the other bf16 neighbour, which later layers carry (up
# to 1.3e-3 in one row, 6.6e-6 in the mean: tests/test_torch_mlp_kernel.py).
K4_FP32_ATOL = 1e-5
K4_BF16_MAX, K4_BF16_MEAN = 4e-3, 3e-5
# K5 against its plain version, per tensor: fp32 at the K3 form
# |got - want| <= 2e-4 * max|want| + 2e-3 * |want| (summation order, and
# in the card-vs-CPU check the march's ulps carried through the encoding);
# bf16 at 2e-3 * max|want| (an ulp-rounded cotangent or a ReLU mask at 0
# moves one row's contribution).
K5_ATOL_SCALE, K5_RTOL = 2e-4, 2e-3
K5_BF16_SCALE = 2e-3
# K4's and K5's device time: a CUDA graph of this many calls with the
# weights packed (torch.profiler recorded no mlp_fwd_kernel launch in four
# windows of K4 at the render's fine call, NVIDIA H100 80GB HBM3).
MLP_GRAPH_CALLS = 5


def log(msg):
  print(msg, flush=True)


def graph_ms(fn, count=100, reps=3):
  """Device milliseconds of one fn(): a CUDA graph of `count` calls, so no
  host time sits between the launches, replayed `reps` times after a
  warm-up (median)."""
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    fn()
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    for _ in range(count):
      fn()
  graph.replay()
  torch.cuda.synchronize()
  times = []
  for _ in range(reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    times.append(start.elapsed_time(end) / count)
  return float(np.median(times))


def device_phase():
  if not torch.cuda.is_available():
    raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                     "is false)")
  card = card_name()
  log(f"card: {card}")
  log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
      f"{torch.cuda.device_count()} device(s)")
  return card


def build_phase():
  """Every kernel, and K4 with its tensor-core trial switch (the F2
  measurement's before), one nvcc each, all started together."""
  t0 = time.time()
  logs = cuda_build.build(cuda_build.kernel_names(),
                          also=[("mlp_fwd", (mlp_rounding.K4_TENSOR,))])
  log(f"build: {time.time() - t0:.1f} s for {cuda_build.kernel_names()} and "
      f"mlp_fwd with {mlp_rounding.K4_TENSOR}")
  for (name, defines), out in logs.items():
    for line in out.splitlines():
      if "registers" in line or "spill" in line or "smem" in line:
        log(f"  {name}{' ' + ' '.join(defines) if defines else ''}: "
            f"{line.strip()}")


def distinct_voxels(spec, pos):
  """Grid voxels the trilinear gathers at these path vertices touch."""
  nmin, ndelta = spec.axis_tensors(pos.device)
  hi = torch.tensor(spec.ndim, device=pos.device) - 1
  c0 = torch.floor((pos.reshape(-1, 3) - nmin) / ndelta).to(torch.int64)
  voxels = []
  nx, ny, nz = spec.ndim
  for dx in (0, 1):
    for dy in (0, 1):
      for dz in (0, 1):
        c = torch.minimum(torch.clamp(
            c0 + torch.tensor([dx, dy, dz], device=pos.device), min=0), hi)
        voxels.append((c[:, 0] * ny + c[:, 1]) * nz + c[:, 2])
  return int(torch.unique(torch.cat(voxels)).numel())


def march_bytes_and_flops(spec, pos, batch, num_samples, num_coarse):
  """K1's least work: outputs written once, inputs and the distinct grid
  voxels this run's paths touch read once; ~120 fp32 operations a step."""
  distinct = distinct_voxels(spec, pos)
  written = 4 * 7 * batch * (num_samples + num_coarse)
  read = 4 * (6 * batch + num_coarse) + 16 * distinct
  return written + read, 120 * batch * num_samples, distinct


def so3_flops(so3):
  """fp32 operations of one so3 head evaluation: 2 per weight (a multiply
  and an add) plus the 60 sines and the Rodrigues rotation (~60)."""
  weights = sum(p.numel() for p in so3[0::2])
  return 2 * weights + 6 * SO3_MAX_DEG + 60


def report_row(name, replaces, err, ms, plain_ms, bound_ms, bound_by,
               source=None, **extra):
  """One kernel's entry of the report line; `launches` is filled from its
  path's run. No single PyTorch call computes a march, its reverse sweep,
  the fused NerfMLP or its weight gradients, so there is no library time
  (the MLP rows carry `unfused_ms`, the port's own nn.Linear stack, as
  their yardstick instead)."""
  return {"name": name, "route": "cuda",
          "source": source or f"samplenerfro_torch/ops/csrc/{name}.cu",
          "replaces": replaces,
          "launches": None, "max_abs_err": err, "ms": ms,
          "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
          "library_ms": None, **extra}


def bound(nbytes, flops, peak=FP32_FLOPS):
  """(bound ms, what bounds it) at the card's HBM rate and `peak`."""
  t_bytes, t_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / peak
  return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                               "operations")


def kernel_phase(model, chunk_rays, jitter):
  """K1 against its plain version on the card at the render's first chunk,
  timed, with its bound."""
  ps = model.path_sampler
  return k1_case(ps.spec, ps.grid, chunk_rays.origins, chunk_rays.viewdirs,
                 ps.near, ps.step_size, ps.num_samples, jitter, "")


def k1_case(spec, grid, origins, viewdirs, near, step_size, num_samples,
            jitter, what, time_plain=True):
  """K1 against its plain version on the card, timed, with its bound."""
  args = (spec, grid, origins, viewdirs, near, step_size, num_samples,
          jitter)
  got = march_kernel.march_lean(*args)
  torch.cuda.synchronize()
  want = march_kernel.march_lean_reference(*args)
  names = ("pos", "dir", "dist", "sub_pos", "sub_dir", "sub_dist")
  err = 0.0
  for name, a, b in zip(names, got, want):
    per = (a - b).abs().reshape(-1, a.shape[-1] if a.dim() == 3 else 1)
    per = per.amax(dim=0).tolist()
    log(f"  K1{what} {name}: max abs err per channel {per}")
    if not all(np.isfinite(per)):
      raise SystemExit(f"K1{what} {name}: non-finite output")
    err = max(err, max(per))
  del got
  if err > K1_ATOL:
    raise SystemExit(f"K1{what} disagrees with its plain version: {err} > "
                     f"{K1_ATOL}")
  ms = cuda_ms(lambda: march_kernel.march_lean(*args))
  plain_ms = (cuda_ms(lambda: march_kernel.march_lean_reference(*args))
              if time_plain else None)
  nbytes, flops, distinct = march_bytes_and_flops(
      spec, want[0], origins.shape[0], num_samples, jitter.shape[0])
  bound_ms, bound_by = bound(nbytes, flops)
  plain_txt = f"{plain_ms:.3f} ms" if plain_ms is not None else "not timed"
  log(f"  K1{what} march_lean: {ms:.4f} ms, plain {plain_txt}, bound "
      f"{bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB incl. "
      f"{distinct} distinct voxels; {flops / 1e9:.3f} GFLOP)")
  return report_row("march_lean", MARCH_KERNEL, err, ms, plain_ms, bound_ms,
                    bound_by)


def main_path_phase(model, view, jitter, chunk, device, profile=False):
  """Render the view through eval's render function; returns its outputs."""
  render_fn = make_render_fn(model, jitter)
  render_lib.render_image(render_fn, view, False, chunk=chunk, device=device)
  torch.cuda.synchronize()
  march_kernel.march_lean.launches = 0
  t0 = time.time()
  rgb, dist, acc = render_lib.render_image(render_fn, view, False,
                                           chunk=chunk, device=device)
  torch.cuda.synchronize()
  secs = time.time() - t0
  launches = march_kernel.march_lean.launches
  n = rgb.shape[0] * rgb.shape[1]
  n_chunks = -(-n // chunk)
  log(f"main path: {rgb.shape[0]}x{rgb.shape[1]} view, {n_chunks} chunks, "
      f"{secs:.3f} s, {n / secs:.1f} rays/s, march_lean launches "
      f"{launches}")
  for name, x in (("rgb", rgb), ("distance", dist), ("acc", acc)):
    if not np.all(np.isfinite(x)):
      raise SystemExit(f"main path: non-finite {name}")
  if acc.min() < 0 or acc.max() > 1:
    raise SystemExit(f"main path: acc outside [0, 1]: {acc.min()} "
                     f"{acc.max()}")
  if launches != n_chunks:
    raise SystemExit(f"main path: march_lean launched {launches} times for "
                     f"{n_chunks} chunks")
  log(f"  rgb mean {rgb.mean():.6f}, acc mean {acc.mean():.6f}, distance "
      f"range [{dist.min():.4f}, {dist.max():.4f}]")
  if profile:
    profile_chunk(render_fn, view, chunk, device)
  return rgb, acc, launches, n / secs


def fused_render_phase(model, view, jitter, chunk, device, rgb_ref, acc_ref,
                       xla_rate, profile=False):
  """The view again with --mlp_kernel=pallas and pallas_pe; returns the K4
  launches of each render."""
  render_fn = make_render_fn(model, jitter)
  n_chunks = -(-RES * RES // chunk)
  counts, saved = {}, model.mlp_kernel
  try:
    for name in ("pallas", "pallas_pe"):
      model.mlp_kernel = name
      render_lib.render_image(render_fn, view, False, chunk=chunk,
                              device=device)
      torch.cuda.synchronize()
      mlp_kernel.mlp_fwd.launches = mlp_kernel.mlp_bwd.launches = 0
      t0 = time.time()
      rgb, dist, acc = render_lib.render_image(render_fn, view, False,
                                               chunk=chunk, device=device)
      torch.cuda.synchronize()
      secs = time.time() - t0
      k4, k5 = mlp_kernel.mlp_fwd.launches, mlp_kernel.mlp_bwd.launches
      e_rgb = float(np.abs(rgb - rgb_ref).max())
      e_acc = float(np.abs(acc - acc_ref).max())
      log(f"fused render path (--mlp_kernel={name}): {secs:.3f} s, "
          f"{RES * RES / secs:.1f} rays/s (nn.Linear: {xla_rate:.1f}), "
          f"K4 launches {k4}, K5 {k5}; against the nn.Linear render max abs "
          f"err rgb {e_rgb:.3e}, acc {e_acc:.3e} (tolerance {XCHECK_ATOL})")
      if not all(np.all(np.isfinite(x)) for x in (rgb, dist, acc)):
        raise SystemExit(f"fused render ({name}): non-finite output")
      if (k4, k5) != (2 * n_chunks, 0):
        raise SystemExit(f"fused render ({name}): K4/K5 launched {k4}/{k5} "
                         f"times for {n_chunks} chunks")
      if not (e_rgb <= XCHECK_ATOL and e_acc <= XCHECK_ATOL):
        raise SystemExit(f"fused render ({name}) disagrees with nn.Linear")
      counts[name] = k4
      if profile and name == "pallas":
        profile_chunk(render_fn, view, chunk, device)
  finally:
    model.mlp_kernel = saved
  return counts


def profile_chunk(render_fn, view, chunk, device):
  """Device time by kernel for one chunk (torch.profiler)."""
  from torch.profiler import ProfilerActivity
  from torch.profiler import profile as tprofile
  flat = rays_lib.namedtuple_map(
      lambda r: torch.from_numpy(np.ascontiguousarray(
          r.reshape(-1, r.shape[-1])[:chunk])).to(device), view)
  with torch.no_grad(), tprofile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
    render_fn(flat)
    torch.cuda.synchronize()
  log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=20))


def cross_check_phase(model, view, jitter, rgb_gpu, acc_gpu, n=256):
  """The first `n` rays of the render order on the CPU against the card."""
  perm, _ = render_lib.tile_order(RES, RES, render_lib.TILE)
  idx = perm[:n]
  flat = rays_lib.namedtuple_map(
      lambda r: torch.from_numpy(r.reshape(-1, r.shape[-1])[idx].copy()),
      view)
  model.to("cpu")
  t0 = time.time()
  with torch.no_grad():
    out = model(flat, jitter.cpu(), randomized=False,
                mlp_dtype=torch.float32)[0][-1]
  rgb_cpu, acc_cpu = out[0].numpy(), out[2].numpy()
  e_rgb = float(np.abs(rgb_cpu - rgb_gpu.reshape(-1, 3)[idx]).max())
  e_acc = float(np.abs(acc_cpu - acc_gpu.reshape(-1)[idx]).max())
  log(f"cpu cross-check: {n} rays in {time.time() - t0:.1f} s, max abs err "
      f"rgb {e_rgb:.3e}, acc {e_acc:.3e} (tolerance {XCHECK_ATOL})")
  if not (e_rgb <= XCHECK_ATOL and e_acc <= XCHECK_ATOL):
    raise SystemExit("cpu cross-check failed")


def so3_kernel_phases(model, batch, seed, profile=False):
  """K2 and K3 against their plain versions on the card, timed, with
  their bounds, on one training batch's rays."""
  ps = model.path_sampler
  dev = ps.grid.device
  o = torch.from_numpy(batch["rays"].origins).to(dev)
  d = torch.from_numpy(batch["rays"].viewdirs).to(dev)
  return so3_case(ps.spec, ps.grid, ps.near, ps.step_size, ps.num_samples, o,
                  d, seed, "", profile=profile)


def profile_calls(what, fn):
  """Device time by kernel of one fn() (torch.profiler)."""
  from torch.profiler import ProfilerActivity
  from torch.profiler import profile as tprofile
  fn()
  torch.cuda.synchronize()
  with tprofile(activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
    fn()
    torch.cuda.synchronize()
  log(f"profile of {what}:")
  log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=12))


def so3_case(spec, grid, near, step_size, steps, o, d, seed, what,
             time_plain=True, profile=False, dist_relative=False):
  """K2 and K3 against their plain versions on the card at rays (o, d),
  timed, with their bounds; returns their report rows."""
  dev = grid.device
  so3 = so3_params_for(seed, dev)
  fwd_args = (spec, grid, o, d, near, step_size, steps, so3, SO3_ALPHA,
              SO3_MAX_DEG)
  traj = march_kernel.march_full(*fwd_args)
  torch.cuda.synchronize()
  want = march_kernel.march_full_reference(*fwd_args)
  per = (traj - want).abs().reshape(-1, 11).amax(dim=0).tolist()
  log(f"  K2{what} max abs err per channel (pos 3, dir 3, dist, n, grad n "
      f"3): {per}")
  err2 = max(per)
  # The arclength sums |p_s - p_s+1| of fp32 positions, which cancel: at
  # glass's 1536 steps to 13.8 units the ulps of the path carry into it
  # beyond K2_ATOL (4.4e-4 on NVIDIA H100 80GB HBM3, chip_smoke.py), so
  # there (dist_relative) it is held at K2_ATOL of its largest value.
  dist_scale = (max(1.0, float(want[..., 6].abs().max())) if dist_relative
                else 1.0)
  worst = max(max(per[:6] + per[7:]), per[6] / dist_scale)
  if not (np.all(np.isfinite(per)) and worst <= K2_ATOL):
    raise SystemExit(f"K2{what} disagrees with its plain version: {per} "
                     f"against {K2_ATOL} (the arclength's relative)")
  batch_n = o.shape[0]
  active = int((traj[..., 8:11].norm(dim=-1) > 1e-3).sum())
  distinct = distinct_voxels(spec, traj[..., 0:3])
  del traj
  nparams = sum(p.numel() for p in so3)
  mlp_flops = so3_flops(so3) * active
  march_ops = 120 * batch_n * steps
  ms2 = cuda_ms(lambda: march_kernel.march_full(*fwd_args))
  plain2 = (cuda_ms(lambda: march_kernel.march_full_reference(*fwd_args), 3)
            if time_plain else None)
  bytes2 = 44 * batch_n * steps + 16 * distinct + 24 * batch_n + 4 * nparams
  bound2, by2 = bound(bytes2, mlp_flops + march_ops)
  plain_txt = f"{plain2:.3f} ms" if plain2 is not None else "not timed"
  log(f"  K2{what} march_so3: {ms2:.4f} ms, plain {plain_txt}, bound "
      f"{bound2:.4f} ms by {by2} ({active} of {batch_n * steps} ray-steps "
      f"active, {(mlp_flops + march_ops) / 1e9:.3f} GFLOP, "
      f"{bytes2 / 1e6:.1f} MB incl. {distinct} distinct voxels)")

  # K3 sweeps the plain march's trajectory, the one march_bwd_reference
  # replays, so that both differentiate the same path: K2's own path
  # differs by the ulps above, which the PE multiplies by up to 2^9 and
  # which then flip ReLU masks of the head near 0.
  cfg = eikonal_vjp.MarchConfig(spec, near, step_size, steps, SO3_MAX_DEG)
  gen = torch.Generator().manual_seed(seed + 1)
  dtraj = torch.randn(want.shape, generator=gen).to(dev)
  bwd_args = (cfg, grid, o, d, so3, SO3_ALPHA, want, dtraj)
  swept = want[..., 8:11].norm(dim=-1) > 1e-3
  p3_case(f"'all' batch{what}, active ray-steps",
          want[..., 0:3][swept].contiguous(), so3, SO3_ALPHA,
          time_plain=time_plain)
  by_step = probes.so3_preacts_by_step(want[..., 0:3], so3, SO3_ALPHA)
  layers = probes.relu_flips(*zip(*by_step), mask=swept)
  del by_step, swept
  log(f"  P3 'all' batch{what} against the plain version called a step at a "
      "time, as the plain march calls the head, over the active ray-steps, "
      "per layer (max abs err, ReLU flips, min |pre-activation|): "
      f"{[(r['max_dev'], r['flips'], r['min_abs']) for r in layers]}")
  got = eikonal_vjp.march_bwd(*bwd_args)
  torch.cuda.synchronize()
  ref = eikonal_vjp.march_bwd_reference(cfg, grid, o, d, so3, SO3_ALPHA,
                                        dtraj)
  err3 = 0.0
  for name, g, w in zip(K3_NAMES, k3_flat(got), k3_flat(ref)):
    diff = (g - w).abs()
    scale = float(w.abs().max())
    worst = float((diff / (K3_ATOL_SCALE * scale + K3_RTOL * w.abs()))
                  .max()) if scale > 0 else 0.0
    log(f"  K3{what} {name}: max abs err {float(diff.max()):.3e} of scale "
        f"{scale:.3e} ({worst:.3f} of the tolerance)")
    if not (bool(torch.isfinite(g).all()) and worst <= 1.0):
      raise SystemExit(f"K3{what} {name} disagrees with its plain version")
    err3 = max(err3, float(diff.max()))
  del ref
  again = eikonal_vjp.march_bwd(*bwd_args)
  if not all(torch.equal(a, b) for a, b in zip(k3_flat(got), k3_flat(again))):
    raise SystemExit(f"K3{what} is not deterministic: two runs differ")
  del got, again
  log(f"  K3{what} two runs agree bit for bit")
  ms3 = cuda_ms(lambda: eikonal_vjp.march_bwd(*bwd_args))
  plain3 = (cuda_ms(lambda: eikonal_vjp.march_bwd_reference(
      cfg, grid, o, d, so3, SO3_ALPHA, dtraj), 3) if time_plain else None)
  if profile:
    profile_calls(f"one K3 call{what}",
                  lambda: eikonal_vjp.march_bwd(*bwd_args))
  # Least work: the head's forward, its backward to the input and its
  # weight gradients at each active ray-step (3x K2's MLP arithmetic) plus
  # ~200 operations of step adjoints a ray-step; the trajectory and its
  # cotangent read once, the voxels once, the weights read and their
  # gradients written once.
  flops3 = 3 * mlp_flops + 200 * batch_n * steps
  bytes3 = (2 * 44 * batch_n * steps + 16 * distinct + 24 * batch_n
            + 8 * nparams)
  bound3, by3 = bound(bytes3, flops3)
  plain_txt = f"{plain3:.3f} ms" if plain3 is not None else "not timed"
  log(f"  K3{what} march_bwd: {ms3:.4f} ms, plain {plain_txt}, bound "
      f"{bound3:.4f} ms by {by3} ({flops3 / 1e9:.3f} GFLOP, "
      f"{bytes3 / 1e6:.1f} MB)")
  return (report_row("march_so3", MARCH_KERNEL, err2, ms2, plain2, bound2,
                     by2),
          report_row("march_bwd",
                     "samplenerfro_tpu/ops/pallas/march_bwd_kernel.py:168",
                     err3, ms3, plain3, bound3, by3))


K3_NAMES = ["origins", "directions", "alpha"] + [
    f"so3 {n}.{k}" for n in ("Dense_0", "Dense_1", "Dense_2", "Dense_3",
                             "Dense_out") for k in ("weight", "bias")]


def k3_flat(r):
  """K3's (origins_bar, directions_bar, alpha_bar, [so3 grads]) flat."""
  return [r[0], r[1], r[2]] + list(r[3])


def glass_phase(device, seed, profile=False):
  """K1, K2 and K3 against their plain versions at glass's shape
  (glass_inputs); plain versions not timed."""
  t0 = time.time()
  spec, grid, o, d, near, step_size, steps, jitter = glass_inputs(device,
                                                                  seed)
  log(f"glass shape: {GLASS[0]}^3 grid prefiltered 5/3, 64x24 = {steps} "
      f"steps, near {near}, step {step_size:.6f}, 1024 rays "
      f"({time.time() - t0:.1f} s to build)")
  with torch.no_grad():
    k1 = k1_case(spec, grid, o, d, near, step_size, steps, jitter,
                 " (glass)", time_plain=False)
  k2, k3 = so3_case(spec, grid, near, step_size, steps, o, d, seed,
                    " (glass)", time_plain=False, profile=profile,
                    dist_relative=True)
  return {"k1_ms": k1["ms"], "k2_ms": k2["ms"], "k3_ms": k3["ms"]}


def march_geometry(kind, args):
  """The launch geometry of a march call (K1 or K2)."""
  if kind == "lean":
    return march_kernel.lean_launch_geometry(args[2].shape[0], args[6],
                                             args[7].shape[0])
  return march_kernel.so3_launch_geometry(args[2].shape[0],
                                          args[7][0].shape[0], args[9])


def marches_phase(cases):
  """K1 and K2 at every shape of `cases` (march_parity.march_report: the
  digests, the max abs error per output or channel, the call's time and
  the kernel's device time), each held against its plain version: K1 at
  K1_ATOL, K2 at K2_ATOL; on marches of LONG_MARCH steps the arclength
  (K1's dist and sub_dist, K2's channel 6) at that tolerance of its
  largest value, as so3_case holds K2's at glass. Returns {(kind, shape):
  (call ms, kernel ms)}."""
  times = {}
  for shape, kind, args in cases:
    report = march_report(shape, kind, args)
    err = report["err"]
    scale = (max(1.0, report["dist_max"]) if args[6] >= LONG_MARCH
             else 1.0)
    if kind == "lean":
      dist = (2, 5)
      worst, atol = max(e / scale if i in dist else e
                        for i, e in enumerate(err)), K1_ATOL
    else:
      worst, atol = max(max(err[:6] + err[7:]), err[6] / scale), K2_ATOL
    log(f"  march {kind} {shape}: worst error {worst:.3e} against "
        f"{atol} (arclength over {scale:.4f}); geometry "
        f"{march_geometry(kind, args)}")
    if not (np.all(np.isfinite(err)) and worst <= atol):
      raise SystemExit(f"march {kind} {shape} disagrees with its plain "
                       f"version: {err} against {atol}")
    times[(kind, shape)] = (report["call_ms"], report["kernel_ms"])
  return times


def sync_phase(cases):
  """One march_lean and one march_full call (the first case of each)
  under torch.cuda.set_sync_debug_mode("error"); returns the calls that
  synchronized the stream."""
  synced = []
  for want_kind in ("lean", "so3"):
    shape, kind, args = next(c for c in cases if c[1] == want_kind)
    fn = march_call(kind)[0]
    with torch.no_grad():
      fn(*args)
      torch.cuda.synchronize()
      torch.cuda.set_sync_debug_mode("error")
      try:
        fn(*args)
      except RuntimeError as e:
        synced.append(f"{kind} {shape}: {str(e).splitlines()[0]}")
      finally:
        torch.cuda.set_sync_debug_mode(0)
      torch.cuda.synchronize()
  log(f"sync check (set_sync_debug_mode('error'), march_lean and "
      f"march_full): {'no sync' if not synced else synced}")
  return synced


def probe_phase(device):
  """P1 right after the build, then P2; returns their report rows."""
  x = probes.probe_inputs((8, 128)).to(device)
  probes.add_one.launches = probes.sin.launches = 0
  t0 = time.time()
  y = probes.add_one(x)
  torch.cuda.synchronize()
  secs = time.time() - t0
  if not torch.equal(y, x + 1):
    raise SystemExit("P1: x + 1 came back wrong")
  launches1 = probes.add_one.launches
  ms1 = cuda_ms(lambda: probes.add_one(x))
  plain1 = cuda_ms(lambda: x + 1)
  dev1 = graph_ms(lambda: probes.add_one(x))
  lib1 = graph_ms(lambda: x + 1)
  log(f"P1 probe_add_one: exact, first launch {secs * 1e3:.3f} ms, "
      f"{ms1:.4f} ms, plain {plain1:.4f} ms (host call included); device "
      f"time {dev1:.4f} ms, x + 1 {lib1:.4f} ms")
  errs = probes.sin_errors(device)
  for scale, e64, elib in errs:
    log(f"P2 sinf at scale {scale:g}: max abs err {e64:.3e} against float64, "
        f"{elib:.3e} against torch.sin on the card")
  worst = max(e for _, e, _ in errs)
  if worst > P2_ATOL:
    raise SystemExit(f"P2: sinf off by {worst} > {P2_ATOL}")
  launches2 = probes.sin.launches
  xs = (probes.probe_inputs((8, 256)) * 2048.0).to(device)
  ms2 = cuda_ms(lambda: probes.sin(xs))
  plain2 = cuda_ms(lambda: torch.sin(xs))
  dev2 = graph_ms(lambda: probes.sin(xs))
  lib2 = graph_ms(lambda: torch.sin(xs))
  log(f"P2 probe_sin: {ms2:.4f} ms, plain {plain2:.4f} ms (host call "
      f"included); device time {dev2:.4f} ms, torch.sin {lib2:.4f} ms")
  rows = []
  for name, replaces, launches, err, ms, plain, n, dev, lib in (
      ("probe_add_one", "samplenerfro_tpu/utils/mosaic_probe.py:39",
       launches1, 0.0, ms1, plain1, 8 * 128, dev1, lib1),
      ("probe_sin", "scripts/debug/dbg_sin.py:16", launches2, worst, ms2,
       plain2, 8 * 256, dev2, lib2)):
    # Least work: the block read once and written once; a sine is ~20
    # operations.
    bound_ms, by = bound(8 * n, 20 * n)
    # The plain version is one PyTorch call (x + 1, torch.sin), so it is
    # the library yardstick as well.
    row = report_row(name, replaces, err, ms, plain, bound_ms, by,
                     source="samplenerfro_torch/ops/csrc/probes.cu",
                     device_ms=dev, library_device_ms=lib)
    row["launches"], row["library_ms"] = launches, plain
    rows.append(row)
  return rows


def selfcheck_phase():
  """selfcheck.check_march at its defaults on the card, with K1, K2 and
  K3's counts zeroed before it and read after."""
  march_kernel.march_lean.launches = 0
  march_kernel.march_full.launches = 0
  eikonal_vjp.march_bwd.launches = 0
  march_kernel.march_full_plain.arms.clear()
  t0 = time.time()
  envelopes = {}
  deviations, not_run = selfcheck.check_march(envelopes=envelopes)
  counts = (march_kernel.march_lean.launches,
            march_kernel.march_full.launches, eikonal_vjp.march_bwd.launches)
  head_off = march_kernel.march_full_plain.arms["default"]
  log(f"selfcheck: {time.time() - t0:.1f} s, launches K1 {counts[0]}, K2 "
      f"{counts[1]}, K3 {counts[2]}, K2 with the head off at "
      f"march_interp=default {head_off}")
  for name, dev in deviations.items():
    log(f"  {name}: {dev:.3e}, envelope {envelopes[name]:.3e} "
        f"({dev / envelopes[name]:.3f} of it)")
  for msg in not_run:
    log(f"  {msg}")
  if min(counts) == 0 or head_off == 0:
    raise SystemExit(f"selfcheck: launches K1/K2/K3 {counts}, head off "
                     f"{head_off}, each must be at least 1")
  return head_off


def p3_case(what, pos, so3, alpha, time_plain=True):
  """P3 against its plain version at points `pos` [N, 3], timed, with its
  bound; returns (max abs err, ms, plain ms, bound ms, bound by)."""
  got = probes.so3_preacts(pos, so3, alpha)
  torch.cuda.synchronize()
  want = probes.so3_preacts_reference(pos, so3, alpha)
  layers = probes.relu_flips(got, want)
  scale = max(float(w.abs().max()) for w in want)
  err = max(r["max_dev"] for r in layers)
  del got, want
  for i, r in enumerate(layers, 1):
    log(f"  P3 {what}, layer {i}: max abs err {r['max_dev']:.3e}, ReLU "
        f"flips {r['flips']} of {r['elements']}, min |pre-activation| "
        f"{r['min_abs']:.3e}")
  if not (np.isfinite(err) and err <= P3_ATOL * scale):
    raise SystemExit(f"P3 ({what}) disagrees with its plain version: {err} "
                     f"> {P3_ATOL} * {scale}")
  ms = cuda_ms(lambda: probes.so3_preacts(pos, so3, alpha))
  dev, per = kernel_device_ms(lambda: probes.so3_preacts(pos, so3, alpha),
                              "so3_preacts_kernel", reps=3)
  device_ms = dev * per
  plain = (cuda_ms(lambda: probes.so3_preacts_reference(pos, so3, alpha))
           if time_plain else float("nan"))
  # Least work: the PE (~20 operations a sine) and the three layers'
  # multiply-adds (2 operations each); the points and the three layers'
  # weights read once, the three [N, width] outputs written once.
  n = pos.shape[0]
  width, in_dim = so3[0].shape
  macs = in_dim * width + 2 * width * width
  weights = macs + 3 * width
  nbytes = 12 * n + 4 * weights + 12 * n * width
  bound_ms, by = bound(nbytes, n * (2 * macs + 20 * in_dim))
  log(f"  P3 so3_preacts {what} ({n} points): {ms:.4f} ms ({device_ms:.4f} "
      f"ms of kernel device time), plain {plain:.4f} ms, bound "
      f"{bound_ms:.4f} ms by {by} ({2 * macs * n / 1e9:.3f} GFLOP of "
      f"products, {nbytes / 1e6:.1f} MB)")
  return err, ms, plain, bound_ms, by, device_ms


def p3_phase(device):
  """P3 against its plain version at the probe's points, then the probe's
  path with P3's count zeroed; returns P3's report row."""
  pos = probe_so3_relu.probe_positions(device).reshape(-1, 3)
  so3 = selfcheck.default_so3_params(device)
  err, ms, plain, bound_ms, by, device_ms = p3_case(
      "probe points", pos, so3, selfcheck.ALPHA)
  del pos
  probes.so3_preacts.launches = 0
  layers = probe_so3_relu.probe()
  launches = probes.so3_preacts.launches
  log(f"P3 probe path (probe_so3_relu.probe): launches {launches}, ReLU "
      f"flips per layer {[r['flips'] for r in layers]}")
  if launches != 1:
    raise SystemExit(f"P3 probe path: {launches} launches, expected 1")
  row = report_row("so3_preacts", "scripts/debug/probe_so3_relu.py:102",
                   err, ms, plain, bound_ms, by,
                   source="samplenerfro_torch/ops/csrc/march_bwd.cu",
                   device_ms=device_ms)
  row["launches"] = launches
  return row


def capture_mlp_inputs(model, rays, jitter, mlp_kernel_name):
  """The (x, cond) each fused MLP call of one forward of `model` gets with
  --mlp_kernel=mlp_kernel_name, coarse then fine."""
  calls, original = [], mlp_kernel.fused_nerf_mlp

  def capture(mlp, x, cond, **kwargs):
    calls.append((x.contiguous(), cond.contiguous()))
    return original(mlp, x, cond, **kwargs)

  saved, model.mlp_kernel = model.mlp_kernel, mlp_kernel_name
  mlp_kernel.fused_nerf_mlp = capture
  try:
    with torch.no_grad():
      model(rays, jitter, randomized=False, mlp_dtype=torch.float32)
  finally:
    mlp_kernel.fused_nerf_mlp = original
    model.mlp_kernel = saved
  return calls


def mlp_bound(spec, rows, dtype, backward=False):
  """(bound ms, by, TFLOP): 2 operations a multiply-add of every layer at
  the true widths (3x for K5: recompute, dW, dh), at the fp32 or the bf16
  tensor-core peak; inputs and outputs (the MLP's weights, K5's
  cotangent and gradients) moved once."""
  macs = sum(k * n for k, n in mlp_kernel.layer_dims(spec))
  flops = (6 if backward else 2) * macs * rows
  per_row = 4 * (6 if spec.pe is not None else spec.feat + spec.cond)
  per_row += 4 * (spec.num_rgb + spec.num_sigma)
  weight_bytes = 4 if dtype == torch.float32 else 2
  nbytes = per_row * rows + (weight_bytes + (4 if backward else 0)) * macs
  peak = FP32_FLOPS if dtype == torch.float32 else BF16_TC_FLOPS
  bound_ms, by = bound(nbytes, flops, peak)
  return bound_ms, by, flops / 1e12


def k5_traffic(spec, rows, dtype, blocks):
  """Bytes K5's partial and scratch move in one call (loads and stores the
  kernel issues, from its layout in csrc/mlp_bwd.cu), and what PR 4's
  design moved in its partial (read and written once per 64-row tile).
  Returns (partial, scratch, parent partial)."""
  tile, sr = mlp_kernel.tile_rows(spec, dtype), mlp_kernel.SUPER_ROWS
  esize = 2 if dtype == torch.bfloat16 else 4
  dims = mlp_kernel.layer_dims(spec)
  count = sum(k * n for k, n in dims) + sum(n for _, n in dims)
  d, w = spec.depth, spec.width
  fp = mlp_kernel.feature_cols(spec.feat)
  cp = mlp_kernel.feature_cols(spec.cond)
  big = [i for i in range(d + 3) if i != d]  # the layers phase b sums
  wide = sum(dims[i][0] * dims[i][1] for i in big)

  def input_cols(i):
    """The stored columns of layer i's input."""
    if i == d + 1:
      return w
    if i == d + 2:
      return w + cp
    if i == 0:
      return fp
    return w + (fp if mlp_kernel.skip_after(spec, i - 1) else 0)

  # Per processed row, what phase b reads: each layer's input once and its
  # cotangent once per pass of `tile` input columns; the masks read back.
  reads = d * w
  for i in big:
    cols = input_cols(i)
    reads += cols + -(-cols // tile) * dims[i][1]
  partial = scratch = 0
  bounds = [rows * b // blocks for b in range(blocks + 1)]
  for lo, hi in zip(bounds, bounds[1:]):
    for first, st in enumerate(range(lo, hi, sr)):
      done = -(-(min(st + sr, hi) - st) // tile) * tile
      partial += 4 * wide * (1 if first == 0 else 2)
      scratch += esize * done * (mlp_kernel.scratch_row_elems(spec) + reads)
  partial += 4 * count * (blocks + 1)  # the reduce
  parent = 8 * count * -(-rows // 64) + 4 * count * (blocks + 1)
  return partial, scratch, parent


def fused_kernel_phases(model, chunk_rays, batch_rays, jitter, seed):
  """K4 and K5 against their plain versions on the card at the fine calls
  of the render's first chunk and of a training batch, timed beside their
  bounds and the nn.Linear stack (unfused)."""
  mlp = model.fine_mlp
  params = [p.detach() for p in mlp_kernel.mlp_params(mlp)]
  pe = (model.max_deg_point, model.deg_view)
  render_raw = capture_mlp_inputs(model, chunk_rays, jitter, "pallas_pe")[1]
  train_raw = capture_mlp_inputs(model, batch_rays, jitter, "pallas_pe")[1]
  encode = lambda raw: (math_ops.pe_cols(raw[0], pe[0]).contiguous(),
                        math_ops.pe_cols(raw[1], pe[1]).contiguous())
  rows = []
  for what, raw, dtype, fed in (
      ("fp32 render fine call", render_raw, torch.float32, True),
      ("fp32 pe render fine call", render_raw, torch.float32, False),
      ("bf16 train fine call", train_raw, torch.bfloat16, True)):
    x, c = encode(raw) if fed else raw
    spec = mlp_kernel.mlp_spec(mlp, None if fed else pe)
    got = torch.cat(mlp_kernel.mlp_fwd(spec, params, x, c, dtype), -1)
    torch.cuda.synchronize()
    want = torch.cat(mlp_kernel.fused_nerf_mlp_reference(spec, params, x, c,
                                                         dtype), -1)
    err = (got - want).abs()
    e_max, e_mean = float(err.max()), float(err.mean())
    del got, want, err
    ok = (e_max <= K4_FP32_ATOL if dtype == torch.float32 else
          e_max <= K4_BF16_MAX and e_mean <= K4_BF16_MEAN)
    log(f"  K4 {what} ({x.shape[0]} rows): max abs err {e_max:.3e}, mean "
        f"{e_mean:.3e}")
    if not (ok and np.isfinite(e_max)):
      raise SystemExit(f"K4 {what} disagrees with its plain version")
    pack = mlp_kernel.pack_params(params, dtype)
    ms = cuda_ms(lambda: mlp_kernel.mlp_fwd(spec, params, x, c, dtype,
                                            pack=pack))
    call_ms = cuda_ms(lambda: mlp_kernel.mlp_fwd(spec, params, x, c, dtype))
    device_ms = graph_ms(lambda: mlp_kernel.mlp_fwd(
        spec, params, x, c, dtype, pack=pack), count=MLP_GRAPH_CALLS)
    plain = cuda_ms(lambda: mlp_kernel.fused_nerf_mlp_reference(
        spec, params, x, c, dtype), 3)
    with torch.no_grad():
      if fed:
        unfused = cuda_ms(lambda: mlp(x, c, dtype=dtype))
      else:
        unfused = cuda_ms(lambda: mlp(*encode(raw), dtype=dtype))
    bound_ms, by, tflop = mlp_bound(spec, x.shape[0], dtype)
    log(f"  K4 mlp_fwd {what}: {ms:.4f} ms with the weights packed "
        f"({call_ms:.4f} ms as a call that packs them, {device_ms:.4f} ms "
        f"of device time, a CUDA graph of {MLP_GRAPH_CALLS} calls), "
        f"{tflop / ms * 1e3:.1f} TFLOP/s, {100 * bound_ms / ms:.1f}% of the "
        f"bound {bound_ms:.4f} ms by {by} ({tflop:.3f} TFLOP); plain "
        f"{plain:.3f} ms, unfused (nn.Linear) {unfused:.3f} ms")
    rows.append(report_row("mlp_fwd", MLP_KERNEL + ":219", e_max, ms, plain,
                           bound_ms, by, case=what, unfused_ms=unfused,
                           call_ms=call_ms, device_ms=device_ms,
                           tflops=tflop / ms * 1e3))

  x, c = encode(train_raw)
  spec = mlp_kernel.mlp_spec(mlp)
  gen = torch.Generator().manual_seed(seed + 2)
  n = x.shape[0]
  drgb = (1e-3 * torch.randn((n, 3), generator=gen)).to(x.device)
  dsigma = (1e-3 * torch.randn((n, 1), generator=gen)).to(x.device)
  mlp_rounding.stage_report(spec, params, x, c, drgb, dsigma,
                            K5_BF16_SCALE, log)
  # F2: K5 takes the gradient of the activations K4 produced. Before: K4's
  # bf16 forward on tensor cores (the trial switch keeps that design).
  before = mlp_rounding.forward_disagreement(
      spec, params, x, c, drgb, dsigma, torch.bfloat16,
      (mlp_rounding.K4_TENSOR,))
  after = mlp_rounding.forward_disagreement(spec, params, x, c, drgb, dsigma,
                                            torch.bfloat16)
  log(f"  F2, bf16 train fine call ({n} rows): elements where K4's stored "
      f"activations and K5's recompute differ, per layer, K4 on tensor "
      f"cores (before): {before}; K4 as shipped: {after}")
  if any(after.values()):
    raise SystemExit("F2: K5's recompute differs from K4's activations")
  for what, dtype in (("bf16 train fine call", torch.bfloat16),
                      ("fp32 train fine call", torch.float32)):
    args = (spec, params, x, c, drgb, dsigma, dtype)
    got = mlp_kernel.mlp_bwd(*args)
    torch.cuda.synchronize()
    want = mlp_kernel.fused_nerf_mlp_bwd_reference(*args)
    worst, err = 0.0, 0.0
    for g, w in zip(got, want):
      scale = float(w.abs().max())
      tol = (K5_BF16_SCALE * scale if dtype == torch.bfloat16 else
             K5_ATOL_SCALE * scale + K5_RTOL * w.abs())
      if scale > 0:
        worst = max(worst, float(((g - w).abs() / tol).max()))
      err = max(err, float((g - w).abs().max()))
      if not bool(torch.isfinite(g).all()):
        raise SystemExit(f"K5 {what}: non-finite gradient")
    log(f"  K5 {what}: every tensor within {worst:.3f} of its tolerance, "
        f"max abs err {err:.3e}")
    if worst > 1.0:
      raise SystemExit(f"K5 {what} disagrees with its plain version")
    again = mlp_kernel.mlp_bwd(*args)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
      raise SystemExit(f"K5 {what} is not deterministic: two runs differ")
    del got, want, again
    pack = mlp_kernel.pack_params(params, dtype)
    ms = cuda_ms(lambda: mlp_kernel.mlp_bwd(*args, pack=pack))
    call_ms = cuda_ms(lambda: mlp_kernel.mlp_bwd(*args))
    device_ms = graph_ms(lambda: mlp_kernel.mlp_bwd(*args, pack=pack),
                         count=MLP_GRAPH_CALLS)
    if dtype == torch.bfloat16:
      sweep = {r: cuda_ms(lambda: mlp_kernel.mlp_bwd(*args, pack=pack,
                                                     super_rows=r))
               for r in (256, 512, 1024, 1536)}
      log(f"  K5 {what} by super-tile rows: "
          + ", ".join(f"{r} {t:.4f} ms" for r, t in sweep.items()))
    plain = cuda_ms(lambda: mlp_kernel.fused_nerf_mlp_bwd_reference(*args),
                    3)

    def linear_backward():
      out = mlp(x, c, dtype=dtype)
      torch.autograd.grad(out, list(mlp.parameters()), (drgb, dsigma))

    unfused = cuda_ms(linear_backward)
    bound_ms, by, tflop = mlp_bound(spec, n, dtype, backward=True)
    blocks = min(torch.cuda.get_device_properties(x.device)
                 .multi_processor_count,
                 -(-n // mlp_kernel.tile_rows(spec, dtype)))
    part_b, scratch_b, parent_b = k5_traffic(spec, n, dtype, blocks)
    log(f"  K5 {what}: {blocks} blocks, super-tiles of "
        f"{mlp_kernel.SUPER_ROWS} rows; partial {part_b / 1e9:.3f} GB "
        f"(PR 4's design: {parent_b / 1e9:.3f} GB), scratch "
        f"{scratch_b / 1e9:.3f} GB per call")
    log(f"  K5 mlp_bwd {what}: {ms:.4f} ms with the weights packed "
        f"({call_ms:.4f} ms as a call that packs them, {device_ms:.4f} ms "
        f"of device time, a CUDA graph of {MLP_GRAPH_CALLS} calls), "
        f"{tflop / ms * 1e3:.1f} TFLOP/s, {100 * bound_ms / ms:.1f}% of the "
        f"bound {bound_ms:.4f} ms by {by} ({tflop:.3f} TFLOP); plain "
        f"{plain:.3f} ms, unfused (nn.Linear forward + autograd to the "
        f"weights) {unfused:.3f} ms; two runs agree bit for bit")
    rows.append(report_row("mlp_bwd", MLP_KERNEL + ":246", err, ms, plain,
                           bound_ms, by, case=what, unfused_ms=unfused,
                           call_ms=call_ms, device_ms=device_ms,
                           tflops=tflop / ms * 1e3))
  return rows


def k5_worst(got, want, dtype):
  """K5's worst error across tensors in units of its tolerance."""
  worst = 0.0
  for g, w in zip(got, want):
    if not bool(torch.isfinite(g).all()):
      return float("inf")
    scale = float(w.abs().max())
    tol = (K5_BF16_SCALE * scale if dtype == torch.bfloat16 else
           K5_ATOL_SCALE * scale + K5_RTOL * w.abs())
    if scale > 0:
      worst = max(worst, float(((g - w).abs() / tol).max()))
  return worst


WIDE_ROWS = 4096


def wide_mlp_phase(device, seed):
  """K4 and K5 at the geometries `supports` admits past the ship MLP's
  (fault F1): trunk and condition widths 384, 512 and 1024, and pallas_pe
  with max_deg_point 16 (99 + 27 input columns); each in fp32 and bf16 on
  WIDE_ROWS random samples, against the plain versions at the K4 and K5
  tolerances, K5 twice, bit for bit. Returns {case: (K4 fp32 ms, K5 bf16
  ms)}."""
  out = {}
  rng = np.random.RandomState(seed + 5)
  pts = torch.from_numpy(rng.uniform(-1.5, 1.5, (WIDE_ROWS, 3))
                         .astype(np.float32)).to(device)
  dirs = torch.from_numpy(rng.randn(WIDE_ROWS, 3).astype(np.float32))
  dirs = (dirs / dirs.norm(dim=-1, keepdim=True)).to(device)
  gen = torch.Generator().manual_seed(seed + 6)
  drgb = (1e-3 * torch.randn((WIDE_ROWS, 3), generator=gen)).to(device)
  dsigma = (1e-3 * torch.randn((WIDE_ROWS, 1), generator=gen)).to(device)
  for width, deg, pe in ((384, 10, False), (512, 10, False),
                         (1024, 10, False), (256, 16, True)):
    what = f"width {width}, max_deg_point {deg}, {'pe' if pe else 'fed'}"
    mlp = mlp_modules.NerfMLP(3 + 6 * deg, 27, net_depth=8, net_width=width,
                              net_width_condition=width, skip_layer=4,
                              generator=torch.Generator().manual_seed(seed))
    params = [t.detach().to(device) for t in mlp_kernel.mlp_params(mlp)]
    spec = mlp_kernel.mlp_spec(mlp, (deg, 4) if pe else None)
    x, c = ((pts, dirs) if pe else
            (math_ops.pe_cols(pts, deg).contiguous(),
             math_ops.pe_cols(dirs, 4).contiguous()))
    for dtype in (torch.float32, torch.bfloat16):
      acts = {}
      got = torch.cat(mlp_kernel.mlp_fwd(spec, params, x, c, dtype,
                                         acts=acts), -1)
      torch.cuda.synchronize()
      want = torch.cat(mlp_kernel.fused_nerf_mlp_reference(spec, params, x, c,
                                                           dtype), -1)
      err = (got - want).abs()
      e_max, e_mean = float(err.max()), float(err.mean())
      ok4 = (e_max <= K4_FP32_ATOL if dtype == torch.float32 else
             e_max <= K4_BF16_MAX and e_mean <= K4_BF16_MEAN)
      args = (spec, params, x, c, drgb, dsigma, dtype)
      g5 = mlp_kernel.mlp_bwd(*args)
      again = mlp_kernel.mlp_bwd(*args)
      plain_acts = {}
      own = k5_worst(g5, mlp_kernel.fused_nerf_mlp_bwd_reference(
          *args, stored=plain_acts), dtype)
      # ReLU masks that K4's sums (k order) and the plain version's
      # (cuBLAS) set apart at a pre-activation at 0: the plain version
      # replays K4's activations, as the K3 checks replay P3's flips.
      flips = sum(int(((acts[k] > 0) != (plain_acts[k] > 0)).sum())
                  for k in acts)
      worst = (k5_worst(g5, mlp_kernel.fused_nerf_mlp_bwd_reference(
          *args, at=acts), dtype) if flips else own)
      same = all(torch.equal(a, b) for a, b in zip(g5, again))
      log(f"  F1 {what}, {str(dtype)[6:]}: "
          f"{'wide' if mlp_kernel.wide(spec) else 'narrow'} tiles of "
          f"{mlp_kernel.tile_rows(spec, dtype)} rows; K4 max abs err "
          f"{e_max:.3e}, mean {e_mean:.3e}; ReLU masks K4 and the plain "
          f"version set apart: {flips}; K5 within {worst:.3f} of its "
          f"tolerance ({own:.3f} without the replay), two runs "
          f"{'bit for bit' if same else 'DIFFER'}")
      if not (ok4 and np.isfinite(e_max) and worst <= 1.0 and same):
        raise SystemExit(f"F1 {what} {dtype}: K4/K5 disagree with their "
                         f"plain versions")
      if dtype == torch.float32:
        ms4 = cuda_ms(lambda: mlp_kernel.mlp_fwd(spec, params, x, c, dtype))
      else:
        ms5 = cuda_ms(lambda: mlp_kernel.mlp_bwd(*args))
        if not pe:
          mlp_rounding.stage_report(spec, params, x, c, drgb, dsigma,
                                    K5_BF16_SCALE, log)
      del got, want, err, g5, again
    log(f"  F1 {what}: K4 fp32 {ms4:.4f} ms, K5 bf16 {ms5:.4f} ms at "
        f"{WIDE_ROWS} rows")
    out[what] = (ms4, ms5)
  return out


def _grads_finite(model):
  ok = torch.ones((), dtype=torch.bool, device=next(model.parameters()).device)
  for p in model.parameters():
    if p.grad is not None:
      ok = ok & torch.isfinite(p.grad).all()
  return ok


def profile_train_step(model, args, host, device, step, generators):
  """Device time by kernel for one train step (torch.profiler)."""
  generator, jitter_gen = generators
  jitter = nerf.make_jitter(args.num_coarse_samples, args.num_path_samples,
                            jitter_gen)
  from torch.profiler import ProfilerActivity
  from torch.profiler import profile as tprofile
  optimizer, _, _ = step_lib.create_optimizer(model, args)
  batch = prefetch.to_device(step_batch(
      host, annealed_alpha(step, args),
      step_lib.learning_rates(optimizer, step - 1), jitter, args), device)
  torch.cuda.synchronize()
  with tprofile(activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
    step_lib.train_step(model, optimizer, batch, args, generator)
    torch.cuda.synchronize()
  events = prof.key_averages()
  total = step_device_us(events)
  log(f"profile of one {args.stage} train step: {total / 1e3:.3f} ms of "
      f"device time")
  log(events.table(sort_by="cuda_time_total", row_limit=15))
  return total / 1e3


def train_generators(device, seed):
  """(noise generator on the card, jitter generator on the host), both
  seeded, as train.loop keeps them."""
  return (torch.Generator(device=device).manual_seed(seed),
          torch.Generator().manual_seed(seed))


def _train_steps(model, args, host, device, first_step, n, generators):
  """n train steps on the repeated batch, the jitter of each drawn from
  the host generator of `generators` (train_generators); returns (losses,
  steps/s after the first, all finite, [so3 gradient norm per step])."""
  generator, jitter_gen = generators
  optimizer, _, _ = step_lib.create_optimizer(model, args)
  losses, so3_norms, finite, t0 = [], [], None, None
  for i in range(n):
    step = first_step + i
    if i == 1:
      torch.cuda.synchronize()
      t0 = time.time()
    jitter = nerf.make_jitter(args.num_coarse_samples,
                              args.num_path_samples, jitter_gen)
    batch = prefetch.to_device(step_batch(
        host, annealed_alpha(step, args),
        step_lib.learning_rates(optimizer, step - 1), jitter, args), device)
    stats = step_lib.train_step(model, optimizer, batch, args, generator)
    ok = _grads_finite(model) & torch.isfinite(stats.loss)
    finite = ok if finite is None else finite & ok
    losses.append(stats.loss)
    so3_norms.append(torch.sqrt(sum(
        (p.grad**2).sum() for p in model.path_sampler.so3_mlp.parameters()
        if p.grad is not None) + 0.0))
  torch.cuda.synchronize()
  rate = (n - 1) / (time.time() - t0)
  return ([float(x) for x in losses], rate, bool(finite),
          [float(x) for x in so3_norms])


def train_path_phase(args, scene, device, seed, host, profile=False):
  """Radiance then 'all' steps through train.step.train_step; returns the
  launch counts of K1, K2 and K3 during them and the 'all' model."""
  ndim, nmin, nmax, grid, bindings = scene
  gen = train_generators(device, seed)
  rad_args = argparse.Namespace(**{**vars(args), "stage": "radiance"})
  all_args = argparse.Namespace(**{**vars(args), "stage": "all"})
  rad = nerf.construct_nerf(rad_args, ndim, nmin, nmax, grid, bindings,
                            device=device, seed=seed)
  allm = nerf.construct_nerf(all_args, ndim, nmin, nmax, grid, bindings,
                             device=device, seed=seed)
  torch.cuda.synchronize()
  march_kernel.march_lean.launches = 0
  march_kernel.march_full.launches = 0
  eikonal_vjp.march_bwd.launches = 0
  losses, rate_r, ok_r, _ = _train_steps(rad, rad_args, host, device,
                                         TRAIN_FROM + 1, N_RADIANCE, gen)
  convert.load_into(allm, {k: v for k, v in rad.state_dict().items()
                           if k != "path_sampler.grid"})
  losses_a, rate_a, ok_a, so3 = _train_steps(
      allm, all_args, host, device, TRAIN_FROM + N_RADIANCE + 1, N_ALL, gen)
  counts = (march_kernel.march_lean.launches, march_kernel.march_full.launches,
            eikonal_vjp.march_bwd.launches)
  if profile:
    last = TRAIN_FROM + N_RADIANCE + N_ALL
    profile_train_step(rad, rad_args, host, device, last, gen)
    profile_train_step(allm, all_args, host, device, last, gen)
  del rad
  b = args.batch_size
  log(f"train path ({args.mlp_dtype} MLPs, batch {b}, env patch "
      f"{args.bg_patch_size}^2): radiance {N_RADIANCE} steps "
      f"{rate_r:.3f} steps/s {rate_r * b:.1f} rays/s; all {N_ALL} steps "
      f"{rate_a:.3f} steps/s {rate_a * b:.1f} rays/s (first step of each "
      f"untimed); launches K1 {counts[0]}, K2 {counts[1]}, K3 {counts[2]}")
  log(f"  radiance losses {losses}")
  log(f"  all losses {losses_a}, so3 grad norms {so3}")
  if not (ok_r and ok_a and np.all(np.isfinite(losses + losses_a))):
    raise SystemExit("train path: non-finite loss or gradient")
  if not np.mean(losses[-3:]) < np.mean(losses[:3]):
    raise SystemExit("train path: the radiance loss did not fall")
  if not all(np.isfinite(so3)) or min(so3) <= 0:
    raise SystemExit("train path: so3 gradients are zero or non-finite")
  if counts != (N_RADIANCE, N_ALL, N_ALL):
    raise SystemExit(f"train path: launches K1/K2/K3 {counts}, expected "
                     f"{(N_RADIANCE, N_ALL, N_ALL)}")
  return counts, allm, all_args, rate_r


def fused_train_phase(args, scene, device, seed, host, xla_rate,
                      profile=False):
  """Radiance steps with --mlp_kernel=pallas (bf16 MLPs, K4 forward, K5
  backward), then 'all' steps of a model built with the flag set, which
  keeps nn.Linear. Returns the K4 and K5 launches of the radiance steps
  and the radiance model."""
  ndim, nmin, nmax, grid, bindings = scene
  gen = train_generators(device, seed)
  fargs = argparse.Namespace(**{**vars(args), "stage": "radiance",
                                "mlp_kernel": "pallas"})
  rad = nerf.construct_nerf(fargs, ndim, nmin, nmax, grid, bindings,
                            device=device, seed=seed)
  torch.cuda.synchronize()
  mlp_kernel.mlp_fwd.launches = mlp_kernel.mlp_bwd.launches = 0
  losses, rate, ok, _ = _train_steps(rad, fargs, host, device,
                                     TRAIN_FROM + 1, N_RADIANCE, gen)
  counts = (mlp_kernel.mlp_fwd.launches, mlp_kernel.mlp_bwd.launches)
  b = args.batch_size
  log(f"fused train path (--mlp_kernel=pallas, {args.mlp_dtype} MLPs): "
      f"radiance {N_RADIANCE} steps {rate:.3f} steps/s {rate * b:.1f} "
      f"rays/s (nn.Linear: {xla_rate:.3f} steps/s); launches K4 "
      f"{counts[0]}, K5 {counts[1]}")
  log(f"  radiance losses {losses}")
  if not (ok and np.all(np.isfinite(losses))):
    raise SystemExit("fused train path: non-finite loss or gradient")
  if not np.mean(losses[-3:]) < np.mean(losses[:3]):
    raise SystemExit("fused train path: the radiance loss did not fall")
  if counts != (2 * N_RADIANCE, 2 * N_RADIANCE):
    raise SystemExit(f"fused train path: launches K4/K5 {counts}, expected "
                     f"{(2 * N_RADIANCE, 2 * N_RADIANCE)}")
  fall = argparse.Namespace(**{**vars(fargs), "stage": "all"})
  allm = nerf.construct_nerf(fall, ndim, nmin, nmax, grid, bindings,
                             device=device, seed=seed)
  convert.load_into(allm, {k: v for k, v in rad.state_dict().items()
                           if k != "path_sampler.grid"})
  torch.cuda.synchronize()
  mlp_kernel.mlp_fwd.launches = mlp_kernel.mlp_bwd.launches = 0
  losses_a, _, ok_a, _ = _train_steps(allm, fall, host, device,
                                      TRAIN_FROM + N_RADIANCE + 1,
                                      N_ALL_FUSED, gen)
  counts_a = (mlp_kernel.mlp_fwd.launches, mlp_kernel.mlp_bwd.launches)
  del allm
  log(f"  'all' with --mlp_kernel=pallas: {N_ALL_FUSED} steps, losses "
      f"{losses_a}, launches K4 {counts_a[0]}, K5 {counts_a[1]}")
  if not (ok_a and np.all(np.isfinite(losses_a))) or counts_a != (0, 0):
    raise SystemExit("fused train path: the 'all' stage must keep nn.Linear")
  if profile:
    profile_train_step(rad, fargs, host, device,
                       TRAIN_FROM + N_RADIANCE + N_ALL, gen)
  return counts, rad, fargs


class StepRecorder:
  """While entered, wraps step_lib.train_step and make_train_step_multi
  (train.loop's dispatch). Counts the steps run in Python (`calls`: the
  eager ones and those a capture records, each launching its kernels
  through their wrappers); after each eager step, and after each replay
  for the replay's last step, whether every gradient and the loss are
  finite and the so3 head's gradient norm; each window's losses and the
  host time after a sync. `runs` keeps the dispatches (their `replays`)."""

  def __init__(self):
    self.losses, self.so3, self.finite, self.times = [], [], [], []
    self.runs, self.calls = [], 0

  def _check(self, model, loss):
    grads = [p.grad for p in model.path_sampler.so3_mlp.parameters()
             if p.grad is not None]
    self.so3.append(torch.sqrt(sum((g**2).sum() for g in grads))
                    if grads else None)
    self.finite.append(_grads_finite(model) & torch.isfinite(loss))

  def __enter__(self):
    self.orig_step = step_lib.train_step
    self.orig_multi = step_lib.make_train_step_multi

    def stepping(model, optimizer, batch, args, generator=None):
      stats = self.orig_step(model, optimizer, batch, args, generator)
      self.calls += 1
      if not torch.cuda.is_current_stream_capturing():
        self._check(model, torch.as_tensor(stats.loss))
      return stats

    def making(*args, **kwargs):
      run = self.orig_multi(*args, **kwargs)
      self.runs.append(run)

      def recording(batch):
        replays = run.replays
        stats = run(batch)
        if run.replays > replays:
          self._check(run.model, stats.loss[-1])
        self.losses += list(stats.loss.unbind(0))
        torch.cuda.synchronize()
        self.times.append((time.time(), stats.loss.shape[0]))
        return stats

      return recording

    step_lib.train_step = stepping
    step_lib.make_train_step_multi = making
    return self

  def __exit__(self, *exc):
    step_lib.train_step = self.orig_step
    step_lib.make_train_step_multi = self.orig_multi

  def rate(self):
    """Steps/s after the first window."""
    steps = sum(n for _, n in self.times[1:])
    return steps / (self.times[-1][0] - self.times[0][0])

  def replays(self):
    return sum(run.replays for run in self.runs)


def _dispatch_state(model, optimizer):
  """Parameters and Adam state (moments, counts), cloned."""
  out = {f"param {n}": p.detach().clone()
         for n, p in model.named_parameters()}
  for i, st in optimizer.state_dict()["state"].items():
    out.update({f"adam {i} {n}": torch.as_tensor(t).clone()
                for n, t in st.items()})
  return out


# The kernels of K1, K2, K3 (its five launches) and K2 with the head off,
# by function name, as torch.profiler records them. The profiler can drop
# a kernel's record (kernel_device_ms), so a window's launches are traced
# in up to TRACE_TRIES windows, each profiled on its own.
K3_KERNELS = ("k3_pieces", "k3_jacobians", "k3_sweep", "k3_params",
              "k3_reduce")
MARCH_KERNELS = ("march_lean_kernel", "march_so3_kernel",
                 "march_full_plain_kernel") + K3_KERNELS
TRACE_TRIES = 3
# What a traced window records: its launches and device time are read
# from the kernels' records alone, and the host's operator records of
# eager steps take seconds to gather.
TRACE_ACTIVITIES = ("CUDA",)


def _march_kernels(counts):
  """{kernel name: launches} for K1/K2/K3/head-off launch counts, K3's
  count standing for each of its five kernels."""
  k1, k2, k3, head_off = counts
  return {"march_lean_kernel": k1, "march_so3_kernel": k2,
          "march_full_plain_kernel": head_off,
          **{name: k3 for name in K3_KERNELS}}


def _dispatch_run(sargs, scene, device, seed, hosts, k, span, want):
  """N_DISPATCH + up to TRACE_TRIES * span steps of sargs' stage from
  TRAIN_FROM + 1, k a dispatch (span a multiple of k), through
  loop.host_window and data/prefetch.py as train.loop takes them, from
  weights, noise and jitters drawn from `seed`. After the first
  N_DISPATCH steps, windows of `span` steps (a replay when k = span) are
  traced by torch.profiler one at a time until one holds `want`
  ({kernel name: launches}) or TRACE_TRIES were. Returns the first
  N_DISPATCH steps' Stats (floats), the state after them, the
  K1/K2/K3/head-off wrapper launches during them (the steps run in
  Python: eager and captured), the steps/s of their last `span`, the
  traced windows' {kernel name: launches}, the device ms a step of the
  last one, the dispatch, and the host seconds the traces took."""
  from torch.profiler import ProfilerActivity
  from torch.profiler import profile as tprofile
  ndim, nmin, nmax, grid, bindings = scene
  model = nerf.construct_nerf(sargs, ndim, nmin, nmax, grid, bindings,
                              device=device, seed=seed)
  optimizer, _, _ = step_lib.create_optimizer(model, sargs)
  # Under a process group (phase 15) as train.loop runs: rank 0's state,
  # and each window's replicated leaves broadcast on this thread.
  mesh.broadcast_module_state(model, optimizer)
  run = step_lib.make_train_step_multi(
      model, optimizer, sargs, k,
      torch.Generator(device=device).manual_seed(seed))
  jitter_gen = torch.Generator().manual_seed(seed)
  first = TRAIN_FROM + 1
  traced_from = TRAIN_FROM + N_DISPATCH
  windows = list(train_loop.dispatch_windows(
      first, traced_from + TRACE_TRIES * span, k))
  dataset, pending = iter(hosts), iter(windows)

  def next_window():
    w = next(pending, None)
    return None if w is None else train_loop.host_window(
        dataset, w[0], w[1], sargs, optimizer, jitter_gen)

  batches = prefetch.device_prefetch(next_window, device, stacked=True)
  stats, prof, traced, trace_s = [], None, [], 0.0
  activities = [getattr(ProfilerActivity, a) for a in TRACE_ACTIVITIES]
  torch.cuda.synchronize()
  _zero_march_counts()
  try:
    for (w0, w1), batch in zip(windows, batches):
      if w0 == traced_from - span + 1:
        torch.cuda.synchronize()
        t0 = time.time()
      if w0 > traced_from and (w0 - traced_from - 1) % span == 0:
        torch.cuda.synchronize()
        t_trace = time.time()
        prof = tprofile(activities=activities)
        prof.__enter__()
      mesh.broadcast_replicated(batch)
      out = run(batch)
      if w1 <= traced_from:
        stats += out.per_step()
      if w1 == traced_from:
        torch.cuda.synchronize()
        rate = span / (time.time() - t0)
        counts = _march_counts()
        state = _dispatch_state(model, optimizer)
      if prof is not None and (w1 - traced_from) % span == 0:
        torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        events = prof.key_averages()
        traced.append(kernel_launches(events, MARCH_KERNELS))
        device_ms = step_device_us(events) / 1e3 / span
        trace_s += time.time() - t_trace
        prof = None
        if traced[-1] == want:
          break
    torch.cuda.synchronize()
  finally:
    batches.close()
    if prof is not None:
      prof.__exit__(None, None, None)
  del model, optimizer
  return stats, state, counts, rate, traced, device_ms, run, trace_s


def dispatch_phase(args, scene, device, seed, card):
  """Each stage of the ship configuration at full width, resumed at
  TRAIN_FROM (the annealing alpha non-zero and changing every step): the
  first N_DISPATCH steps one at a time and K = args.steps_per_dispatch a
  dispatch (an eager window, then a CUDA graph replayed twice), from the
  same weights, batches, jitters and generator seeds. Every Stats field
  of every step, every parameter and Adam moment and count must be equal
  bit for bit. The wrappers must count K1 (radiance) or K2 and K3 ('all')
  once a step run in Python (all N_DISPATCH at K = 1; the eager window
  and the capture at K). A replay after them, traced by torch.profiler,
  must launch each K times, as K eager steps traced the same way do, and
  no traced window may launch more. Prints steps/s and the device ms of
  a step both ways. Returns {stage: (the wrapper launches of
  K1/K2/K3/head-off with K, those of one replay in the trace, the state
  after the N_DISPATCH steps at K, their Stats, the steps/s at K)}."""
  k = args.steps_per_dispatch
  if k < 2 or N_DISPATCH < 2 * k:
    raise SystemExit(f"dispatch: the ship configuration sets "
                     f"steps_per_dispatch {k}; the phase needs an eager "
                     f"window and a replay in {N_DISPATCH} steps")
  hosts = [synthetic_batch(args, seed + i)
           for i in range(N_DISPATCH + TRACE_TRIES * k)]
  out = {}
  for stage in ("radiance", "all"):
    sargs = argparse.Namespace(**{**vars(args), "stage": stage})
    per = lambda n: (n, 0, 0, 0) if stage == "radiance" else (0, n, n, 0)
    want_traced = _march_kernels(per(k))
    eager = _dispatch_run(sargs, scene, device, seed, hosts, 1, k,
                          want_traced)
    graph = _dispatch_run(sargs, scene, device, seed, hosts, k, k,
                          want_traced)
    torch.cuda.empty_cache()
    want_eager, want_graph = per(N_DISPATCH), per(2 * k)
    differ = [key for key in eager[1] if not torch.equal(eager[1][key],
                                                         graph[1][key])]
    steps_differ = [i for i, (a, b) in enumerate(zip(eager[0], graph[0]))
                    if a != b]
    log(f"dispatch ({stage}, ship at full width from step {TRAIN_FROM}, "
        f"{card}): K=1 {eager[3]:.3f} steps/s, {eager[5]:.3f} device ms a "
        f"step; K={k} {graph[3]:.3f} steps/s (a replay), {graph[5]:.3f} "
        f"device ms a step; device share {eager[3] * eager[5] / 1e3:.3f} "
        f"and {graph[3] * graph[5] / 1e3:.3f}; replays {graph[6].replays}")
    log(f"  wrapper launches K1/K2/K3/head-off in {N_DISPATCH} steps: K=1 "
        f"{eager[2]} (expected {want_eager}), K={k} {graph[2]} (the eager "
        f"window and the capture; expected {want_graph})")
    for name, run in (("K=1", eager), (f"K={k} (a replay each)", graph)):
      log(f"  traced windows of {k} steps after them, {name}: "
          f"{[list(t.values()) for t in run[4]]} for {list(want_traced)} "
          f"(expected {list(want_traced.values())})")
    log(f"  losses {[s.loss for s in graph[0][::10]]} (steps 1, 11, 21); "
        f"{len(eager[1])} tensors of state, {len(differ)} differ; "
        f"{len(steps_differ)} of {N_DISPATCH} steps' Stats differ")
    if differ or steps_differ or len(graph[0]) != N_DISPATCH:
      raise SystemExit(f"dispatch: K={k} is not K=1 bit for bit in "
                       f"{stage}: state {differ[:5]}, steps "
                       f"{steps_differ[:5]}")
    if eager[2] != want_eager or graph[2] != want_graph:
      raise SystemExit(f"dispatch: wrapper launches {eager[2]} and "
                       f"{graph[2]}, expected {want_eager} and {want_graph}")
    for run in (eager, graph):
      if run[4][-1] != want_traced or any(
          t[n] > want_traced[n] for t in run[4] for n in t):
        raise SystemExit(f"dispatch: traced launches {run[4]}, expected "
                         f"{want_traced}")
    if graph[6].replays != N_DISPATCH // k - 1 + len(graph[4]):
      raise SystemExit(f"dispatch: {graph[6].replays} replays")
    if len({s.loss for s in graph[0]}) != N_DISPATCH:
      raise SystemExit("dispatch: two steps gave the same loss")
    t = graph[4][-1]
    out[stage] = (graph[2], (t["march_lean_kernel"], t["march_so3_kernel"],
                             t["k3_sweep"], t["march_full_plain_kernel"]),
                  graph[1], graph[0], graph[3])
  return out


def _free_port():
  with socket.socket() as sock:
    sock.bind(("127.0.0.1", 0))
    return sock.getsockname()[1]


def _rank_env(rank, world, port):
  """torchrun's variables of one rank on this machine (every rank on
  cuda:0)."""
  return {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": "0",
          "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}


def _nccl_world_one(args, scene, seed, card, dispatch):
  """Phase 6b's dispatch (both stages, N_DISPATCH steps at the ship's K,
  then the traced replays) as rank 0 of an NCCL group of world 1 made by
  parallel/mesh.process_group from torchrun's variables: the gradients'
  all-reduce and the Stats' are captured in the graph. Every Stats field,
  parameter and Adam moment must be phase 6b's bit for bit, the wrapper
  and traced launches as there. Returns {stage: figures}."""
  k = args.steps_per_dispatch
  hosts = [synthetic_batch(args, seed + i)
           for i in range(N_DISPATCH + TRACE_TRIES * k)]
  out = {}
  with mock.patch.dict(os.environ, _rank_env(0, 1, _free_port())), \
      mesh.process_group("cuda") as dev:
    if (mesh.backend(), mesh.world()) != ("nccl", 1):
      raise SystemExit(f"parallel: expected an NCCL group of world 1, got "
                       f"{mesh.backend()} of {mesh.world()}")
    for stage in ("radiance", "all"):
      sargs = argparse.Namespace(**{**vars(args), "stage": stage})
      per = lambda n: (n, 0, 0, 0) if stage == "radiance" else (0, n, n, 0)
      want_traced = _march_kernels(per(k))
      t0 = time.time()
      stats, state, counts, rate, traced, device_ms, run, _ = _dispatch_run(
          sargs, scene, dev, seed, hosts, k, k, want_traced)
      secs = time.time() - t0
      _, _, want_state, want_stats, want_rate = dispatch[stage]
      differ = [key for key in want_state
                if not torch.equal(state[key], want_state[key])]
      steps_differ = [i for i, (a, b) in enumerate(zip(stats, want_stats))
                      if a != b]
      log(f"parallel, NCCL world 1 ({stage}, ship at full width from step "
          f"{TRAIN_FROM}, {card}): K={k} {rate:.3f} steps/s (phase 6b "
          f"{want_rate:.3f}), {device_ms:.3f} device ms a step, replays "
          f"{run.replays}, {secs:.1f} s; wrapper launches {counts}; traced "
          f"{[list(t.values()) for t in traced]}; {len(differ)} of "
          f"{len(want_state)} state tensors and {len(steps_differ)} of "
          f"{N_DISPATCH} steps' Stats differ from phase 6b's")
      if differ or steps_differ or len(stats) != N_DISPATCH:
        raise SystemExit(f"parallel: NCCL world 1 is not phase 6b bit for "
                         f"bit in {stage}: state {differ[:5]}, steps "
                         f"{steps_differ[:5]}")
      if counts != per(2 * k) or traced[-1] != want_traced:
        raise SystemExit(f"parallel: launches {counts}, traced {traced}")
      out[stage] = {"steps_s": rate, "phase6b_steps_s": want_rate,
                    "device_ms": device_ms, "seconds": secs}
  if mesh.active():
    raise SystemExit("parallel: the process group outlived its entry point")
  return out


def _k3_ratio(got, want):
  """The largest |got - want| over K3's form, 2e-4 * max|want| + 2e-3 *
  |want|, of a tensor (<= 1 passes)."""
  tol = K3_ATOL_SCALE * float(want.abs().max()) + K3_RTOL * want.abs()
  return float(((got - want).abs() / tol.clamp_min(1e-30)).max())


def _two_gloo_ranks(args, scene, scene_spec, seed, device, view, jitter):
  """N_PARALLEL radiance and 'all' steps of the ship model at K = 1 on
  1024-ray batches, the radiance batch's forward and the view, by two
  ranks of debug/dist_worker.py over gloo with CUDA tensors on the one
  card (512 rays a rank), against dist_worker.run in this process on the
  whole batches, each of whose steps starts from the weights and Adam
  state rank 0 had before it (dist_worker's force_states: a gradient
  near 0 that rounds apart turns into a +-lr update, and later steps
  would compare different weights). `scene` is the scene of `scene_spec`
  (dist_worker's spec["scene"], which the ranks build). Each rank's Stats within PARALLEL_STATS_RTOL, its
  gradients at K3's form, the view within PARALLEL_RENDER_ATOL, both
  ranks' parameters and moments equal bit for bit, each rank's K1/K2/K3
  launches as its steps and chunks imply. Returns the figures."""
  nc, npath = args.num_coarse_samples, args.num_path_samples
  hosts = [synthetic_batch(args, seed + i) for i in range(N_PARALLEL)]
  steps = [{"host": hosts[i], "alpha": annealed_alpha(TRAIN_FROM + 1 + i,
                                                      args),
            "count": TRAIN_FROM + i,
            "jitter": nerf.make_jitter(nc, npath, torch.Generator()
                                       .manual_seed(seed + i))}
           for i in range(N_PARALLEL)]
  radiance = {"stage": "radiance"}
  fp32 = {"mlp_dtype": "float32"}
  spec = {
      "device": device.type, "backend": "gloo", "args": vars(args),
      "scene": scene_spec, "seed": seed,
      "runs": [
          {"name": "radiance", "kind": "train", "k": 1, "noise_seed": seed,
           "args": {**radiance, **fp32}, "steps": steps,
           "record_states": True},
          {"name": "all", "kind": "train", "k": 1, "noise_seed": seed,
           "args": {"stage": "all", **fp32}, "steps": steps,
           "record_states": True},
          {"name": "radiance bf16", "kind": "train", "k": 1,
           "noise_seed": seed, "args": radiance, "steps": steps,
           "record_states": True},
          {"name": "forward", "kind": "forward", "args": radiance,
           "host": hosts[0], "alpha": steps[0]["alpha"], "jitter": jitter},
          {"name": "render", "kind": "render", "args": radiance,
           "view": view, "jitter": jitter, "chunk": args.chunk}]}
  chunks = -(-view.origins.shape[0] * view.origins.shape[1] // args.chunk)
  want_launches = {"radiance": (N_PARALLEL, 0, 0, 0),
                   "radiance bf16": (N_PARALLEL, 0, 0, 0),
                   "all": (0, N_PARALLEL, N_PARALLEL, 0),
                   "render": (chunks, 0, 0, 0)}
  figures = {}
  with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "spec.pt")
    torch.save(spec, path)
    port = _free_port()
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "samplenerfro_torch.debug.dist_worker", path,
         os.path.join(tmp, "pair")], cwd=root,
        env={**os.environ, **_rank_env(r, 2, port)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
      outs = [p.communicate(timeout=PARALLEL_TIMEOUT_S)[0] for p in procs]
    finally:
      for p in procs:
        if p.poll() is None:
          p.kill()
          p.wait()
    figures["pair_s"] = time.time() - t0
    for r, (p, text) in enumerate(zip(procs, outs)):
      if p.returncode != 0:
        raise SystemExit(f"parallel: gloo rank {r} exited {p.returncode}:\n"
                         f"{text[-3000:]}")
    got = [torch.load(os.path.join(tmp, f"pair.{r}"), weights_only=False)
           for r in range(2)]
  forced = {**spec, "runs": [
      {**run, "record_states": False,
       "force_states": got[0][run["name"]]["states"]}
      if run["kind"] == "train" else run for run in spec["runs"]]}
  t0 = time.time()
  want = dist_worker.run(forced, device, scene=scene)
  figures["single_s"] = time.time() - t0
  fields = [f.name for f in dataclasses.fields(step_lib.Stats)]
  fails = []
  for name in ("radiance", "all", "radiance bf16"):
    w = want[name]
    for r, out in enumerate(got):
      g = out[name]
      # Per step: the largest relative Stats difference, and the largest
      # ratio to K3's form with its tensor.
      stats_rel = [max([abs(a[f] - b[f]) / max(abs(b[f]), 1e-30)
                        for f in fields if a[f] != b[f]] + [0.0])
                   for a, b in zip(g["stats"], w["stats"])]
      grads = [max((_k3_ratio(a[key], b[key]), key) for key in b)
               for a, b in zip(g["grads"], w["grads"])]
      figures[f"{name} rank {r}"] = {
          "stats_rel": stats_rel, "grad_k3_ratio": [x for x, _ in grads],
          "launches": g["launches"], "seconds": g["seconds"]}
      log(f"parallel, gloo rank {r} of 2 ({name}, {N_PARALLEL} steps at "
          f"K=1, half of {args.batch_size} rays): Stats within "
          f"{[f'{x:.2e}' for x in stats_rel]} relative, gradients at "
          f"{[f'{x:.4f}' for x, _ in grads]} of K3's form (worst "
          f"{max(grads)[1]}), K1/K2/K3/head-off launches {g['launches']} "
          f"(expected {want_launches[name]}), {g['seconds']:.2f} s (one "
          f"process {w['seconds']:.2f} s)")
      stats_rel, grad_ratio = max(stats_rel), max(grads)[0]
      if name.endswith("bf16"):
        pass  # printed, not held (see PARALLEL_STATS_RTOL)
      elif stats_rel > PARALLEL_STATS_RTOL or grad_ratio > 1:
        fails.append(f"{name} rank {r}: Stats {stats_rel}, grads "
                     f"{grad_ratio}")
      if g["launches"] != want_launches[name]:
        fails.append(f"{name} rank {r}: launches {g['launches']}")
      if len(g["stats"]) != N_PARALLEL:
        fails.append(f"{name} rank {r}: {len(g['stats'])} steps")
    differ = [key for key in got[0][name]["state"]
              if not torch.equal(got[0][name]["state"][key],
                                 got[1][name]["state"][key])]
    if differ:
      fails.append(f"{name}: the ranks' states differ in {differ[:5]}")
  w = want["render"]
  for r, out in enumerate(got):
    g = out["render"]
    err = max(float(np.abs(g[key] - w[key]).max())
              for key in ("rgb", "distance", "acc"))
    same = all(np.array_equal(g[key], w[key])
               for key in ("rgb", "distance", "acc"))
    lo, hi = out["forward"]["rows"]
    fwd = out["forward"]["rgb"]
    fwd_same = torch.equal(fwd, want["forward"]["rgb"][lo:hi])
    fwd_err = float((fwd - want["forward"]["rgb"][lo:hi]).abs().max())
    figures[f"render rank {r}"] = {
        "max_abs_err": err, "bit_for_bit": same,
        "forward_bit_for_bit": fwd_same, "forward_max_abs_err": fwd_err,
        "launches": g["launches"], "seconds": g["seconds"]}
    log(f"parallel, gloo rank {r} of 2: forward rows [{lo}, {hi}) of the "
        f"radiance batch bit for bit one process's: {fwd_same} (max "
        f"{fwd_err:.3e}); the {view.origins.shape[:2]} view, half of each "
        f"chunk: bit "
        f"for bit {same}, max abs {err:.3e}, K1 launches "
        f"{g['launches'][0]} (expected {chunks}), {g['seconds']:.2f} s "
        f"(one process {w['seconds']:.2f} s)")
    if err > PARALLEL_RENDER_ATOL or g["launches"] != want_launches["render"]:
      fails.append(f"render rank {r}: {err}, launches {g['launches']}")
  log(f"parallel, gloo: one process {figures['single_s']:.1f} s, two ranks "
      f"{figures['pair_s']:.1f} s with their start and model build")
  if fails:
    raise SystemExit(f"parallel: {fails}")
  return figures


def parallel_phase(args, scene, device, seed, card, dispatch, view, jitter):
  """Phase 15: _nccl_world_one, then _two_gloo_ranks. Returns (the K1,
  K2 and K3 launches of rank 0's steps and view, the figures)."""
  t_phase = time.time()
  figures = {"nccl": _nccl_world_one(args, scene, seed, card, dispatch)}
  torch.cuda.empty_cache()
  figures["gloo"] = _two_gloo_ranks(args, scene, {"ship": seed}, seed,
                                    device, view, jitter)
  figures["seconds"] = time.time() - t_phase
  log(f"parallel: phase {figures['seconds']:.1f} s ({card})")
  g = figures["gloo"]
  rank0 = (g["radiance rank 0"]["launches"][0]
           + g["render rank 0"]["launches"][0],
           g["all rank 0"]["launches"][1], g["all rank 0"]["launches"][2])
  return rank0, figures


def _zero_march_counts():
  for fn in (march_kernel.march_lean, march_kernel.march_full,
             eikonal_vjp.march_bwd, march_kernel.march_full_plain):
    fn.launches = 0
    fn.arms.clear()


def _march_counts():
  """Launches of K1, K2, K3 and K2 with the head off."""
  return (march_kernel.march_lean.launches, march_kernel.march_full.launches,
          eikonal_vjp.march_bwd.launches,
          march_kernel.march_full_plain.launches)


def real_scene_phase(device, seed):
  """Glass's shipped configuration on a synthetic OpenCV capture
  (debug/real_scene.py: 8 train views of 320x240, an off-centre principal
  point, a 384^3 blob of extent 3.5 filling the view, in
  voxelize_uni384_bbox-3.5) through
  the entry points: `train` radiance (N_REAL_RADIANCE steps and one
  validation render), `train` all (N_REAL_ALL steps), then `eval` of the
  all stage's checkpoint. Returns the K1, K2 and K3 launches of each."""
  t0 = time.time()
  with tempfile.TemporaryDirectory() as tmp:
    data = real_scene.write_scene(os.path.join(tmp, "glass"))
    log(f"real scene: {real_scene.NUM_TRAIN} train views of 320x240, "
        f"{real_scene.GLASS_GRID} (384^3, extent 3.5), written in "
        f"{time.time() - t0:.1f} s")
    common = [f"--data_dir={data}", f"--train_dir={os.path.join(tmp, 'logs')}",
              f"--config={GLASS_CONFIG}", f"--gin_file={GLASS_CONFIG}.gin",
              f"--seed={seed}", f"--device={device}", *FP32_FLAGS]
    every = lambda n, render: [f"--max_steps={n}", f"--save_every={n}",
                               f"--print_every={n}",
                               f"--render_every={n if render else 0}"]
    counts = {}
    _zero_march_counts()
    with StepRecorder() as rad_rec:
      rad = train_loop.main(common + ["--stage=radiance"]
                            + every(N_REAL_RADIANCE, True))
    counts["radiance"] = _march_counts()
    cut_box = rad.cut_box
    cut_cross_check(rad, data, device, seed)
    del rad
    _zero_march_counts()
    with StepRecorder() as all_rec:
      allm = train_loop.main(common + ["--stage=all"]
                             + every(N_REAL_ALL, False))
    counts["all"] = _march_counts()
    ckpts = {stage: sorted(os.listdir(os.path.join(tmp, "logs", stage)))
             for stage in ("radiance", "all")}
    _zero_march_counts()
    t1 = time.time()
    res = eval_lib.main(common + ["--stage=all"])
    eval_secs = time.time() - t1
    counts["eval"] = _march_counts()

    # The model train returned, rendered here on eval's view with eval's
    # jitter: eval must have rendered the checkpoint it wrote.
    args, _, _ = config_lib.load_args(
        GLASS_CONFIG, [GLASS_CONFIG + ".gin"], [], stage="all", **FP32_ARMS)
    args.data_dir = data
    rays, images = datasets.load_split(args, "test")
    view, pixels = datasets.eval_view(args, rays, images, 0)
    jitter = nerf.make_jitter(args.num_coarse_samples, args.num_path_samples,
                              torch.Generator().manual_seed(seed))
    cut = []
    orig_cut = nerf.NerfModel._bd_cut_mask

    def recording_cut(model, pos):
      mask = orig_cut(model, pos)
      cut.append((mask.sum(), mask.numel()))
      return mask

    nerf.NerfModel._bd_cut_mask = recording_cut
    try:
      torch.cuda.synchronize()
      t1 = time.time()
      rgb, disp, acc = render_lib.render_image(
          make_render_fn(allm, jitter), view, False, chunk=args.chunk,
          device=device,
          chunks_per_dispatch=args.render_chunks_per_dispatch)
      torch.cuda.synchronize()
      render_secs = time.time() - t1
    finally:
      nerf.NerfModel._bd_cut_mask = orig_cut
    # The same view one chunk a call: bit for bit the grouped render.
    one = render_lib.render_image(make_render_fn(allm, jitter), view, False,
                                  chunk=args.chunk, device=device)
    grouped_exact = all(np.array_equal(a, b)
                        for a, b in zip((rgb, disp, acc), one))
  psnr = metrics.compute_psnr(((rgb - pixels)**2).mean())
  ssim = float(metrics.compute_ssim(rgb, pixels, 1.0))
  ones = float(sum(c[0] for c in cut))
  total = sum(c[1] for c in cut)
  n_rays = view.origins.shape[0] * view.origins.shape[1]
  n_chunks = -(-n_rays // args.chunk)
  # The wrappers count the steps run in Python (the eager ones and the
  # capture's) and the render's chunks; a replay launches through none.
  k = args.steps_per_dispatch
  want = {"radiance": (rad_rec.calls + n_chunks, 0, 0, 0),
          "all": (0, all_rec.calls, all_rec.calls, 0),
          "eval": (0, n_chunks, 0, 0)}
  python_steps = [n - k * rec.replays() + k * min(rec.replays(), 1)
                  for n, rec in ((N_REAL_RADIANCE, rad_rec),
                                 (N_REAL_ALL, all_rec))]
  so3 = [float(x) for x in all_rec.so3]
  losses = ([float(x) for x in rad_rec.losses],
            [float(x) for x in all_rec.losses])
  finite = bool(all(bool(f) for f in rad_rec.finite + all_rec.finite))
  log(f"real-scene path ({GLASS_CONFIG}, {time.time() - t0:.1f} s, "
      f"{args.steps_per_dispatch} steps a dispatch): radiance "
      f"{N_REAL_RADIANCE} steps {rad_rec.rate():.3f} steps/s, all "
      f"{N_REAL_ALL} steps {all_rec.rate():.3f} steps/s (the windows after "
      f"the first, the capture included); replays radiance "
      f"{rad_rec.replays()}, all {all_rec.replays()}; eval "
      f"{eval_secs:.1f} s with its model build; the "
      f"{view.origins.shape[1]}x{view.origins.shape[0]} test view "
      f"{n_rays / render_secs:.1f} rays/s ({n_chunks} chunks, "
      f"{args.render_chunks_per_dispatch} a dispatch; bit for bit one a "
      f"call: {grouped_exact})")
  log(f"  radiance losses {losses[0]}")
  log(f"  all losses {losses[1]}, so3 grad norms {so3}")
  log(f"  eval: PSNR {res.psnrs}, SSIM {res.ssims}, step {res.step}; the "
      f"returned model on the same view: PSNR {psnr}, SSIM {ssim}")
  log(f"  cut box {cut_box}: {ones / total:.4f} of the fine samples kept "
      f"by the cut; acc mean {float(acc.mean()):.6f}")
  log(f"  wrapper launches K1/K2/K3/head-off: radiance "
      f"{counts['radiance']}, all {counts['all']}, eval {counts['eval']} "
      f"(expected {want}); steps run in Python (eager and captured): "
      f"radiance {rad_rec.calls}, all {all_rec.calls} (expected "
      f"{python_steps})")
  log(f"  checkpoints {ckpts}")
  if not (finite and np.all(np.isfinite(losses[0] + losses[1]))):
    raise SystemExit("real-scene path: non-finite loss or gradient")
  if not all(np.isfinite(so3)) or min(so3) <= 0:
    raise SystemExit("real-scene path: so3 gradients are zero or non-finite")
  if ckpts != {"radiance": [f"checkpoint_{N_REAL_RADIANCE}"],
               "all": [f"checkpoint_{N_REAL_ALL}"]}:
    raise SystemExit(f"real-scene path: checkpoints {ckpts}")
  if res.step != N_REAL_ALL or res.psnrs != [psnr] or res.ssims != [ssim]:
    raise SystemExit("real-scene path: eval did not render the trained "
                     "checkpoint")
  if not 0 < ones < total:
    raise SystemExit(f"real-scene path: the cut mask is all "
                     f"{'ones' if ones else 'zeros'} over the view")
  if counts != want or [rad_rec.calls, all_rec.calls] != python_steps:
    raise SystemExit(f"real-scene path: launches {counts}, expected {want}; "
                     f"steps run in Python {rad_rec.calls}, "
                     f"{all_rec.calls}, expected {python_steps}")
  if args.steps_per_dispatch < 2 or min(rad_rec.replays(),
                                        all_rec.replays()) < 1:
    raise SystemExit("real-scene path: a stage replayed no window")
  if args.render_chunks_per_dispatch < 2 or not grouped_exact:
    raise SystemExit("real-scene path: the grouped render is not the "
                     "one-chunk render bit for bit")
  return counts


def cut_cross_check(model, data, device, seed):
  """One radiance step's loss on a train batch of the real scene with the
  boundary cut, at annealed alpha CUT_ALPHA so that the background loss
  (trans > 0.5 from the cut's re-render) counts: the card (K1) against the
  CPU (plain K1), fp32 MLPs, not randomized, the density lowered to
  sigma_bias CUT_SIGMA_BIAS. The loss and loss_bg agree to
  XCHECK_LOSS_RTOL, loss_bg > 0, the rays over trans 0.5 are the same on
  both, and bkgd_mlp's gradients (loss_bg's way into training) agree at
  the K5 fp32 tolerance. Leaves the model on the CPU, its density
  lowered."""
  args, _, _ = config_lib.load_args(GLASS_CONFIG, [GLASS_CONFIG + ".gin"],
                                    [], stage="radiance", **FP32_ARMS)
  args.data_dir, args.randomized = data, False
  host = next(datasets.TrainBatches(args, np.random.RandomState(seed)))
  model.mlp_dtype, model.sigma_bias = torch.float32, CUT_SIGMA_BIAS
  jitter = nerf.make_jitter(args.num_coarse_samples, args.num_path_samples,
                            torch.Generator().manual_seed(seed))
  trans = []

  def record(module, inputs, out):
    trans.append(out[0][-1][3].detach().cpu())

  def run(dev):
    model.zero_grad(set_to_none=True)
    handle = model.register_forward_hook(record)
    try:
      total, stats = step_lib.loss_fn(model, prefetch.to_device(
          step_batch(host, CUT_ALPHA, None, jitter, args), dev), args)
    finally:
      handle.remove()
    total.backward()
    return (float(total.detach()), float(stats.loss_bg),
            [p.grad.detach().cpu().clone()
             for p in model.bkgd_mlp.parameters()])

  loss_gpu, bg_gpu, g_gpu = run(device)
  model.to("cpu")
  t0 = time.time()
  loss_cpu, bg_cpu, g_cpu = run(torch.device("cpu"))
  secs = time.time() - t0
  rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
  rel_bg = abs(bg_gpu - bg_cpu) / max(abs(bg_cpu), 1e-30)
  over = [t > 0.5 for t in trans]
  same = bool(torch.equal(over[0], over[1]))
  worst = _worst_against(g_gpu, g_cpu)
  log(f"real-scene cut cpu cross-check: radiance step, {over[0].numel()} "
      f"rays, alpha {CUT_ALPHA}, in {secs:.1f} s on the CPU: loss "
      f"{loss_gpu:.8f} vs {loss_cpu:.8f} (rel {rel:.3e}), loss_bg "
      f"{bg_gpu:.8f} vs {bg_cpu:.8f} (rel {rel_bg:.3e}; tolerance "
      f"{XCHECK_LOSS_RTOL}); {int(over[0].sum())} rays over trans 0.5 on "
      f"the card, {int(over[1].sum())} on the CPU, the same rays: {same}; "
      f"trans max abs err {float((trans[0] - trans[1]).abs().max()):.3e}; "
      f"bkgd_mlp grads at {worst:.3f} of the K5 tolerance")
  if not (bg_gpu > 0 and rel <= XCHECK_LOSS_RTOL
          and rel_bg <= XCHECK_LOSS_RTOL and same and worst <= 1.0):
    raise SystemExit("real-scene cut cpu cross-check failed")


def allstep_cross_check(model, args, host, device, seed, what="shipped",
                        hold="cpu"):
  """One 'all' step's loss and so3 gradients on XCHECK_RAYS rays, fp32
  MLPs, not randomized: the card (K2, K3) against the CPU (plain), and
  against the plain versions on the card. The loss is held card against
  CPU; the so3 gradients at the K3 form against the CPU's (hold "cpu")
  or, where the plain versions alone differ between the devices past it
  (hold "card"; measured with IPE, whose features scale the paths by up
  to 2^9), against the plain versions on the card. `what` names the
  model's options."""
  sub = dict(host)
  sub["rays"] = rays_lib.namedtuple_map(lambda r: r[:XCHECK_RAYS],
                                        host["rays"])
  sub["pixels"] = host["pixels"][:XCHECK_RAYS]
  xargs = argparse.Namespace(**{**vars(args), "randomized": False})
  model.mlp_dtype = torch.float32
  jitter = nerf.make_jitter(args.num_coarse_samples, args.num_path_samples,
                            torch.Generator().manual_seed(seed))
  alpha = annealed_alpha(TRAIN_FROM + N_RADIANCE + N_ALL, args)
  paths = []

  def record(module, inputs, out):
    paths.append((out[0].detach(), out[4].detach()))

  def run(dev):
    model.zero_grad(set_to_none=True)
    handle = model.path_sampler.register_forward_hook(record)
    try:
      total, _ = step_lib.loss_fn(model, prefetch.to_device(
          step_batch(sub, alpha, None, jitter, xargs), dev), xargs)
    finally:
      handle.remove()
    total.backward()
    grads = [p.grad.detach().cpu().clone()
             for p in model.path_sampler.so3_mlp.params()]
    return float(total.detach()), grads

  loss_gpu, g_gpu = run(device)
  # The plain versions on the card (the plain march, autograd, cuBLAS):
  # which side of kernels / device a deviation lies on. Not a gate.
  saved = march_kernel.march_full, eikonal_vjp.march_bwd
  march_kernel.march_full = march_kernel.march_full_reference
  eikonal_vjp.march_bwd = (
      lambda cfg, data, o, d, so3, a, traj, dtraj:
      eikonal_vjp.march_bwd_reference(cfg, data, o, d, so3, a, dtraj))
  try:
    _, g_plain = run(device)
  finally:
    march_kernel.march_full, eikonal_vjp.march_bwd = saved
  paths.pop()
  so3 = [p.detach() for p in model.path_sampler.so3_mlp.params()]
  card_pre = [x.cpu() for x in probes.so3_preacts(
      paths[0][0].reshape(-1, 3).contiguous(), so3, alpha)]
  model.to("cpu")
  t0 = time.time()
  loss_cpu, g_cpu = run(torch.device("cpu"))
  secs = time.time() - t0
  rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
  worst = _worst_against(g_gpu, g_cpu, K3_ATOL_SCALE, K3_RTOL)
  on_card = _worst_against(g_gpu, g_plain, K3_ATOL_SCALE, K3_RTOL)
  log(f"all-step cpu cross-check ({what}): {XCHECK_RAYS} rays in "
      f"{secs:.1f} s, loss "
      f"{loss_gpu:.8f} vs {loss_cpu:.8f} (rel {rel:.3e}, tolerance "
      f"{XCHECK_LOSS_RTOL}), so3 grads at {worst:.3f} of the K3 tolerance")
  log(f"  the plain versions on the card: so3 grads at {on_card:.3f} of "
      f"the K3 tolerance from the kernels', "
      f"{_worst_against(g_plain, g_cpu, K3_ATOL_SCALE, K3_RTOL):.3f} from "
      f"the CPU's; held: {'card' if hold == 'card' else 'CPU'}")
  layers, card_pre, flipped = cross_check_flips(
      paths[0][1].cpu(), card_pre, *paths[1], [p.cpu() for p in so3], alpha)
  n_flips = sum(r["flips"] for r in layers)
  log(f"  P3 on those rays, K3's sums at the card's path against the plain "
      f"version's at the CPU's, per layer (ReLU flips, min |pre-activation| "
      f"on the CPU) over the ray-steps active on both: "
      f"{[(r['flips'], r['min_abs']) for r in layers]}")
  if n_flips:
    saved = march_kernel.so3_refine_fn
    march_kernel.so3_refine_fn = probe_so3_relu.replaying_refine_fn(
        card_pre, flipped)
    try:
      _, g_replayed = run(torch.device("cpu"))
    finally:
      march_kernel.so3_refine_fn = saved
    log(f"  the CPU step again with those {n_flips} masks set as on the card:"
        f" so3 grads at "
        f"{_worst_against(g_gpu, g_replayed, K3_ATOL_SCALE, K3_RTOL):.3f} of "
        f"the K3 tolerance")
  held = on_card if hold == "card" else worst
  if not (rel <= XCHECK_LOSS_RTOL and held <= 1.0):
    raise SystemExit(f"all-step cpu cross-check ({what}) failed")


def cross_check_flips(g_card, card_pre, pos_cpu, g_cpu, so3_cpu, alpha):
  """ReLU masks that the card's 'all' step (K3's sums, P3 at K2's path)
  and the CPU's (the plain version, called a step at a time on all rays as
  the plain march calls the head) set apart, per layer 1-3, at the
  ray-steps active on both. Returns (relu_flips' summary per layer, the
  card's [B, S, W] pre-activations, the [B, S, W] masks of the flips)."""
  cpu_pre = [w for _, w in probes.so3_preacts_by_step(pos_cpu, so3_cpu,
                                                       alpha)]
  card_pre = [c.reshape(w.shape) for c, w in zip(card_pre, cpu_pre)]
  active = (g_card.norm(dim=-1) > 1e-3) & (g_cpu.norm(dim=-1) > 1e-3)
  flipped = [((c > 0) != (w > 0)) & active[..., None]
             for c, w in zip(card_pre, cpu_pre)]
  return (probes.relu_flips(card_pre, cpu_pre, mask=active), card_pre,
          flipped)


def _to_cpu(tree):
  if isinstance(tree, torch.Tensor):
    return tree.cpu()
  if isinstance(tree, tuple):
    return tuple(_to_cpu(t) for t in tree)
  return tree


def _worst_against(got, want, atol_scale=K5_ATOL_SCALE, rtol=K5_RTOL):
  """Worst |got - want| over atol_scale * max|want| + rtol * |want| (the
  K5 fp32 tolerance unless given) across tensors."""
  worst = 0.0
  for g, w in zip(got, want):
    scale = float(w.abs().max())
    if scale > 0:
      worst = max(worst, float(((g - w).abs() / (
          atol_scale * scale + rtol * w.abs())).max()))
  return worst


def fused_cross_check(model, args, host, device, seed):
  """One fused radiance step's loss and coarse/fine MLP gradients on
  XCHECK_RAYS rays, fp32, not randomized: the card (K4, K5) against the
  CPU (their plain versions), the CPU step replaying the card's march
  paths and fine-sample placement.

  Replayed, because K1 and the plain march differ by ulps, and the coarse
  weights that place the fine samples by the order of the MLP sums; the
  fine samples' 2^9 encoding turns either into weight-gradient differences
  of its own. The comparison without the replay is printed for the fused
  and for the nn.Linear step, which stand alike. Where K4's sums and the
  CPU's set a ReLU mask apart (a pre-activation at 0), the CPU's backward
  replays K4's activations, as the K3 checks replay P3's flips; the
  comparison without that replay is printed. Returns K5's launches on the
  card."""
  sub = dict(host)
  sub["rays"] = rays_lib.namedtuple_map(lambda r: r[:XCHECK_RAYS],
                                        host["rays"])
  sub["pixels"] = host["pixels"][:XCHECK_RAYS]
  xargs = argparse.Namespace(**{**vars(args), "randomized": False})
  model.mlp_dtype = torch.float32
  jitter = nerf.make_jitter(args.num_coarse_samples, args.num_path_samples,
                            torch.Generator().manual_seed(seed))
  alpha = annealed_alpha(TRAIN_FROM + N_RADIANCE, args)
  mlps = (model.coarse_mlp, model.fine_mlp)
  sample_pdf = render_ops.sample_pdf

  fwd, bwd = mlp_kernel.mlp_fwd, mlp_kernel.mlp_bwd
  card_acts, flips = {}, [0]

  def fwd_recording(spec, params, x, cond, dtype, pack=None, acts=None):
    """K4, its activations kept by row count (coarse and fine differ)."""
    got = {}
    mlp_kernel.mlp_fwd = fwd  # K4 counts its launches on its own name
    try:
      out = fwd(spec, params, x, cond, dtype, pack=pack, acts=got)
    finally:
      mlp_kernel.mlp_fwd = fwd_recording
    card_acts[x.shape[0]] = {k: v.cpu() for k, v in got.items()}
    return out

  def bwd_replaying(spec, params, x, cond, drgb, dsigma, dtype, pack=None):
    """The plain K5 at K4's activations; counts the masks they move."""
    card, own = card_acts[x.shape[0]], {}
    mlp_kernel.fused_nerf_mlp_bwd_reference(spec, params, x, cond, drgb,
                                            dsigma, dtype, stored=own)
    flips[0] += sum(int(((card[k] > 0) != (own[k] > 0)).sum())
                    for k in card)
    return mlp_kernel.fused_nerf_mlp_bwd_reference(
        spec, params, x, cond, drgb, dsigma, dtype, at=card)

  def run(dev, kernel, record=None, replay=None, masks=False):
    """loss and MLP gradients of one step; record appends the march and
    sample_pdf outputs (and K4's activations), replay returns the recorded
    ones (and with masks, K4's activations to the backward)."""
    def pdf(*a, **k):
      if replay is not None:
        return replay[1]
      out = sample_pdf(*a, **k)
      if record is not None:
        record.append(_to_cpu(out))
      return out

    def march(module, inputs, out):
      if replay is not None:
        return replay[0]
      if record is not None:
        record.append(_to_cpu(out))
      return None

    model.mlp_kernel = kernel
    handle = model.path_sampler.register_forward_hook(march)
    render_ops.sample_pdf = pdf
    if record is not None and kernel == "pallas":
      mlp_kernel.mlp_fwd = fwd_recording
    if masks:
      mlp_kernel.mlp_bwd = bwd_replaying
    try:
      model.zero_grad(set_to_none=True)
      total, _ = step_lib.loss_fn(model, prefetch.to_device(
          step_batch(sub, alpha, None, jitter, xargs), dev), xargs)
      total.backward()
    finally:
      handle.remove()
      render_ops.sample_pdf = sample_pdf
      mlp_kernel.mlp_fwd, mlp_kernel.mlp_bwd = fwd, bwd
    grads = [p.grad.detach().cpu().clone() for m in mlps
             for p in m.parameters()]
    return float(total.detach()), grads

  recorded = []
  mlp_kernel.mlp_bwd.launches = 0
  loss_gpu, g_gpu = run(device, "pallas", record=recorded)
  launches = mlp_kernel.mlp_bwd.launches
  _, g_gpu_linear = run(device, "xla")
  model.to("cpu")
  t0 = time.time()
  loss_cpu, g_cpu = run(torch.device("cpu"), "pallas", replay=recorded)
  secs = time.time() - t0
  rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
  unmasked = _worst_against(g_gpu, g_cpu)
  _, g_masked = run(torch.device("cpu"), "pallas", replay=recorded,
                    masks=True)
  worst = _worst_against(g_gpu, g_masked)
  own_fused = _worst_against(g_gpu, run(torch.device("cpu"), "pallas")[1])
  own_linear = _worst_against(g_gpu_linear,
                              run(torch.device("cpu"), "xla")[1])
  model.mlp_kernel = args.mlp_kernel
  log(f"fused radiance-step cpu cross-check: {XCHECK_RAYS} rays in "
      f"{secs:.1f} s, loss {loss_gpu:.8f} vs {loss_cpu:.8f} (rel "
      f"{rel:.3e}, tolerance {XCHECK_LOSS_RTOL}), MLP grads at {worst:.3f} "
      f"of the K5 tolerance with K4's {flips[0]} ReLU masks that the CPU "
      f"sets apart replayed ({unmasked:.3f} without), K5 launches "
      f"{launches}; each device placing its own samples: fused step at "
      f"{own_fused:.3f}, nn.Linear step at {own_linear:.3f} of it")
  if not (rel <= XCHECK_LOSS_RTOL and worst <= 1.0 and launches == 2):
    raise SystemExit("fused radiance-step cpu cross-check failed")
  return launches


def head_off_cases(device, seed, model, batch_rays):
  """K2 with the head off at the shapes its paths give it: one ray of the
  ship's 768-step march (extract_mesh's path dump), the ship's radiance
  batch (1024 rays x 768 steps on the 512^3 grid: a train step with
  online sparsity), synth's ground-truth chunk (8192 rays x 768 steps on
  its 64^3 grid), glass's 1024 rays x 1536 steps on the 384^3 grid and
  ball's 8192 x 1536 on the 256^3 grid."""
  ps = model.path_sampler
  cases = [("dump", (ps.spec, ps.grid, batch_rays.origins[:1].contiguous(),
                     batch_rays.viewdirs[:1].contiguous(), ps.near,
                     ps.step_size, ps.num_samples)),
           ("radiance batch", (ps.spec, ps.grid,
                               batch_rays.origins.contiguous(),
                               batch_rays.viewdirs.contiguous(), ps.near,
                               ps.step_size, ps.num_samples))]
  values = torch.from_numpy(synth.blob_ior_grid()).to(device)
  n = round(values.shape[0] ** (1 / 3))
  spec = grid_ops.GridSpec([n] * 3, [-1.5] * 3, [1.5] * 3)
  grid = torch.cat([values, grid_ops.central_difference_grad(
      spec, values)], -1).contiguous()
  o, d = scene_rays(device, seed, synth.GT_CHUNK)
  cases.append(("synth chunk", (spec, grid, o, d, 2.0, 4.0 / 767, 768)))
  spec, grid, o, d, near, step_size, steps, _ = glass_inputs(device, seed)
  cases.append(("glass", (spec, grid, o, d, near, step_size, steps)))
  spec, grid, near, step_size, steps, _ = scene_grid(device, seed, BALL)
  o, d = scene_rays(device, seed, 8192)
  cases.append(("ball chunk", (spec, grid, o, d, near, step_size, steps)))
  return cases


def head_off_phase(device, seed, model, batch_rays, jitter):
  """K2 with the head off (march_full_plain) against its plain version at
  every shape of head_off_cases, at K2_ATOL (the arclength of 1536-step
  marches relative to its largest value), with its call and device time
  and its bound; then its positions, directions and arclength against
  K1's dense outputs, bit for bit, at the ship radiance batch. Returns
  the kernel's report row (its times at synth's chunk, its worst error
  over the five shapes)."""
  times = {}
  for shape, args in head_off_cases(device, seed, model, batch_rays):
    report = march_report(shape, "plain", args)
    err = report["err"]
    scale = (max(1.0, report["dist_max"]) if args[6] >= LONG_MARCH
             else 1.0)
    worst = max(max(err[:6] + err[7:]), err[6] / scale)
    log(f"  head-off {shape}: worst error {worst:.3e} against {K2_ATOL} "
        f"(arclength over {scale:.4f}); geometry "
        f"{march_kernel.full_plain_launch_geometry(args[2].shape[0])}")
    if not (np.all(np.isfinite(err)) and worst <= K2_ATOL):
      raise SystemExit(f"head-off march {shape} disagrees with its plain "
                       f"version: {err} against {K2_ATOL}")
    times[shape] = (report["call_ms"], report["kernel_ms"], worst, args)
  ps = model.path_sampler
  args = (ps.spec, ps.grid, batch_rays.origins, batch_rays.viewdirs, ps.near,
          ps.step_size, ps.num_samples)
  with torch.no_grad():
    full = march_kernel.march_full_plain(*args)
    lean = march_kernel.march_lean(*args, jitter)
  same = {"pos": torch.equal(lean[0], full[..., 0:3]),
          "dir": torch.equal(lean[1],
                             math_ops.safe_l2_normalize(full[..., 3:6])),
          "dist": torch.equal(lean[2], full[..., 6])}
  log(f"  head-off against K1's dense outputs at the radiance batch "
      f"({args[2].shape[0]} rays x {args[6]} steps), bit for bit: {same}")
  if not all(same.values()):
    raise SystemExit(f"head-off march: not K1's path bit for bit: {same}")
  del full, lean
  err = max(t[2] for t in times.values())
  call_ms, device_ms, _, args = times["synth chunk"]
  with torch.no_grad():
    plain_ms = cuda_ms(lambda: march_kernel.march_full_plain_reference(*args),
                       reps=3)
    pos = march_kernel.march_full_plain(*args)[..., 0:3]
  batch, steps = args[2].shape[0], args[6]
  distinct = distinct_voxels(args[0], pos)
  nbytes = (4 * march_kernel.FULL_ROW * batch * steps + 4 * 6 * batch
            + 16 * distinct)
  bound_ms, bound_by = bound(nbytes, 120 * batch * steps)
  log(f"  head-off synth chunk: {call_ms:.4f} ms a call, {device_ms:.4f} ms "
      f"of device time, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms by "
      f"{bound_by} ({nbytes / 1e6:.1f} MB incl. {distinct} distinct voxels)")
  row = report_row("march_full_plain", MARCH_KERNEL + " (march_tiled_pallas, "
                   "so3_params=None, :763)", err, call_ms, plain_ms,
                   bound_ms, bound_by,
                   source="samplenerfro_torch/ops/csrc/march_lean.cu")
  row["device_ms"] = device_ms
  for shape in ("dump", "radiance batch", "glass", "ball chunk"):
    key = shape.replace(" ", "_")
    row[f"{key}_ms"], row[f"{key}_device_ms"] = times[shape][:2]
  return row


def _icosphere_share(mesh, extent):
  """The closed mesh's volume (divergence theorem) over the box's."""
  v = mesh.vertices[mesh.faces]
  volume = abs(np.einsum("ij,ij->i", v[:, 0], np.cross(v[:, 1], v[:, 2]))
               .sum()) / 6.0
  return volume / (2 * extent) ** 3


def quickstart_phase(device, seed):
  """README.md's Quickstart through the port's entry points on a copy of
  example_data: voxelize_mesh with the README's flags, N_QUICK_STEPS
  radiance steps with configs/example.* at full width, eval of the test
  view, then extract_mesh at EXTRACT_RESOLUTION. Returns the launches of
  K1 (train, eval and the debug view) and of the head-off march (the path
  dump) and the steps' seconds."""
  secs, counts = {}, {}
  with tempfile.TemporaryDirectory() as tmp:
    data = os.path.join(tmp, "example_data")
    shutil.copytree("example_data", data)
    t0 = time.time()
    voxelize_mesh.main([f"--data_dir={data}"] + VOXELIZE_FLAGS)
    secs["voxelize"] = time.time() - t0
    with open(os.path.join(data, "voxelize", "mesh.pkl"), "rb") as f:
      grid = pickle.load(f)
    values = np.asarray(grid["data"])
    occupied = float(np.mean(values > 1.165))
    share = _icosphere_share(objio.load(os.path.join(data, "mesh.obj")),
                             grid["extent"])
    log(f"quickstart: voxelize_mesh {secs['voxelize']:.1f} s "
        f"({grid['num_voxels']}^3 voxels x 4^3 samples), values in "
        f"[{values.min()}, {values.max()}], occupied {occupied:.5f} against "
        f"the icosphere's share {share:.5f} of the box")
    if not (values.dtype == np.float64 and values.min() >= 1.0
            and values.max() <= 1.33):
      raise SystemExit("quickstart: mesh.pkl's values outside [1, 1.33]")
    if abs(occupied - share) > OCCUPIED_RTOL * share:
      raise SystemExit(f"quickstart: occupied fraction {occupied} is not "
                       f"within {OCCUPIED_RTOL} of {share}")

    logs = os.path.join(tmp, "logs")
    common = [f"--data_dir={data}", f"--train_dir={logs}",
              f"--config={EXAMPLE_CONFIG}",
              f"--gin_file={EXAMPLE_CONFIG}.gin", f"--device={device}",
              "--stage=radiance"]
    _zero_march_counts()
    t0 = time.time()
    with StepRecorder() as rec:
      model = train_loop.main(common + [
          f"--max_steps={N_QUICK_STEPS}", f"--save_every={N_QUICK_STEPS}",
          "--print_every=100", "--render_every=0", f"--seed={seed}"])
    secs["train"] = time.time() - t0
    counts["train"] = _march_counts()
    named = common + ["--gin_param=Config.radiance_weight_name='radiance'"]
    _zero_march_counts()
    t0 = time.time()
    res = eval_lib.main(named + [f"--seed={seed}"])
    secs["eval"] = time.time() - t0
    counts["eval"] = _march_counts()
    preds = os.path.join(logs, "radiance", "test_preds")
    images = {k: os.path.join(preds, f"{k}000.png") for k in (
        "", "disp_", "depth_", "depth_mod_", "depth_normals_")}

    args, _, _ = config_lib.load_args(EXAMPLE_CONFIG,
                                      [EXAMPLE_CONFIG + ".gin"])
    args.data_dir = data
    rays, views = datasets.load_split(args, "test")
    view, pixels = datasets.eval_view(args, rays, views, 0)
    jitter = nerf.make_jitter(args.num_coarse_samples, args.num_path_samples,
                              torch.Generator().manual_seed(seed))
    rgb, disp, acc = render_lib.render_image(
        make_render_fn(model, jitter), view, False, chunk=args.chunk,
        device=device)
    psnr = metrics.compute_psnr(((rgb - pixels)**2).mean())
    ssim = float(metrics.compute_ssim(rgb, pixels, 1.0))
    # A threshold the trained density crosses: the 99th percentile of the
    # alpha of a coarse lattice over the extraction's box (at the median
    # a barely trained density puts a surface in half the cells: 20M
    # faces, minutes of marching tetrahedra on the host).
    coarse = extract_mesh.density_grid(model, 32, EXTRACT_RANGE, args.chunk,
                                       device)
    threshold = float(f"{np.percentile(coarse, EXTRACT_PERCENTILE):.4g}")
    del model
    _zero_march_counts()
    t0 = time.time()
    out = extract_mesh.main(named + [
        f"--resolution={EXTRACT_RESOLUTION}", f"--range={EXTRACT_RANGE}",
        f"--threshold={threshold}", f"--seed={seed}"])
    secs["extract"] = time.time() - t0
    counts["extract"] = _march_counts()
    with open(out["dump"], "rb") as f:
      dump = pickle.load(f)
    found = {k: os.path.exists(v) and os.path.getsize(v) > 0
             for k, v in images.items()}
    pngs = {k: np.asarray(Image.open(v)) for k, v in images.items()
            if found[k]}
  steps = args.num_coarse_samples * args.num_path_samples
  n_rays = view.origins.shape[0] * view.origins.shape[1]
  n_chunks = -(-n_rays // args.chunk)
  log(f"  train {N_QUICK_STEPS} steps {secs['train']:.1f} s "
      f"({rec.rate():.3f} steps/s after the first), losses "
      f"{[round(float(x), 5) for x in rec.losses[::50]]}; eval "
      f"{secs['eval']:.1f} s: PSNR {res.psnrs}, SSIM {res.ssims}; the "
      f"returned model on the same view: PSNR {psnr}, SSIM {ssim}")
  log(f"  extract_mesh {secs['extract']:.1f} s at {EXTRACT_RESOLUTION} "
      f"(threshold {threshold}): {out['times']}; "
      f"{out['times']['points_per_s']:.1f} points/s; mesh "
      f"{len(out['vertices'])} vertices, {len(out['faces'])} faces; path "
      f"dump {dump['ray_pos'].shape}; eval images {found}")
  log(f"  launches K1/K2/K3/head-off: {counts}")
  if not rec.finite or not all(bool(f) for f in rec.finite):
    raise SystemExit("quickstart: non-finite loss or gradient")
  if res.psnrs[:1] != [psnr] or res.ssims[:1] != [ssim]:
    raise SystemExit("quickstart: eval did not render the trained "
                     "checkpoint")
  if not all(found.values()) or not all(
      np.all(np.isfinite(v)) and v.size for v in pngs.values()):
    raise SystemExit(f"quickstart: eval's images {found}")
  if not (np.all(np.isfinite(disp)) and np.all(np.isfinite(acc))):
    raise SystemExit("quickstart: non-finite distance or opacity")
  if dump["ray_pos"].shape != (1, steps, 3) or not np.all(
      np.isfinite(dump["idx_grad"])):
    raise SystemExit(f"quickstart: path dump {dump['ray_pos'].shape}, "
                     f"expected (1, {steps}, 3)")
  if len(out["faces"]) == 0:
    raise SystemExit(f"quickstart: no surface at threshold {threshold}")
  want = {"train": (N_QUICK_STEPS, 0, 0, 0),
          "eval": (n_chunks, 0, 0, 0), "extract": (n_chunks, 0, 0, 1)}
  if counts != want:
    raise SystemExit(f"quickstart: launches {counts}, expected {want}")
  return counts, secs


def quality_phase(device):
  """The synthetic exact-ground-truth scene (tools/synth.make_scene at its
  defaults: 16/2/2 views of 128^2, a 64^3 grid, 768 steps, its ground
  truth marched by the head-off kernel) and N_QUALITY_STEPS radiance steps
  with single_image batching and fp32 MLPs through
  tools/validate_quality; the test PSNR must reach QUALITY_MIN_PSNR.
  Returns the head-off launches of the scene and the result."""
  with tempfile.TemporaryDirectory() as tmp:
    _zero_march_counts()
    t0 = time.time()
    synth.make_scene(os.path.join(tmp, "scene"), device=device)
    scene_s = time.time() - t0
    scene_counts = _march_counts()
    _zero_march_counts()
    t0 = time.time()
    res = validate_quality.main([
        f"--steps={N_QUALITY_STEPS}", "--batching=single_image",
        f"--workdir={tmp}", f"--device={device}"])
    secs = time.time() - t0
    counts = _march_counts()
  r = res[validate_quality.RADIANCE_STAGE]
  views = 20 * 128 * 128
  want_plain = -(-128 * 128 // synth.GT_CHUNK) * 20
  log(f"quality: scene {scene_s:.1f} s (launches K1/K2/K3/head-off "
      f"{scene_counts}), {N_QUALITY_STEPS} radiance steps single_image fp32 "
      f"{r['train_s']:.1f} s, eval {r['eval_s']:.1f} s, {secs:.1f} s in "
      f"all: test PSNR {r['psnr']} (gate {QUALITY_MIN_PSNR}), SSIM "
      f"{r['ssim']}; launches {counts}")
  if scene_counts != (0, 0, 0, want_plain):
    raise SystemExit(f"quality: the scene's {views} rays took launches "
                     f"{scene_counts}, expected {want_plain} head-off")
  if not r["psnr"] >= QUALITY_MIN_PSNR:
    raise SystemExit(f"quality: test PSNR {r['psnr']} under "
                     f"{QUALITY_MIN_PSNR}")
  return scene_counts, r


class RenderTimer:
  """While entered, times utils/render.render_image's calls (after a sync)
  and records their views' count and shape."""

  def __enter__(self):
    self.orig = render_lib.render_image
    self.secs, self.views, self.shape = 0.0, 0, None

    def timed(render_fn, rays, *a, **kw):
      torch.cuda.synchronize()
      t0 = time.time()
      out = self.orig(render_fn, rays, *a, **kw)
      torch.cuda.synchronize()
      self.secs += time.time() - t0
      self.views += 1
      self.shape = tuple(rays.origins.shape[:2])
      return out

    render_lib.render_image = timed
    return self

  def __exit__(self, *exc):
    render_lib.render_image = self.orig


def _so3_cpu_copy(ps):
  """The path sampler on the CPU without its grid (the smoothness reads
  only the so3 head, the grid's spec and normal_radius_scale)."""
  grid = ps.grid
  ps.grid = torch.empty(0, 4, device=grid.device)
  try:
    out = copy.deepcopy(ps).to("cpu")
  finally:
    ps.grid = grid
  return out


def smoothness_cross_check(model, host, seed):
  """The ungated normal smoothness and its so3 gradients at the ship
  head's width on a Grid batch of the ship grid, with so3 weights drawn
  at output std 1e-2 (debug/march_parity.so3_params_for) so that the head
  bends the gradient: the card (cuBLAS) against the CPU on the same
  points and offsets. No kernel of the port is on this path. The value
  is held at SMOOTH_TOL of the size of its terms (|pred| / |grad n|,
  about 1 a point); the gradients are printed against the K3 form per
  tensor (worst error over its bound), not held: the two BLAS sum in
  other orders, and a pre-activation near 0 that rounds to the other side
  of the ReLU on one device moves its point's share of every gradient
  (ROADMAP Queue 3's card-against-CPU hazard). Returns (card value, CPU
  value, worst gradient error over its bound)."""
  ps = model.path_sampler
  cpu = _so3_cpu_copy(ps)
  with torch.no_grad():
    for p, q in zip(ps.so3_mlp.params(), so3_params_for(seed, "cpu")):
      p.copy_(q.to(p.device))
    for p, q in zip(cpu.so3_mlp.params(), so3_params_for(seed, "cpu")):
      p.copy_(q)
  pts = torch.from_numpy(host["pts"])
  grads = torch.from_numpy(host["grads"])
  noise = torch.randn(pts.shape, generator=torch.Generator().manual_seed(seed))
  alpha = torch.tensor(SO3_ALPHA)
  out = []
  for sampler, dev in ((ps, torch.device("cuda")), (cpu, torch.device("cpu"))):
    args = [t.to(dev) for t in (pts, grads, alpha, noise)]
    _, smooth = sampler.compute_normal_loss_and_smooth(*args)
    g = torch.autograd.grad(smooth, sampler.so3_mlp.params())
    with torch.no_grad():
      pred = sampler.wrapper_grad_mlp(args[0], args[1], args[2])
      terms = float((pred.abs().sum(-1) / args[1].norm(dim=-1)).mean())
    out.append((float(smooth.detach()), [x.cpu() for x in g], terms))
  (card, g_card, terms), (host_v, g_cpu, _) = out
  names = [n for n, _ in ps.so3_mlp.named_parameters()]
  ratios = {n: float(((a - b).abs() / (K3_ATOL_SCALE * b.abs().max()
                                       + K3_RTOL * b.abs())).max())
            for n, a, b in zip(names, g_card, g_cpu)}
  worst = max(ratios.values())
  log(f"  smoothness (ungated) at {pts.shape[0]} Grid points, so3 output std "
      f"1e-2, alpha {SO3_ALPHA}: card {card!r}, CPU {host_v!r}, difference "
      f"{abs(card - host_v):.3e} (tolerance {SMOOTH_TOL * terms:.3e}: "
      f"{SMOOTH_TOL} of its terms' size {terms:.4f}); so3 gradients, card "
      f"against CPU, worst error over the K3 form's bound per tensor "
      f"(printed, not held): "
      + ", ".join(f"{n} {r:.3f}" for n, r in ratios.items()))
  if not (np.isfinite(card) and card > 0):
    raise SystemExit(f"ior: smoothness {card} on the card")
  if abs(card - host_v) > SMOOTH_TOL * terms:
    raise SystemExit("ior: the smoothness, card against CPU, outside the "
                     "tolerance")
  if not all(bool(torch.isfinite(x).all()) for x in g_card):
    raise SystemExit("ior: non-finite so3 gradients of the smoothness")
  return card, host_v, worst


def _ior_run(sargs, scene, device, seed, hosts, k):
  """N_IOR steps of the `ior` stage from TRAIN_FROM + 1, k a dispatch,
  then a traced window of IOR_SPAN steps, through loop.host_window and
  data/prefetch.py as train.loop takes them, on the Grid batches `hosts`,
  from weights and an offsets generator drawn from `seed`. Returns the
  first N_IOR steps' Stats (floats), the state before and after them, the
  wrapper launches of K1/K2/K3/head-off in them, the steps/s of their last
  IOR_SPAN, the traced window's device ms a step, and the dispatch."""
  from torch.profiler import ProfilerActivity
  from torch.profiler import profile as tprofile
  ndim, nmin, nmax, grid, bindings = scene
  model = nerf.construct_nerf(sargs, ndim, nmin, nmax, grid, bindings,
                              device=device, seed=seed)
  optimizer, _, _ = step_lib.create_optimizer(model, sargs)
  start = _dispatch_state(model, optimizer)
  run = step_lib.make_train_step_multi(
      model, optimizer, sargs, k,
      torch.Generator(device=device).manual_seed(seed))
  first, end = TRAIN_FROM + 1, TRAIN_FROM + N_IOR
  windows = list(train_loop.dispatch_windows(first, end + IOR_SPAN, k))
  dataset, pending = iter(hosts), iter(windows)

  def next_window():
    w = next(pending, None)
    return None if w is None else train_loop.host_window(
        dataset, w[0], w[1], sargs, optimizer, None)

  batches = prefetch.device_prefetch(next_window, device, stacked=True)
  stats, prof = [], None
  torch.cuda.synchronize()
  _zero_march_counts()
  try:
    for (w0, w1), batch in zip(windows, batches):
      if w0 == end - IOR_SPAN + 1:
        torch.cuda.synchronize()
        t0 = time.time()
      if w0 == end + 1:
        prof = tprofile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA])
        prof.__enter__()
      out = run(batch)
      if w1 <= end:
        stats += out.per_step()
      if w1 == end:
        torch.cuda.synchronize()
        rate = IOR_SPAN / (time.time() - t0)
        counts = _march_counts()
        state = _dispatch_state(model, optimizer)
    torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    device_ms = step_device_us(prof.key_averages()) / 1e3 / IOR_SPAN
    prof = None
  finally:
    batches.close()
    if prof is not None:
      prof.__exit__(None, None, None)
  del model, optimizer
  return stats, start, state, counts, rate, device_ms, run


def ior_phase(args, scene, device, seed, card, view, jitter):
  """The `ior` stage at ship width (so3 head 4x128, extra_batch_size
  args.extra_batch_size) on the Grid of the ship's 512^3 grid, built on
  the host from the model's grid: N_IOR steps from TRAIN_FROM at K = 1
  and K = args.steps_per_dispatch (a CUDA graph), with weight_decay_mult
  0 as shipped (every parameter and Adam moment bit for bit where it
  started, loss_nrm 0) and IOR_WEIGHT_DECAY (the so3 head moves, the
  radiance MLPs do not, K = 1 and K bit for bit); no march kernel runs.
  Then the smoothness card against CPU, and the val render the loop runs
  at --render_every (eval's render function) of the ship view in the
  `ior` stage: K1 once per chunk. Returns the render's K1 launches and
  the figures."""
  k = args.steps_per_dispatch
  ndim, nmin, nmax, grid, bindings = scene
  sargs = argparse.Namespace(**{**vars(args), "stage": "ior"})
  model = nerf.construct_nerf(sargs, ndim, nmin, nmax, grid, bindings,
                              device=device, seed=seed)
  t0 = time.time()
  grid_ds = train_loop.model_grid(model, sargs,
                                  np.random.RandomState(train_loop.DATA_SEED))
  build_s = time.time() - t0
  hosts = [next(grid_ds) for _ in range(N_IOR + IOR_SPAN)]
  candidates = len(grid_ds.candidate_indices)
  del grid_ds
  log(f"ior ({card}): Grid of the {ndim[0]}^3 grid built on the host in "
      f"{build_s:.2f} s, {candidates} candidate voxels of "
      f"{int(np.prod(ndim))}; {args.extra_batch_size} points a batch")
  figures = {"grid_build_s": build_s, "candidates": candidates}
  runs = {}
  for wdm in (0.0, IOR_WEIGHT_DECAY):
    wargs = argparse.Namespace(**{**vars(sargs), "weight_decay_mult": wdm})
    for kk in (1, k):
      runs[(wdm, kk)] = _ior_run(wargs, scene, device, seed, hosts, kk)
      torch.cuda.empty_cache()
    eager, graph = runs[(wdm, 1)], runs[(wdm, k)]
    differ = [key for key in eager[2] if not torch.equal(eager[2][key],
                                                         graph[2][key])]
    steps_differ = [i for i, (a, b) in enumerate(zip(eager[0], graph[0]))
                    if a != b]
    moved = {key for key in eager[2] if not key.endswith(" step")
             and not torch.equal(eager[1][key], eager[2][key])}
    so3_moved = {key for key in moved if "so3_mlp" in key
                 and key.startswith("param")}
    radiance_moved = {key for key in moved if key.startswith("param")
                      and "path_sampler" not in key}
    nrm = {s.loss_nrm for s in eager[0] + graph[0]}
    log(f"  weight_decay_mult {wdm}: K=1 {eager[4]:.3f} steps/s, "
        f"{eager[5]:.4f} device ms a step; K={k} {graph[4]:.3f} steps/s (a "
        f"replay), {graph[5]:.4f} device ms a step; device share "
        f"{eager[4] * eager[5] / 1e3:.3f} and {graph[4] * graph[5] / 1e3:.3f}"
        f"; replays {graph[6].replays}; {len(eager[2])} tensors of state, "
        f"{len(moved)} parameters and moments moved ({len(so3_moved)} so3 "
        f"parameters, "
        f"{len(radiance_moved)} radiance parameters), {len(differ)} differ "
        f"between K=1 and K={k}, {len(steps_differ)} steps' Stats differ; "
        f"loss_nrm {sorted(nrm)}; weight_l2 {eager[0][-1].weight_l2!r}; "
        f"march launches K=1 {eager[3]}, K={k} {graph[3]}")
    figures[f"wdm {wdm}"] = {"k1_steps_s": eager[4], "k_steps_s": graph[4],
                             "k1_device_ms": eager[5],
                             "k_device_ms": graph[5]}
    if differ or steps_differ or len(graph[0]) != N_IOR:
      raise SystemExit(f"ior: K={k} is not K=1 bit for bit: state "
                       f"{differ[:5]}, steps {steps_differ[:5]}")
    if nrm != {0.0}:
      raise SystemExit(f"ior: loss_nrm {nrm}, the gate keeps it 0")
    if eager[3] != (0, 0, 0, 0) or graph[3] != (0, 0, 0, 0):
      raise SystemExit(f"ior: the step launched march kernels {eager[3]}, "
                       f"{graph[3]}")
    if graph[6].replays < 1:
      raise SystemExit("ior: no window was replayed")
    if wdm == 0.0 and moved:
      raise SystemExit(f"ior: as shipped, {sorted(moved)[:5]} moved")
    if wdm > 0 and (not so3_moved or radiance_moved):
      raise SystemExit(f"ior: weight decay moved so3 {len(so3_moved)}, "
                       f"radiance {sorted(radiance_moved)[:5]}")
  del runs
  torch.cuda.empty_cache()
  figures["smoothness"] = smoothness_cross_check(model, hosts[0], seed)
  _zero_march_counts()
  torch.cuda.synchronize()
  t0 = time.time()
  rgb, _, acc = render_lib.render_image(
      make_render_fn(model, jitter), view, False, chunk=args.chunk,
      device=device, chunks_per_dispatch=args.render_chunks_per_dispatch)
  torch.cuda.synchronize()
  secs = time.time() - t0
  counts = _march_counts()
  n_rays = view.origins.shape[0] * view.origins.shape[1]
  n_chunks = -(-n_rays // args.chunk)
  log(f"  val render in the ior stage: {n_rays} rays in {secs:.3f} s "
      f"({n_rays / secs:.1f} rays/s), launches K1/K2/K3/head-off {counts} "
      f"(expected ({n_chunks}, 0, 0, 0)); rgb finite "
      f"{bool(np.isfinite(rgb).all())}, acc mean {float(acc.mean()):.6f}")
  if counts != (n_chunks, 0, 0, 0) or not np.isfinite(rgb).all():
    raise SystemExit(f"ior: the val render launched {counts}")
  del model
  torch.cuda.empty_cache()
  return counts[0], figures


def llff_phase(device, seed, card):
  """An LLFF capture (debug/llff_scene.py: LLFF_VIEWS forward-facing views
  of 160x136 in images_2, a 128^3 blob in voxelize/) through the entry
  points in the ship configuration at full width with --dataset=llff,
  near 0 and far 1 (NDC), Config.voxel_grid 'voxelize': train.loop.main
  --stage=radiance for N_LLFF steps at its K with a val render, then
  --stage=ior for IOR_SPAN steps with a val render (the Grid batches of
  the scene's grid), eval --render_path (the 120-frame spiral into
  path_renders/, no score file: K1 once per chunk) and eval of the test
  views; then eval --render_path on a Blender scene must raise
  ValueError. Returns K1's launches and the figures."""
  ship = "configs/tpu/ship_skydome-bkgd_no-partial-reflect_cycles"
  t0 = time.time()
  with tempfile.TemporaryDirectory() as tmp:
    data = llff_scene.write_scene(os.path.join(tmp, "llff"),
                                  views=LLFF_VIEWS)
    write_s = time.time() - t0
    common = [f"--data_dir={data}", f"--train_dir={os.path.join(tmp, 'logs')}",
              f"--config={ship}", f"--gin_file={ship}.gin", f"--seed={seed}",
              f"--device={device}", *FP32_FLAGS, "--dataset=llff", "--near=0.0",
              "--far=1.0", "--gin_param=Config.voxel_grid='voxelize'",
              "--gin_param=Config.radiance_weight_name='radiance'",
              "--gin_param=Config.ior_weight_name='ior'"]
    every = lambda n: [f"--max_steps={n}", f"--save_every={n}",
                       f"--print_every={n}", f"--render_every={n}",
                       f"--gc_every={n}"]
    args, _, _ = config_lib.load_args(ship, [ship + ".gin"], [],
                                      dataset="llff", near=0.0, far=1.0,
                                      **FP32_ARMS)
    args.data_dir = data
    val_rays, _ = datasets.load_split(args, "val")
    n_val = val_rays.origins.shape[1] * val_rays.origins.shape[2]
    counts = {}
    _zero_march_counts()
    with StepRecorder() as rec:
      train_loop.main(common + ["--stage=radiance"] + every(N_LLFF))
    counts["radiance"] = _march_counts()
    _zero_march_counts()
    with StepRecorder() as ior_rec:
      train_loop.main(common + ["--stage=ior"] + every(N_LLFF))
    counts["ior"] = _march_counts()
    _zero_march_counts()
    with RenderTimer() as timer:
      path = eval_lib.main(common + ["--stage=radiance", "--render_path=True"])
    counts["path"] = _march_counts()
    out = os.path.join(tmp, "logs", "radiance", "path_renders")
    names = sorted(os.listdir(out))
    _zero_march_counts()
    test = eval_lib.main(common + ["--stage=ior"])
    counts["test"] = _march_counts()
    try:
      eval_lib.main(["--data_dir=example_data", f"--train_dir={tmp}",
                     "--config=configs/example",
                     "--gin_file=configs/example.gin", f"--device={device}",
                     "--render_path=True"])
      blender_raised = None
    except ValueError as e:
      blender_raised = str(e)
  frames, (h, w) = timer.views, timer.shape
  chunks = -(-h * w // args.chunk)
  n_val_chunks = -(-n_val // args.chunk)
  k = args.steps_per_dispatch
  want = {"radiance": (rec.calls + n_val_chunks, 0, 0, 0),
          "ior": (n_val_chunks, 0, 0, 0),
          "path": (frames * chunks, 0, 0, 0),
          "test": (len(test.psnrs) * chunks, 0, 0, 0)}
  rate = rec.rate()
  path_rate = frames * h * w / timer.secs
  log(f"llff ({card}): {LLFF_VIEWS} views of {w}x{h} written in "
      f"{write_s:.1f} s; radiance {N_LLFF} steps at K={k} {rate:.3f} steps/s "
      f"(the windows after the first, the capture included), replays "
      f"{rec.replays()}; ior {N_LLFF} steps, replays {ior_rec.replays()}; "
      f"render path {frames} frames of {w}x{h}, {timer.secs:.2f} s in "
      f"render_image, {path_rate:.1f} rays/s; {len(names)} files in "
      f"path_renders, scores {[n for n in names if n.endswith('.txt')]}; "
      f"eval of the ior stage's test views: PSNR {test.psnrs}, step "
      f"{test.step}; render_path on Blender raised: {blender_raised!r}")
  log(f"  wrapper launches K1/K2/K3/head-off {counts} (expected {want})")
  losses = [float(x) for x in rec.losses]
  if not np.all(np.isfinite(losses)) or not all(bool(f) for f in rec.finite):
    raise SystemExit("llff: non-finite loss or gradient")
  if len(names) != 5 * frames or any(n.endswith(".txt") for n in names):
    raise SystemExit(f"llff: path_renders holds {len(names)} files")
  if path.psnrs or path.step != N_LLFF or test.step != N_LLFF:
    raise SystemExit(f"llff: render path scored {path.psnrs}, steps "
                     f"{path.step}, {test.step}")
  if not test.psnrs or not np.all(np.isfinite(test.psnrs)):
    raise SystemExit(f"llff: test PSNR {test.psnrs}")
  if counts != want:
    raise SystemExit(f"llff: launches {counts}, expected {want}")
  if min(rec.replays(), ior_rec.replays()) < 1:
    raise SystemExit("llff: a stage replayed no window")
  if blender_raised != "render_path cannot be used for the blender dataset.":
    raise SystemExit(f"llff: render_path on Blender gave {blender_raised!r}")
  return counts, {"radiance_steps_s": rate, "path_rays_s": path_rate}


# The model options (phase 13): each path N_DISPATCH steps from TRAIN_FROM
# at K = 1 and at the ship's K, as phase 6b runs the shipped ones.
# (name, stage, flag overrides, gin bindings): online sparsity reads the
# dense grad n (K2 with the head off in radiance); IPE featurizes with 60
# features and the SH direction encoding gives 16 condition values (K4/K5
# take both in one path with --mlp_kernel=pallas); SH colour at sh_deg 2
# needs use_viewdirs off, and the SH direction encoding's width is not
# the envmap's pos_enc's (the JAX model fails there on the shape), so the
# paths with it train without the background smoothness term.
NO_ENVMAP = {"bg_smooth_weight": 0.0}
FUSED_OPTIONS = ("radiance IPE SH direction pallas", "radiance",
                 {"mlp_kernel": "pallas", "sh_direnc_deg": 4, **NO_ENVMAP},
                 {"NerfModel.use_ipe": True})
IPE_ALL = ("all IPE online sparsity", "all", {"use_online_sparsity": True},
           {"NerfModel.use_ipe": True})
OPTION_PATHS = (
    ("radiance online sparsity", "radiance",
     {"use_online_sparsity": True}, {}),
    ("radiance IPE", "radiance", {}, {"NerfModel.use_ipe": True}),
    FUSED_OPTIONS,
    ("radiance SH", "radiance",
     {"sh_deg": 2, "sh_direnc_deg": 4, "use_viewdirs": False, **NO_ENVMAP},
     {}),
    IPE_ALL,
    ("all online sparsity", "all", {"use_online_sparsity": True}, {}),
)
# Paths run at the ship's K only, and those whose state is held against
# phase 6b's (online sparsity gated at 0).
OPTION_K_ONLY = ("all online sparsity",)
OPTION_HELD = ("radiance online sparsity", "all online sparsity")
SPHERICAL = {"VoxMLP.use_direct_output": False}


def _option_path(args, scene, device, seed, hosts, k, name, stage, flags,
                 gin):
  """One option path at K = 1 (unless in OPTION_K_ONLY) and K = k through
  _dispatch_run; checks K = 1 bit for bit K = k, the march kernels'
  wrapper launches and a traced window's, K4/K5's wrapper launches.
  Returns {k: (steps/s, device ms a step, wrapper march launches, K4/K5
  launches)} and the state after the N_DISPATCH steps at K = k."""
  ndim, nmin, nmax, grid, bindings = scene
  sargs = argparse.Namespace(**{**vars(args), "stage": stage, **flags})
  oscene = (ndim, nmin, nmax, grid, {**bindings, **gin})
  online = bool(flags.get("use_online_sparsity"))
  fused = flags.get("mlp_kernel", "xla") != "xla"
  if stage == "radiance":
    per = lambda n: (0, 0, 0, n) if online else (n, 0, 0, 0)
  else:
    per = lambda n: (0, n, n, 0)
  want_traced = _march_kernels(per(k))
  out, runs = {}, {}
  for kk in ((k,) if name in OPTION_K_ONLY else (1, k)):
    mlp_kernel.mlp_fwd.launches = mlp_kernel.mlp_bwd.launches = 0
    t0 = time.time()
    run = _dispatch_run(sargs, oscene, device, seed, hosts, kk, k,
                        want_traced)
    mlp = (mlp_kernel.mlp_fwd.launches, mlp_kernel.mlp_bwd.launches)
    torch.cuda.empty_cache()
    python_steps = (N_DISPATCH + k * len(run[4]) if kk == 1 else 2 * k)
    want_mlp = (2 * python_steps,) * 2 if fused else (0, 0)
    want_run = per(N_DISPATCH if kk == 1 else 2 * k)
    log(f"  {name}, K={kk}: {run[3]:.3f} steps/s, {run[5]:.3f} device ms a "
        f"step (share {run[3] * run[5] / 1e3:.3f}); wrapper launches "
        f"K1/K2/K3/head-off {run[2]} (expected {want_run}), K4/K5 {mlp} "
        f"(expected {want_mlp}); traced windows of {k} steps "
        f"{[list(t.values()) for t in run[4]]} for {list(want_traced)}; "
        f"losses {[s.loss for s in run[0][::10]]}; {time.time() - t0:.1f} s "
        f"({run[7]:.1f} s tracing)")
    if not all(np.isfinite([s.loss for s in run[0]])):
      raise SystemExit(f"options {name}: non-finite loss")
    if run[2] != want_run or mlp != want_mlp:
      raise SystemExit(f"options {name}: wrapper launches {run[2]}, K4/K5 "
                       f"{mlp}")
    if run[4][-1] != want_traced or any(
        t[n] > want_traced[n] for t in run[4] for n in t):
      raise SystemExit(f"options {name}: traced launches {run[4]}, "
                       f"expected {want_traced}")
    out[kk] = (run[3], run[5], run[2], mlp)
    runs[kk] = run
  if 1 in runs:
    eager, graph = runs[1], runs[k]
    differ = [key for key in eager[1] if not torch.equal(eager[1][key],
                                                         graph[1][key])]
    if differ or eager[0] != graph[0]:
      raise SystemExit(f"options {name}: K={k} is not K=1 bit for bit: "
                       f"{differ[:5]}")
  return out, runs[k][1]


def _same_state(name, got, want):
  """Raise unless two phase-6b-shaped states are equal bit for bit."""
  differ = [key for key in want if not torch.equal(got[key], want[key])]
  log(f"  {name}: {len(want)} tensors of state, {len(differ)} differ from "
      f"the shipped path's (phase 6b, K=10)")
  if differ or got.keys() != want.keys():
    raise SystemExit(f"options {name}: gated at 0, the state moved: "
                     f"{differ[:5]}")


def _gathered_subsample(model, rays, jitter):
  """The coarse subsample two ways at the radiance batch: K1's in-kernel
  one, and K2 with the head off's dense path gathered at the jitter (the
  online-sparsity path); their largest difference per channel."""
  ps = model.path_sampler
  args = (ps.spec, ps.grid, rays.origins.contiguous(),
          rays.viewdirs.contiguous(), ps.near, ps.step_size, ps.num_samples)
  lean = march_kernel.march_lean(*args, jitter)[3:]
  pos, dirs, dist, _, _ = march_kernel.split_trajectory(
      march_kernel.march_full_plain(*args))
  idx = jitter.to(pos.device)
  full = (pos[:, idx], math_ops.safe_l2_normalize(dirs)[:, idx],
          dist[:, idx])
  return [(a - b).abs().reshape(-1, a.shape[-1] if a.dim() == 3 else 1)
          .amax(dim=0).tolist() for a, b in zip(lean, full)], all(
              torch.equal(a, b) for a, b in zip(lean, full))


def _mlp_check(model, rays, jitter, what, seed):
  """K4 and K5 against their plain versions at the fine call of the
  training batch of a model whose MLP inputs are new widths (IPE's 60
  features, the SH direction encoding's 16 condition values): K4 in fp32
  and bf16, K5 in bf16 and fp32 (twice, bit for bit), at the K4/K5
  tolerances, timed beside their bounds. Returns the report rows of the
  bf16 calls, the train path's."""
  mlp = model.fine_mlp
  params = [p.detach() for p in mlp_kernel.mlp_params(mlp)]
  x, c = capture_mlp_inputs(model, rays, jitter, "pallas")[1]
  spec = mlp_kernel.mlp_spec(mlp)
  rows = []
  for dtype in (torch.float32, torch.bfloat16):
    got = torch.cat(mlp_kernel.mlp_fwd(spec, params, x, c, dtype), -1)
    want = torch.cat(mlp_kernel.fused_nerf_mlp_reference(spec, params, x, c,
                                                         dtype), -1)
    err = (got - want).abs()
    e_max, e_mean = float(err.max()), float(err.mean())
    ok = (e_max <= K4_FP32_ATOL if dtype == torch.float32 else
          e_max <= K4_BF16_MAX and e_mean <= K4_BF16_MEAN)
    pack = mlp_kernel.pack_params(params, dtype)
    ms = cuda_ms(lambda: mlp_kernel.mlp_fwd(spec, params, x, c, dtype,
                                            pack=pack))
    plain = cuda_ms(lambda: mlp_kernel.fused_nerf_mlp_reference(
        spec, params, x, c, dtype), 3)
    with torch.no_grad():
      unfused = cuda_ms(lambda: mlp(x, c, dtype=dtype))
    bound_ms, by, tflop = mlp_bound(spec, x.shape[0], dtype)
    log(f"  K4 {what} {str(dtype)[6:]} ({x.shape[0]} rows, {x.shape[1]} "
        f"features, {c.shape[1]} condition): max abs err {e_max:.3e}, mean "
        f"{e_mean:.3e}; {ms:.4f} ms, plain {plain:.3f} ms, nn.Linear "
        f"{unfused:.3f} ms, bound {bound_ms:.4f} ms by {by}")
    if not (ok and np.isfinite(e_max)):
      raise SystemExit(f"K4 {what} {dtype} disagrees with its plain version")
    if dtype == torch.bfloat16:  # the train path's
      rows.append(report_row("mlp_fwd", MLP_KERNEL + ":219", e_max, ms,
                             plain, bound_ms, by,
                             case=f"{what}, {str(dtype)[6:]}",
                             unfused_ms=unfused))
  gen = torch.Generator().manual_seed(seed + 2)
  n = x.shape[0]
  drgb = (1e-3 * torch.randn((n, spec.num_rgb), generator=gen)).to(x.device)
  dsigma = (1e-3 * torch.randn((n, 1), generator=gen)).to(x.device)
  for dtype in (torch.bfloat16, torch.float32):
    args = (spec, params, x, c, drgb, dsigma, dtype)
    acts = {}
    mlp_kernel.mlp_fwd(spec, params, x, c, dtype, acts=acts)
    got = mlp_kernel.mlp_bwd(*args)
    again = mlp_kernel.mlp_bwd(*args)
    plain_acts = {}
    own = k5_worst(got, mlp_kernel.fused_nerf_mlp_bwd_reference(
        *args, stored=plain_acts), dtype)
    flips = sum(int(((acts[key] > 0) != (plain_acts[key] > 0)).sum())
                for key in acts)
    worst = (k5_worst(got, mlp_kernel.fused_nerf_mlp_bwd_reference(
        *args, at=acts), dtype) if flips else own)
    err = max(float((g - w).abs().max()) for g, w in zip(
        got, mlp_kernel.fused_nerf_mlp_bwd_reference(*args)))
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    pack = mlp_kernel.pack_params(params, dtype)
    ms = cuda_ms(lambda: mlp_kernel.mlp_bwd(*args, pack=pack))
    plain = cuda_ms(lambda: mlp_kernel.fused_nerf_mlp_bwd_reference(*args),
                    3)

    def linear_backward():
      out = mlp(x, c, dtype=dtype)
      torch.autograd.grad(out, list(mlp.parameters()), (drgb, dsigma))

    unfused = cuda_ms(linear_backward)
    bound_ms, by, _ = mlp_bound(spec, n, dtype, backward=True)
    log(f"  K5 {what} {str(dtype)[6:]}: within {worst:.3f} of its tolerance "
        f"({own:.3f} without replaying K4's {flips} ReLU masks that the "
        f"plain version sets apart), max abs err {err:.3e}, two runs "
        f"{'bit for bit' if same else 'DIFFER'}; {ms:.4f} ms, plain "
        f"{plain:.3f} ms, nn.Linear {unfused:.3f} ms, bound {bound_ms:.4f} "
        f"ms by {by}")
    if not (worst <= 1.0 and same):
      raise SystemExit(f"K5 {what} {dtype} disagrees with its plain version")
    if dtype == torch.bfloat16:
      rows.append(report_row("mlp_bwd", MLP_KERNEL + ":246", err, ms,
                             plain, bound_ms, by,
                             case=f"{what}, {str(dtype)[6:]}",
                             unfused_ms=unfused))
  return rows


def _spherical_step(args, scene, device, seed, host, profile=False):
  """One 'all' step of the ship model with the spherical residual head
  (VoxMLP.use_direct_output False) on the plain march under autograd
  (PathSampler.march_all "plain"): a step's host seconds and, with
  `profile`, the next one's device ms, traced (gathering its ~10^5
  kernel records takes ~45 s); K1/K2/K3 must not launch. Then its loss and
  so3 gradients on XCHECK_RAYS rays, fp32 MLPs, card against CPU: the
  loss held at XCHECK_LOSS_RTOL, the gradients printed against the K3
  form (no port kernel on the path: cuBLAS against the CPU's BLAS).
  Returns its figures and the seconds of its pieces."""
  from torch.profiler import ProfilerActivity
  from torch.profiler import profile as tprofile
  t_start = time.time()
  ndim, nmin, nmax, grid, bindings = scene
  sargs = argparse.Namespace(**{**vars(args), "stage": "all"})
  model = nerf.construct_nerf(sargs, ndim, nmin, nmax, grid,
                              {**bindings, **SPHERICAL}, device=device,
                              seed=seed)
  if model.path_sampler.march_all != "plain":
    raise SystemExit("options: the spherical head must take the plain march")
  optimizer, _, _ = step_lib.create_optimizer(model, sargs)
  gen = train_generators(device, seed)
  batches = [prefetch.to_device(step_batch(
      host, annealed_alpha(TRAIN_FROM + i, sargs),
      step_lib.learning_rates(optimizer, TRAIN_FROM + i - 1),
      nerf.make_jitter(args.num_coarse_samples, args.num_path_samples,
                       gen[1]), sargs), device) for i in (1, 2)]
  _zero_march_counts()
  torch.cuda.synchronize()
  t0 = time.time()
  stats = step_lib.train_step(model, optimizer, batches[0], sargs, gen[0])
  torch.cuda.synchronize()
  secs = time.time() - t0
  seconds, device_ms = {"spherical step": secs}, None
  if profile:
    # Its ~10^5 kernels traced without the host's operator records.
    t0 = time.time()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
      step_lib.train_step(model, optimizer, batches[1], sargs, gen[0])
      torch.cuda.synchronize()
    device_ms = step_device_us(prof.key_averages()) / 1e3
    del prof
    seconds["spherical traced step"] = time.time() - t0
  counts = _march_counts()
  so3 = float(torch.sqrt(sum((p.grad**2).sum() for p in
                             model.path_sampler.so3_mlp.parameters())))
  traced = ("not traced (--profile)" if device_ms is None
            else f"{device_ms:.3f}")
  log(f"  all, spherical head (plain march, autograd): {secs:.3f} s a step "
      f"({1 / secs:.3f} steps/s), {traced} device ms a step; loss "
      f"{float(stats.loss):.6f}, so3 grad norm {so3:.3e}; launches "
      f"K1/K2/K3/head-off {counts} (expected (0, 0, 0, 0))")
  if counts != (0, 0, 0, 0) or not (np.isfinite(so3) and so3 > 0):
    raise SystemExit(f"options: the spherical head's step launched {counts}"
                     f", so3 grad norm {so3}")
  sub = dict(host)
  sub["rays"] = rays_lib.namedtuple_map(lambda r: r[:XCHECK_RAYS],
                                        host["rays"])
  sub["pixels"] = host["pixels"][:XCHECK_RAYS]
  xargs = argparse.Namespace(**{**vars(sargs), "randomized": False})
  model.mlp_dtype = torch.float32
  alpha = annealed_alpha(TRAIN_FROM + 2, sargs)
  jitter = nerf.make_jitter(args.num_coarse_samples, args.num_path_samples,
                            torch.Generator().manual_seed(seed))

  def run(dev):
    model.zero_grad(set_to_none=True)
    total, _ = step_lib.loss_fn(model, prefetch.to_device(
        step_batch(sub, alpha, None, jitter, xargs), dev), xargs)
    total.backward()
    return float(total.detach()), [
        p.grad.detach().cpu().clone()
        for p in model.path_sampler.so3_mlp.params()]

  t0 = time.time()
  loss_gpu, g_gpu = run(device)
  seconds["spherical card check"] = time.time() - t0
  model.to("cpu")
  t0 = time.time()
  loss_cpu, g_cpu = run(torch.device("cpu"))
  cpu_s = seconds["spherical CPU check"] = time.time() - t0
  del model
  rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
  worst = _worst_against(g_gpu, g_cpu, K3_ATOL_SCALE, K3_RTOL)
  log(f"  spherical head, card against CPU on {XCHECK_RAYS} rays ({cpu_s:.1f}"
      f" s on the CPU): loss {loss_gpu:.8f} vs {loss_cpu:.8f} (rel "
      f"{rel:.3e}, tolerance {XCHECK_LOSS_RTOL}); so3 grads at {worst:.3f} "
      f"of the K3 form (printed, not held)")
  if not rel <= XCHECK_LOSS_RTOL:
    raise SystemExit("options: the spherical head's card-against-CPU loss")
  seconds["spherical"] = time.time() - t_start
  return {"steps_s": 1 / secs, "device_ms": device_ms, "xcheck_rel": rel,
          "xcheck_so3_k3": worst, "seconds": seconds}


def options_phase(args, scene, device, seed, card, dispatch, model, host,
                  jitter, profile=False):
  """Phase 13: the model options at ship width. Each of OPTION_PATHS
  N_DISPATCH steps from TRAIN_FROM at K = 1 (but OPTION_K_ONLY) and
  K = args.steps_per_dispatch (bit for bit), steps/s of the last 10 (a
  replay at K) and device ms a step; K2 with the head off runs
  the online-sparsity radiance step, K1 does not, counted by wrapper and
  in traced windows; online sparsity, gated at 0 as shipped, leaves the
  30 steps of each stage bit for bit phase 6b's (its state at K); the
  head-off path's gathered subsample against K1's in-kernel one; K4/K5
  at IPE's 60 features and the SH direction encoding's 16 condition
  values against their plain versions; the IPE 'all' step from its
  path's state, its loss card against CPU and its so3 gradients the
  kernels against the plain versions on the card; one 'all' step
  with the spherical head on the plain march (its device ms with
  `profile`). Prints the seconds of each piece. Returns the new report rows, the head-off wrapper launches and
  the figures."""
  t_phase = time.time()
  k = args.steps_per_dispatch
  hosts = [synthetic_batch(args, seed + i)
           for i in range(N_DISPATCH + TRACE_TRIES * k)]
  log(f"options ({card}): each path {N_DISPATCH} steps from step "
      f"{TRAIN_FROM} at K=1 and K={k} (K={k} only: {OPTION_K_ONLY})")
  figures, seconds, head_off, mlp_launches = {}, {}, 0, {}
  for name, stage, flags, gin in OPTION_PATHS:
    t0 = time.time()
    out, state = _option_path(args, scene, device, seed, hosts, k, name,
                              stage, flags, gin)
    figures[name] = {kk: v[:2] for kk, v in out.items()}
    head_off += sum(v[2][3] for v in out.values())
    mlp_launches[name] = [sum(v[3][i] for v in out.values())
                          for i in (0, 1)]
    if name in OPTION_HELD:
      _same_state(name, state, dispatch[stage][2])
    if name == IPE_ALL[0]:
      ipe_state = state
    del state
    torch.cuda.empty_cache()
    seconds[name] = time.time() - t0
  ndim, nmin, nmax, grid, bindings = scene
  batch_rays = rays_lib.namedtuple_map(
      lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device),
      host["rays"])
  t0 = time.time()
  with torch.no_grad():
    per, same = _gathered_subsample(model, batch_rays, jitter)
  log(f"  the radiance batch's coarse subsample, K1 in-kernel against K2 "
      f"with the head off gathered: {'bit for bit' if same else 'differ'}; "
      f"max abs err per channel (pos, dir, dist) {per}")
  if not same and max(max(p) for p in per) > K1_ATOL:
    raise SystemExit(f"options: the gathered subsample is {per} from K1's")
  seconds["subsample"] = time.time() - t0
  t0 = time.time()
  name, _, flags, gin = FUSED_OPTIONS
  margs = argparse.Namespace(**{**vars(args), "stage": "radiance", **flags})
  fused = nerf.construct_nerf(margs, ndim, nmin, nmax, grid,
                              {**bindings, **gin}, device=device, seed=seed)
  rows = _mlp_check(fused, batch_rays, jitter,
                    "train fine call, IPE and SH direction encoding", seed)
  del fused
  torch.cuda.empty_cache()
  for row in rows:
    row["launches"] = mlp_launches[name][0 if row["name"] == "mlp_fwd"
                                         else 1]
  seconds["K4/K5"] = time.time() - t0
  t0 = time.time()
  name, stage, flags, gin = IPE_ALL
  iargs = argparse.Namespace(**{**vars(args), "stage": stage, **flags})
  ipe = nerf.construct_nerf(iargs, ndim, nmin, nmax, grid,
                            {**bindings, **gin}, device=device, seed=seed)
  with torch.no_grad():
    for n, p in ipe.named_parameters():
      p.copy_(ipe_state[f"param {n}"])
  del ipe_state
  allstep_cross_check(ipe, iargs, host, device, seed, name, hold="card")
  del ipe
  torch.cuda.empty_cache()
  seconds["IPE all-step cross-check"] = time.time() - t0
  figures["spherical"] = _spherical_step(args, scene, device, seed, hosts[0],
                                         profile)
  seconds.update(figures["spherical"].pop("seconds"))
  secs = time.time() - t_phase
  log(f"options: {secs:.1f} s; by piece "
      f"{ {n: round(v, 1) for n, v in seconds.items()} }; figures {figures}")
  figures["seconds"] = secs
  return rows, head_off, figures


def flax_ckpt_phase(model, args, view, jitter, device, seed):
  """Phase 14 (the module docstring): the JAX package's checkpoints read
  on the card's machine, the reference-layout export round-tripped at
  ship width, and a resume of the fixture's orbax state. Returns the
  phase's K1 launches (the resumed window's, by wrapper)."""
  t_phase = time.time()
  checks, secs = {}, {}
  t0 = time.time()
  fixture = flax_fixture.check()
  secs["decode"] = time.time() - t0
  checks["fixture_leaves"] = fixture["leaves"]
  checks["fixture_arrays"] = fixture["arrays"]
  secs.update({f"restore {k}": v for k, v in fixture["seconds"].items()})

  ps = model.path_sampler
  so3 = lambda m: [p.detach() for p in m.path_sampler.so3_mlp.params()]
  rays = ship_inputs(args, seed, device)[4]

  def marks(m):
    render_fn = make_render_fn(m, jitter)
    rgb, dist, acc = render_lib.render_image(render_fn, view, False,
                                             chunk=args.chunk, device=device)
    with torch.no_grad():
      k2 = march_kernel.march_full(ps.spec, ps.grid, rays.origins,
                                   rays.viewdirs, ps.near, ps.step_size,
                                   ps.num_samples, so3(m), SO3_ALPHA,
                                   SO3_MAX_DEG)
    torch.cuda.synchronize()
    return digest(*map(torch.from_numpy, (rgb, dist, acc))), digest(k2)

  with tempfile.TemporaryDirectory() as tmp:
    t0 = time.time()
    path = flax_checkpoints.export_reference_checkpoint(
        os.path.join(tmp, "ref_all"), convert.params_to_flax(model),
        TRAIN_FROM)
    secs["export ship"] = time.time() - t0
    checks["export_bytes"] = os.path.getsize(path)
    t0 = time.time()
    ckpt = flax_checkpoints.restore(path)
    secs["restore ship msgpack"] = time.time() - t0
    if not flax_checkpoints.is_reference_layout(ckpt):
      raise SystemExit(f"flax_ckpt: {path} is not in the reference layout")
    moved = copy.deepcopy(model)
    with torch.no_grad():
      for p in moved.parameters():
        p.add_(1.0)
    cfg = config_lib.Config(all_weight_name="ref_all")
    t0 = time.time()
    step = checkpoints.load_stage_weights(moved, tmp, cfg, "all")
    secs["stage-load ship"] = time.time() - t0
    own, back = model.state_dict(), moved.state_dict()
    differ = [k for k in own if not torch.equal(own[k], back[k])]
    if step != TRAIN_FROM or differ:
      raise SystemExit(f"flax_ckpt: stage-load step {step}, tensors that "
                       f"differ {differ[:5]}")
    t0 = time.time()
    want, got = marks(model), marks(moved)
    secs["renders"] = time.time() - t0
    checks["render_digest"], checks["k2_digest"] = got
    if got != want:
      raise SystemExit(f"flax_ckpt: the stage-loaded model's digests {got} "
                       f"are not the source's {want}")
    del moved

    t0 = time.time()
    stage_dir = flax_fixture.stage_copy(os.path.join(tmp, "train"))
    resumed, optimizer, step, stats, counts, launches = flax_fixture.resume(
        stage_dir, device, FLAX_K, seed=seed, grid_n=FLAX_GRID_N)
    torch.cuda.synchronize()
    secs["resume window"] = time.time() - t0
    after = [int(c) for c in optimizer.counts]
    losses = [s.loss for s in stats]
    checks.update(restored_step=step, restored_counts=counts,
                  counts_after=after, launches=launches,
                  losses=[losses[0], losses[-1]])
    last = step + FLAX_K
    if (step != flax_fixture.STEP or set(counts) != {step}
        or set(after) != {last} or len(stats) != FLAX_K
        or not np.all(np.isfinite(losses)) or launches != FLAX_K):
      raise SystemExit(f"flax_ckpt: resume {checks}")
    checkpoints.save_checkpoint(stage_dir, resumed, optimizer, last, keep=2)
    beside = sorted(os.listdir(stage_dir))
    kinds = [checkpoints.checkpoint_kind(os.path.join(stage_dir, n))
             for n in beside]
    checkpoints.save_checkpoint(stage_dir, resumed, optimizer, last, keep=1)
    pruned = sorted(os.listdir(stage_dir))
    checks.update(beside=beside, pruned=pruned)
    if (beside != [f"checkpoint_{last}", f"checkpoint_{step}"]
        or kinds != ["torch", "orbax"] or pruned != [f"checkpoint_{last}"]):
      raise SystemExit(f"flax_ckpt: stage directory {beside} ({kinds}), "
                       f"after keep=1 {pruned}")
    del resumed, optimizer
  secs["phase"] = time.time() - t_phase
  log("flax_ckpt: " + json.dumps({"checks": checks, "seconds": secs}))
  return launches


# The shipped-arms phase (16): the ship configuration as shipped, its
# march_interp "default" and march_bwd_dtype "bfloat16". The free-running
# K2 in its reduced arm against its plain version: a bf16 interpolation
# rounding of n and grad n that the two marches take apart (2^-8 of the
# grid's values, debug/precision_arms.py), carried; every step is held at
# K2_ATOL teacher-forced, and the free-running march at the JAX
# self-check's bf16 envelope of the plain version's scale.
SHIPPED_FREE_ENVELOPE = 0.05
SHIPPED_ARMS = (("march_lean", "default"), ("march_full_plain", "default"),
                ("march_full", ("default", "bfloat16")),
                ("march_bwd", "bfloat16"))
MARCH_BWD_KERNEL = "samplenerfro_tpu/ops/pallas/march_bwd_kernel.py:168"


def _arm_counts():
  """Each reduced arm's launches through its wrapper (.arms)."""
  fns = {"march_lean": march_kernel.march_lean,
         "march_full_plain": march_kernel.march_full_plain,
         "march_full": march_kernel.march_full,
         "march_bwd": eikonal_vjp.march_bwd}
  return {name: fns[name].arms[arm] for name, arm in SHIPPED_ARMS}


def _fp32_arm_counts():
  """The fp32 arms' launches, which the shipped path must not make."""
  return (march_kernel.march_lean.arms["highest"]
          + march_kernel.march_full_plain.arms["highest"]
          + sum(n for (interp, dt), n in march_kernel.march_full.arms.items()
                if (interp, dt) != ("default", "bfloat16"))
          + eikonal_vjp.march_bwd.arms["float32"])


def _shipped_kernels(model, first, batch_rays, jitter, seed):
  """K1, K2 with the head off and K2 with its bf16 head at march_interp
  "default" (the render chunk and the batch) and K3's bf16 arm at the
  'all' batch, each against its plain version of the same arm
  (debug/precision_arms.py), timed, with bounds; returns report rows."""
  ps = model.path_sampler
  geo = (ps.spec, ps.grid)
  steps, near, h = ps.num_samples, ps.near, ps.step_size
  rows = {}
  for kind, case in (("march_lean", precision_arms.k1_arm),
                     ("march_full_plain", precision_arms.head_off_arm)):
    errs, figures = [], {}
    for shape, rays in (("chunk", first), ("batch", batch_rays)):
      o, d = rays.origins, rays.viewdirs
      extra = (jitter,) if kind == "march_lean" else ()
      args_ = (*geo, o, d, near, h, steps, *extra, "default")
      err, out, plain_ms = case(*args_)
      pos = out[0] if kind == "march_lean" else out[..., 0:3]
      distinct = distinct_voxels(ps.spec, pos)
      del out
      errs.append(err)
      fn = (march_kernel.march_lean if kind == "march_lean" else
            march_kernel.march_full_plain)
      call = lambda: fn(*args_)
      ms = cuda_ms(call)
      kernel = ("march_lean_kernel<2>" if kind == "march_lean" else
                "march_full_plain_kernel<2>")
      dev_ms, _ = kernel_device_ms(call, kernel)
      batch = o.shape[0]
      if kind == "march_lean":
        nbytes = (4 * 7 * batch * (steps + jitter.shape[0])
                  + 4 * (6 * batch + jitter.shape[0]) + 16 * distinct)
      else:
        nbytes = (4 * march_kernel.FULL_ROW * batch * steps + 4 * 6 * batch
                  + 16 * distinct)
      bound_ms, bound_by = bound(nbytes, 120 * batch * steps)
      figures[shape] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "err": err}
      log(f"  {kind} [default] {shape} ({batch} x {steps}): max abs err "
          f"{err:.3e} against the plain version (tolerance {K1_ATOL}), "
          f"{ms:.4f} ms, kernel {dev_ms:.4f} ms, "
          f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by}")
    if not (np.all(np.isfinite(errs)) and max(errs) <= K1_ATOL):
      raise SystemExit(f"shipped: {kind} at default disagrees with its "
                       f"plain version: {errs}")
    f = figures["chunk"]
    rows[kind] = report_row(
        kind, MARCH_KERNEL, max(errs), f["ms"], f["plain_ms"], f["bound_ms"],
        f["bound_by"], source=("samplenerfro_torch/ops/csrc/march_lean.cu"),
        arm="march_interp=default", device_ms=f["device_ms"],
        batch_ms=figures["batch"]["ms"],
        batch_device_ms=figures["batch"]["device_ms"],
        batch_plain_ms=figures["batch"]["plain_ms"],
        batch_bound_ms=figures["batch"]["bound_ms"])
    rows[kind]["name"] = f"{kind}[default]"

  # K2 at the 'all' batch and at a render chunk (eval of an 'all' stage);
  # the batch's plain trajectory is K3's input below.
  so3 = so3_params_for(seed, ps.grid.device)
  nparams = sum(p.numel() for p in so3)
  figures = {}
  for shape, rays in (("chunk", first), ("batch", batch_rays)):
    o, d = rays.origins, rays.viewdirs
    forced, free, traj, want, plain2 = precision_arms.k2_arm(
        *geo, o, d, near, h, steps, so3, SO3_ALPHA, "default", "bfloat16")
    active = int((traj[..., 8:11].norm(dim=-1) > 1e-3).sum())
    distinct = distinct_voxels(ps.spec, traj[..., 0:3])
    scale = want.abs().reshape(-1, 11).amax(dim=0).clamp(min=1e-3)
    free_share = max(e / float(s) for e, s in zip(free, scale)) / (
        SHIPPED_FREE_ENVELOPE)
    log(f"  march_so3 [default, bf16 head] {shape} ({o.shape[0]} x "
        f"{steps}): teacher-forced {forced} (tolerance {K2_ATOL}); "
        f"free-running max abs err per channel {free}, {free_share:.3f} of "
        f"the bf16 envelope")
    if not (all(np.isfinite(v) and v <= K2_ATOL for v in forced.values())
            and free_share <= 1.0):
      raise SystemExit(f"shipped: K2 in its reduced arm disagrees with its "
                       f"plain version at the {shape}")
    del traj
    fwd = (*geo, o, d, near, h, steps, so3, SO3_ALPHA, SO3_MAX_DEG,
           "default", "bfloat16")
    call = lambda: march_kernel.march_full(*fwd)
    ms2 = cuda_ms(call)
    dev2, _ = kernel_device_ms(call, "march_so3_kernel<2, true>")
    # Least work: the head's forward a ray-step, bf16 operands summed in
    # fp32, at the dense bf16 tensor-core rate (as K3's below and the bf16
    # MLP rows), ~120 fp32 operations of the step at the CUDA cores', and
    # the trajectory, the voxels and the weights moved once.
    mlp_flops = so3_flops(so3) * active
    bytes2 = 44 * o.shape[0] * steps + 16 * distinct + 24 * o.shape[0] + (
        4 * nparams)
    ops2 = 1e3 * (mlp_flops / BF16_TC_FLOPS
                  + 120 * o.shape[0] * steps / FP32_FLOPS)
    bytes2_ms = 1e3 * bytes2 / HBM_BYTES_PER_S
    bound2, by2 = max(ops2, bytes2_ms), ("bytes" if bytes2_ms >= ops2 else
                                         "operations")
    log(f"  march_so3 [default, bf16 head] {shape}: {ms2:.4f} ms, kernel "
        f"{dev2:.4f} ms, plain {plain2:.3f} ms, bound {bound2:.4f} ms by "
        f"{by2} ({active} active ray-steps)")
    figures[shape] = {"ms": ms2, "device_ms": dev2, "plain_ms": plain2,
                      "bound_ms": bound2, "bound_by": by2,
                      "err": max(forced.values()), "free": max(free)}
    if shape == "chunk":
      del want
  f, c = figures["batch"], figures["chunk"]
  rows["march_full"] = report_row(
      "march_so3", MARCH_KERNEL, max(f["err"], c["err"]), f["ms"],
      f["plain_ms"], f["bound_ms"], f["bound_by"],
      arm="march_interp=default, march_bwd_dtype=bfloat16 (bf16 head)",
      device_ms=f["device_ms"], free_running_max_abs_err=max(f["free"],
                                                             c["free"]),
      chunk_ms=c["ms"], chunk_device_ms=c["device_ms"],
      chunk_plain_ms=c["plain_ms"], chunk_bound_ms=c["bound_ms"])
  rows["march_full"]["name"] = "march_so3[default,bf16]"

  # K3's bf16 arm on the plain march's trajectory (as phase 4 holds the
  # fp32 arm), with P3's bf16 flips replayed.
  cfg = eikonal_vjp.MarchConfig(ps.spec, near, h, steps, SO3_MAX_DEG,
                                "default", "bfloat16")
  dtraj = torch.randn(want.shape, generator=torch.Generator().manual_seed(
      seed + 1)).to(want.device)
  errs, flips, same, got, plain3 = precision_arms.k3_bf16_case(
      cfg, ps.grid, o, d, so3, SO3_ALPHA, want, dtraj)
  for k, (e, share) in errs.items():
    log(f"  K3 [bf16] {k}: max abs err {e:.3e} ({share:.3f} of "
        f"{precision_arms.K3_BF16_FORM} x max|want|)")
  log(f"  K3 [bf16]: P3's bf16 flips replayed per layer {flips}; two runs "
      f"bit for bit: {same}")
  fp32 = eikonal_vjp.march_bwd(cfg._replace(bwd_dtype="float32"), ps.grid, o,
                               d, so3, SO3_ALPHA, want, dtraj)
  moved = {name: round(float((a - b).abs().max()
                             / b.abs().max().clamp(min=1e-30)), 6)
           for name, a, b in zip(precision_arms.K3_NAMES,
                                 precision_arms.k3_flat(got),
                                 precision_arms.k3_flat(fp32))}
  log(f"  K3 [bf16] against K3 [fp32] on the same inputs, max abs "
      f"difference over the fp32 arm's largest value per tensor: {moved}")
  del got, fp32
  if not (same and all(share <= 1.0 for _, share in errs.values())):
    raise SystemExit("shipped: K3's bf16 arm disagrees with its plain "
                     "version or is not deterministic")
  bwd = (cfg, ps.grid, o, d, so3, SO3_ALPHA, want, dtraj)
  call = lambda: eikonal_vjp.march_bwd(*bwd)
  ms3 = cuda_ms(call)
  split = precision_arms.k3_split(call)
  # Least work: the head's three products a ray-step (forward, backward to
  # the input, weight gradients) at the dense bf16 tensor-core rate, ~200
  # fp32 operations of step adjoints a ray-step at the CUDA cores', and the
  # trajectory and its cotangent, the voxels, the weights and their
  # gradients moved once.
  batch = o.shape[0]
  t_ops = 1e3 * (3 * mlp_flops / BF16_TC_FLOPS
                 + 200 * batch * steps / FP32_FLOPS)
  bytes3 = 2 * 44 * batch * steps + 16 * distinct + 24 * batch + 8 * nparams
  t_bytes = 1e3 * bytes3 / HBM_BYTES_PER_S
  bound3, by3 = max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops else
                                      "operations")
  log(f"  K3 [bf16] march_bwd: {ms3:.4f} ms, kernels {split} (device ms), "
      f"plain {plain3:.3f} ms, bound {bound3:.4f} ms by {by3} "
      f"({3 * mlp_flops / 1e9:.3f} GFLOP of bf16 head products, "
      f"{bytes3 / 1e6:.1f} MB)")
  rows["march_bwd"] = report_row(
      "march_bwd", MARCH_BWD_KERNEL,
      max(e for e, _ in errs.values()), ms3, plain3, bound3, by3,
      arm="march_bwd_dtype=bfloat16", device_ms=split, relu_flips=flips)
  rows["march_bwd"]["name"] = "march_bwd[bf16]"
  del want, dtraj
  return rows


def shipped_phase(device, seed, card, head_off_selfcheck):
  """16: the ship configuration as shipped (configs/tpu/ship_*: march_interp
  "default", march_bwd_dtype "bfloat16"). Each reduced arm's kernel against
  its plain version of the same arm at the ship shapes (_shipped_kernels),
  then the path as shipped, its counts zeroed first: each stage's
  N_DISPATCH steps from TRAIN_FROM one at a time and at its K (an eager
  window, then a CUDA graph), bit for bit between the two, with steps/s
  and device ms a step; the radiance stage with online sparsity on at K
  (K2 with the head off, which the shipped flags run only there); and a
  256x256 view through eval's render function, against the same view at
  march_interp "highest". Every reduced arm must launch on these paths,
  and no fp32 arm. head_off_selfcheck, the self-check's launches of K2
  with the head off at "default", is reported beside the path's.
  Returns the report rows and the figures."""
  t_phase = time.time()
  args, model, scene = ship_model(device, seed)
  if (args.march_interp, args.march_bwd_dtype) != ("default", "bfloat16"):
    raise SystemExit(f"shipped: the ship configuration sets march_interp "
                     f"{args.march_interp!r}, march_bwd_dtype "
                     f"{args.march_bwd_dtype!r}")
  view, jitter, first, host, batch_rays = ship_inputs(args, seed, device)
  log(f"shipped arms ({card}): kernels against their plain versions")
  t0 = time.time()
  rows = _shipped_kernels(model, first, batch_rays, jitter, seed)
  figures = {"kernels_s": time.time() - t0}
  del first, batch_rays
  torch.cuda.empty_cache()

  arms = dict.fromkeys(rows, 0)
  k = args.steps_per_dispatch
  hosts = [synthetic_batch(args, seed + i)
           for i in range(N_DISPATCH + TRACE_TRIES * k)]
  fp32_launches = 0
  for stage in ("radiance", "all"):
    sargs = argparse.Namespace(**{**vars(args), "stage": stage})
    per = lambda n: (n, 0, 0, 0) if stage == "radiance" else (0, n, n, 0)
    want_traced = _march_kernels(per(k))
    runs = {}
    for kk in (1, k):
      _zero_march_counts()
      runs[kk] = _dispatch_run(sargs, scene, device, seed, hosts, kk, k,
                               want_traced)
      for name, n in _arm_counts().items():
        arms[name] += n
      fp32_launches += _fp32_arm_counts()
      torch.cuda.empty_cache()
    eager, graph = runs[1], runs[k]
    differ = [key for key in eager[1]
              if not torch.equal(eager[1][key], graph[1][key])]
    figures[stage] = {"k1_steps_s": eager[3], "k1_device_ms": eager[5],
                      f"k{k}_steps_s": graph[3], f"k{k}_device_ms": graph[5]}
    log(f"shipped ({stage}, ship as shipped from step {TRAIN_FROM}, {card}):"
        f" K=1 {eager[3]:.3f} steps/s, {eager[5]:.3f} device ms a step; "
        f"K={k} {graph[3]:.3f} steps/s (a replay), {graph[5]:.3f} device ms "
        f"a step; {len(differ)} of {len(eager[1])} state tensors differ "
        f"between K=1 and K={k}; losses {[s.loss for s in graph[0][::10]]}")
    if differ or eager[0] != graph[0]:
      raise SystemExit(f"shipped: K={k} is not K=1 bit for bit in {stage}: "
                       f"{differ[:5]}")
    if not all(np.isfinite(s.loss) for s in graph[0]):
      raise SystemExit(f"shipped: non-finite loss in {stage}")
    del runs, eager, graph
  figures["k3_bf16_split_ms"] = rows["march_bwd"]["device_ms"]

  # K2 with the head off runs where a user of a shipped config turns on
  # online sparsity in radiance (the batch _shipped_kernels held it at).
  oargs = argparse.Namespace(**{**vars(args), "stage": "radiance",
                                "use_online_sparsity": True})
  run = _dispatch_run(oargs, scene, device, seed, hosts, k, k,
                      _march_kernels((0, 0, 0, k)))
  head_off = march_kernel.march_full_plain.arms["default"]
  arms["march_full_plain"] += head_off
  fp32_launches += _fp32_arm_counts()
  torch.cuda.empty_cache()
  figures["radiance online sparsity"] = {f"k{k}_steps_s": run[3],
                                         f"k{k}_device_ms": run[5]}
  log(f"shipped (radiance online sparsity, {card}): K={k} {run[3]:.3f} "
      f"steps/s (a replay), {run[5]:.3f} device ms a step; wrapper "
      f"launches K1/K2/K3/head-off {run[2]}, K2 head off [default] "
      f"{head_off}; traced windows {[list(t.values()) for t in run[4]]}; "
      f"losses {[s.loss for s in run[0][::10]]}")
  if (run[2] != (0, 0, 0, 2 * k) or run[4][-1] != _march_kernels(
      (0, 0, 0, k)) or not all(np.isfinite(s.loss) for s in run[0])):
    raise SystemExit(f"shipped: the online-sparsity radiance path launched "
                     f"{run[2]}, traced {run[4]}, or a loss is not finite")
  del run

  _zero_march_counts()
  render_fn = make_render_fn(model, jitter)
  t0 = time.time()
  rgb, dist, acc = render_lib.render_image(render_fn, view, False,
                                           chunk=args.chunk, device=device)
  torch.cuda.synchronize()
  secs = time.time() - t0
  view_launches = march_kernel.march_lean.arms["default"]
  arms["march_lean"] += view_launches
  fp32_launches += _fp32_arm_counts()
  model.path_sampler.interp = "highest"
  rgb_hi, _, acc_hi = render_lib.render_image(render_fn, view, False,
                                              chunk=args.chunk, device=device)
  model.path_sampler.interp = "default"
  n = rgb.shape[0] * rgb.shape[1]
  mse = float(np.mean((rgb - rgb_hi) ** 2))
  figures["view"] = {"seconds": secs, "rays_s": n / secs,
                     "rgb_max_abs_vs_highest": float(np.abs(rgb - rgb_hi).max()),
                     "psnr_vs_highest": float(-10 * np.log10(max(mse, 1e-20))),
                     "acc_max_abs_vs_highest": float(np.abs(acc - acc_hi).max())}
  log(f"shipped view: {rgb.shape[0]}x{rgb.shape[1]}, {secs:.3f} s, "
      f"{n / secs:.1f} rays/s, K1 [default] {view_launches} launches; "
      f"against march_interp highest {figures['view']}")
  if not (np.all(np.isfinite(rgb)) and np.all(np.isfinite(dist))
          and 0 <= acc.min() and acc.max() <= 1 and view_launches
          == -(-n // args.chunk)):
    raise SystemExit("shipped: the view is not finite or in range, or K1's "
                     "default arm did not march its chunks")
  log(f"shipped path launches by arm {arms}; fp32 arms {fp32_launches}; "
      f"K2 with the head off [default] in the self-check "
      f"{head_off_selfcheck}")
  if min(arms.values()) == 0 or fp32_launches:
    raise SystemExit(f"shipped: an arm's kernel did not launch on its path "
                     f"({arms}) or an fp32 arm did ({fp32_launches})")
  for name, row in rows.items():
    row["launches"] = arms[name]
  rows["march_full_plain"]["selfcheck_launches"] = head_off_selfcheck
  figures["seconds"] = time.time() - t_phase
  log("shipped: " + json.dumps(figures))
  del model, scene
  torch.cuda.empty_cache()
  return list(rows.values()), figures


def main():
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--seed", type=int, default=0)
  p.add_argument("--profile", action="store_true",
                 help="print device time by kernel for one render chunk "
                 "and one train step of each stage, and trace the "
                 "spherical head's 'all' step")
  ns = p.parse_args()

  t_start = time.time()
  card = device_phase()
  device = torch.device("cuda")
  build_phase()
  probe_rows = probe_phase(device)
  head_off_selfcheck = selfcheck_phase()
  probe_rows.append(p3_phase(device))
  torch.cuda.empty_cache()
  args, model, scene = ship_model(device, ns.seed, **FP32_ARMS)
  view, jitter, first, host, batch_rays = ship_inputs(args, ns.seed, device)
  log("forward marches (K1, K2) at every shape:")
  cases = march_cases(device, ns.seed, model, first, batch_rays, jitter)
  times = marches_phase(cases)
  synced = sync_phase(cases)
  del cases
  torch.cuda.empty_cache()
  if synced:
    raise SystemExit(f"sync check: {synced}")
  with torch.no_grad():
    k1 = kernel_phase(model, first, jitter)
  k2, k3 = so3_kernel_phases(model, host, ns.seed, ns.profile)
  glass = glass_phase(device, ns.seed, ns.profile)
  k3["glass_ms"] = glass["k3_ms"]
  for row, kind, shape in ((k1, "lean", "ship chunk"),
                           (k2, "so3", "ship 'all' batch")):
    row["device_ms"] = times[(kind, shape)][1]
    row["glass_device_ms"] = times[(kind, "glass")][1]
  k1["glass_chunk_device_ms"] = times[("lean", "glass chunk")][1]
  k2["glass_chunk_device_ms"] = times[("so3", "glass chunk")][1]
  k1["radiance_batch_ms"], k1["radiance_batch_device_ms"] = times[
      ("lean", "radiance batch")]
  k1["ball_batch_device_ms"] = times[("lean", "ball batch")][1]
  k1["ball_chunk_device_ms"] = times[("lean", "ball chunk")][1]
  torch.cuda.empty_cache()
  log("K2 with the head off (march_full_plain):")
  head_off = head_off_phase(device, ns.seed, model, batch_rays, jitter)
  torch.cuda.empty_cache()
  k4, k4_pe, k4_bf16, k5_bf16, k5_fp32 = fused_kernel_phases(
      model, first, batch_rays, jitter, ns.seed)
  wide_mlp_phase(device, ns.seed)
  del first, batch_rays
  torch.cuda.empty_cache()

  rgb, acc, k1["launches"], rate = main_path_phase(model, view, jitter,
                                                   args.chunk, device,
                                                   ns.profile)
  fused = fused_render_phase(model, view, jitter, args.chunk, device, rgb,
                             acc, rate, ns.profile)
  k4["launches"], k4_pe["launches"] = fused["pallas"], fused["pallas_pe"]
  counts, all_model, all_args, rate_r = train_path_phase(
      args, scene, device, ns.seed, host, ns.profile)
  k1["radiance_launches"] = counts[0]
  k2["launches"], k3["launches"] = counts[1], counts[2]
  fcounts, fused_model, fused_args = fused_train_phase(
      args, scene, device, ns.seed, host, rate_r, ns.profile)
  k4_bf16["launches"], k5_bf16["launches"] = fcounts
  dispatch = dispatch_phase(args, scene, device, ns.seed, card)
  for row, stage, i in ((k1, "radiance", 0), (k2, "all", 1), (k3, "all", 2)):
    row["dispatch_launches"] = dispatch[stage][0][i]
    row["dispatch_replay_launches"] = dispatch[stage][1][i]
  k1["ior_val_render_launches"], ior = ior_phase(args, scene, device,
                                                 ns.seed, card, view, jitter)
  option_rows, head_off["options_launches"], options = options_phase(
      args, scene, device, ns.seed, card, dispatch, model, host, jitter,
      ns.profile)
  torch.cuda.empty_cache()
  rank0, parallel = parallel_phase(args, scene, device, ns.seed, card,
                                   dispatch, view, jitter)
  for row, n in zip((k1, k2, k3), rank0):
    row["parallel_rank0_launches"] = n
  del scene, dispatch
  torch.cuda.empty_cache()
  allstep_cross_check(all_model, all_args, host, device, ns.seed)
  del all_model
  k5_fp32["launches"] = fused_cross_check(fused_model, fused_args, host,
                                          device, ns.seed)
  del fused_model
  k1["flax_ckpt_launches"] = flax_ckpt_phase(
      model, args, view, jitter, device, ns.seed)
  cross_check_phase(model, view, jitter, rgb, acc)
  del model
  torch.cuda.empty_cache()
  real = real_scene_phase(device, ns.seed)
  k1["real_scene_launches"] = real["radiance"][0]
  k2["real_scene_launches"] = real["all"][1] + real["eval"][1]
  k3["real_scene_launches"] = real["all"][2]
  torch.cuda.empty_cache()
  quick, quick_secs = quickstart_phase(device, ns.seed)
  k1["quickstart_launches"] = sum(c[0] for c in quick.values())
  torch.cuda.empty_cache()
  synth_counts, quality = quality_phase(device)
  head_off["quickstart_launches"] = quick["extract"][3]
  head_off["synth_launches"] = synth_counts[3]
  head_off["launches"] = (quick["extract"][3] + synth_counts[3]
                          + head_off["options_launches"])
  log(f"quickstart seconds {quick_secs}; quality PSNR {quality['psnr']}, "
      f"SSIM {quality['ssim']}")
  torch.cuda.empty_cache()
  llff_counts, llff = llff_phase(device, ns.seed, card)
  k1["llff_launches"] = sum(c[0] for c in llff_counts.values())
  log(f"ior figures {ior}; llff figures {llff}; options figures {options}")
  log(f"parallel figures {json.dumps(parallel)}")
  torch.cuda.empty_cache()
  shipped_rows, shipped = shipped_phase(device, ns.seed, card,
                                        head_off_selfcheck)
  log(f"shipped figures {json.dumps(shipped)}")

  report = probe_rows + [k1, k2, k3, head_off, k4, k4_pe, k4_bf16, k5_bf16,
                         k5_fp32] + option_rows + shipped_rows
  log(f"total: {time.time() - t_start:.1f} s")
  log(f"card: {card}")
  print(json.dumps({"kernels": report}))
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
  sys.exit(main())
