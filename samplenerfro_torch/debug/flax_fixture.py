"""The JAX-written checkpoints committed under debug/fixtures/flax_ckpt/,
and what the port does with them.

The JAX package wrote them once (tests/test_torch_flax_ckpt.py rewrites
them when run as a script): a narrow ship-configured model's TrainState
(OVERRIDES: 2x16 MLPs with a 1x16 view branch; the background MLP and
the so3 head keep their fixed 4x128) after STEP radiance train steps, as

  orbax/checkpoint_<STEP>      an orbax OCDBT directory (what the JAX
                               package's save_checkpoint writes);
  msgpack/checkpoint_<STEP>    the same state as a legacy flax msgpack
                               file (flax's orbax switch off);
  reference/checkpoint_<STEP>  its params in the reference repo's layout,
                               a legacy msgpack file (the JAX package's
                               export_reference_checkpoint, orbax off);
  leaves.json, leaves.npz      every leaf that flax's
                               restore_checkpoint(path, None) gave for
                               each: leaves.json maps each format's '/'-
                               joined leaf paths to a spec (an array's
                               dtype and its key in leaves.npz, which
                               holds each distinct array once, bfloat16
                               as its uint16 bits; a Python number; a
                               None or an empty dict).

`check()` restores all three with the port's readers (no flax, orbax,
msgpack or tensorstore) and holds every leaf against leaves.npz bit for
bit. `resume()` restores the orbax state into the port's model and Adam
and runs training windows on from it.
"""

import argparse
import hashlib
import json
import os
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from samplenerfro_torch.data import prefetch
from samplenerfro_torch.debug import march_parity
from samplenerfro_torch.ops import march_kernel
from samplenerfro_torch.train import checkpoints
from samplenerfro_torch.train import flax_checkpoints
from samplenerfro_torch.train import loop as train_loop
from samplenerfro_torch.train import step as step_lib
from samplenerfro_torch.utils import flax_msgpack

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "flax_ckpt"
STEP = 3
STAGE = "radiance"
OVERRIDES = {"net_depth": 2, "net_width": 16, "net_depth_condition": 1,
             "net_width_condition": 16}
FORMATS = ("orbax", "msgpack", "reference")


def checkpoint_path(fmt, fixture=FIXTURE):
  return os.path.join(fixture, fmt, f"checkpoint_{STEP}")


def _is_bfloat16(v):
  return (isinstance(v, flax_msgpack.Bfloat16Bits)
          or getattr(getattr(v, "dtype", None), "name", "") == "bfloat16")


def describe(tree, arrays, prefix=""):
  """{'/'-joined leaf path: spec} of a restored tree; each array's bits go
  into `arrays` under a digest of its dtype, shape and bytes."""
  out = {}
  for k, v in tree.items():
    path = f"{prefix}{k}"
    if isinstance(v, dict):
      if v:
        out.update(describe(v, arrays, path + "/"))
      else:
        out[path] = {"empty_dict": True}
    elif v is None:
      out[path] = {"none": True}
    elif type(v) in (bool, int, float):
      out[path] = {type(v).__name__: v}
    else:
      bf16 = _is_bfloat16(v)
      arr = np.asarray(v)
      bits = arr.view(np.uint16) if bf16 else arr
      dtype = "bfloat16" if bf16 else arr.dtype.name
      h = hashlib.sha256(f"{dtype}{arr.shape}".encode())
      h.update(np.ascontiguousarray(bits).tobytes())
      key = h.hexdigest()[:24]
      arrays[key] = np.array(bits)
      out[path] = {"array": key, "dtype": dtype,
                   "scalar": isinstance(v, np.generic)}
  return out


def write_index(restored, fixture=FIXTURE):
  """Write leaves.json and leaves.npz of {format: restored tree}."""
  arrays = {}
  index = {fmt: describe(tree, arrays) for fmt, tree in restored.items()}
  with open(os.path.join(fixture, "leaves.json"), "w") as f:
    json.dump(index, f, indent=1, sort_keys=True)
  np.savez_compressed(os.path.join(fixture, "leaves.npz"), **arrays)


def read_index(fixture=FIXTURE):
  """(index, {key: array}) of the committed leaves."""
  with open(os.path.join(fixture, "leaves.json")) as f:
    index = json.load(f)
  with np.load(os.path.join(fixture, "leaves.npz")) as f:
    arrays = {k: f[k] for k in f.files}
  return index, arrays


def compare(fmt, tree, index, arrays):
  """The differences between a restored tree and the committed leaves of
  `fmt`: every spec equal, every array equal to its leaves.npz entry in
  dtype, shape and bytes."""
  got_arrays = {}
  got = describe(tree, got_arrays)
  want = index[fmt]
  bad = [f"{fmt}: {p}: {got.get(p)} != {want.get(p)}"
         for p in sorted(set(got) | set(want)) if got.get(p) != want.get(p)]
  for key, arr in got_arrays.items():
    ref = arrays.get(key)
    if (ref is None or ref.dtype != arr.dtype or ref.shape != arr.shape
        or ref.tobytes() != arr.tobytes()):
      bad.append(f"{fmt}: array {key} differs from leaves.npz")
  return bad


def check(fixture=FIXTURE):
  """Restore every committed checkpoint with the port and hold it against
  leaves.npz bit for bit. Returns {"leaves", "arrays", "seconds":
  {format: restore seconds}}; raises ValueError listing what differs."""
  index, arrays = read_index(fixture)
  seconds, bad = {}, []
  for fmt in FORMATS:
    t0 = time.time()
    tree = flax_checkpoints.restore(checkpoint_path(fmt, fixture))
    seconds[fmt] = time.time() - t0
    bad += compare(fmt, tree, index, arrays)
  if bad:
    raise ValueError(f"{len(bad)} leaves differ: " + "; ".join(bad[:8]))
  return {"leaves": sum(len(v) for v in index.values()),
          "arrays": len(arrays), "seconds": seconds}


def fixture_args(**overrides):
  """The flag namespace of the fixture's model: the ship configuration
  with OVERRIDES, in the radiance stage."""
  args, _, _ = march_parity.config_lib.load_args(
      march_parity.SHIP, [march_parity.SHIP + ".gin"],
      **{**OVERRIDES, "stage": STAGE, **overrides})
  return args


def stage_copy(train_dir, fmt="orbax", fixture=FIXTURE):
  """Copy a committed checkpoint into <train_dir>/<STAGE>/ as the JAX
  train.py left it; returns the stage directory."""
  stage_dir = os.path.join(train_dir, STAGE)
  os.makedirs(stage_dir, exist_ok=True)
  src, dst = checkpoint_path(fmt, fixture), os.path.join(
      stage_dir, f"checkpoint_{STEP}")
  if os.path.isdir(src):
    shutil.copytree(src, dst)
  else:
    shutil.copy(src, dst)
  return stage_dir


def resume(stage_dir, device, k, windows=1, seed=0, grid_n=64, **overrides):
  """Restore the newest checkpoint of stage_dir into the fixture's model
  (weights drawn from `seed` first, then overwritten) and its Adam, then
  run `windows` dispatch windows of k steps from the restored step + 1
  through loop.host_window, data/prefetch.py and
  step.make_train_step_multi, on synthetic batches, jitters and noise
  drawn from `seed`; `overrides` are flags that leave the weights' shapes
  as they are (batch_size, bg_patch_size).

  Returns (model, optimizer, restored step, [Stats of each step], the
  restored Adam counts, K1's launches in the steps, by its wrapper).
  """
  flags = {**OVERRIDES, "stage": STAGE, "steps_per_dispatch": k,
           **overrides}
  args = argparse.Namespace(**vars(fixture_args(**flags)))
  _, model, _ = march_parity.ship_model(device, seed, grid_n, **flags)
  optimizer, _, _ = step_lib.create_optimizer(model, args)
  step = checkpoints.restore_checkpoint(stage_dir, model, optimizer)
  counts = [int(c) for c in optimizer.counts]
  run = step_lib.make_train_step_multi(
      model, optimizer, args, k, torch.Generator(device=device).manual_seed(
          seed))
  jitter_gen = torch.Generator().manual_seed(seed)
  hosts = iter([march_parity.synthetic_batch(args, seed + i)
                for i in range(windows * k)])
  stats = []
  launches = march_kernel.march_lean.launches
  for first, last in train_loop.dispatch_windows(step + 1, step + windows * k,
                                                 k):
    host = train_loop.host_window(hosts, first, last, args, optimizer,
                                  jitter_gen)
    stats += run(prefetch.to_device(host, device)).per_step()
  launches = march_kernel.march_lean.launches - launches
  return model, optimizer, step, stats, counts, launches
