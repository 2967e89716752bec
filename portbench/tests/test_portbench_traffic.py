"""The generators give the same inputs for the same seed, and others for
another."""

import hashlib
import os

import torch

from portbench.reference import model as ref_model
from portbench.tests import tiny
from portbench.traffic import capture
from portbench.traffic import weights


def _digest(d):
  h = hashlib.sha256()
  for base, _, files in sorted(os.walk(d)):
    for name in sorted(files):
      with open(os.path.join(base, name), "rb") as f:
        h.update(name.encode() + f.read())
  return h.hexdigest()


def test_capture_is_a_function_of_the_seed(tmp_path):
  cfg = tiny.tiny_config()
  a = capture.write_capture(cfg, str(tmp_path / "a"), 2**31 + 5)
  b = capture.write_capture(cfg, str(tmp_path / "b"), 2**31 + 5)
  c = capture.write_capture(cfg, str(tmp_path / "c"), 2**31 + 6)
  assert _digest(a) == _digest(b) != _digest(c)


def test_poses_grid_and_weights_are_functions_of_the_seed():
  cfg = tiny.tiny_config()
  p1, p2 = (capture.test_poses(cfg, 99, 4) for _ in range(2))
  assert (p1 == p2).all() and not (p1 == capture.test_poses(cfg, 98, 4)).all()
  assert torch.equal(capture.raw_grid(cfg, "cpu"), capture.raw_grid(cfg, "cpu"))
  shapes = ref_model.param_shapes(cfg)
  w1, w2, w3 = (weights.make(shapes, s, "cpu", 1e-2) for s in (3, 3, 4))
  assert all(torch.equal(w1[k], w2[k]) for k in shapes)
  assert not torch.equal(w1["coarse_mlp.layers.0.weight"],
                         w3["coarse_mlp.layers.0.weight"])


def test_every_seed_sends_the_same_sizes(tmp_path):
  from portbench.reference import scene
  cfg = tiny.tiny_config()
  shapes = []
  for seed in (1, 2**31 + 11):
    d = capture.write_capture(cfg, str(tmp_path / str(seed)), seed)
    b = scene.Batches(cfg, d, seed, seed + 1).next("cpu")
    shapes.append({k: tuple(v.shape) for k, v in b.items()})
  assert shapes[0] == shapes[1]
  f = cfg["flags"]
  assert shapes[0]["origins"] == (f["batch_size"], 3)
  assert shapes[0]["env_viewdirs"] == (f["bg_patch_size"],) * 2 + (3,)
