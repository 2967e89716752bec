"""The seeded inputs of a cell: a capture on disk, test poses, the grid.

One general generator for every configuration: the configuration's
`scene` block says the capture's layout (Blender or OpenCV), its size, its
views and where its cameras sit, and the grid's lattice and blob; the
traffic mix (portbench/traffic/<mix>.json) says what the cell sends
through them. The same seed gives the same files, poses and values.

The images are smooth colour fields whose frequencies and phases come
from the seed, turning with the view, so the loss has something to fit.
The cameras sit on a ring around the scene's up axis looking at the
grid's centre, the same set of views for every seed in a seeded order.
"""

import json
import os

import numpy as np
import torch


def _rng(seed, salt):
  return np.random.RandomState((int(seed) * 7919 + salt) % 2**32)


def look_at(eye, up, opencv):
  """Camera-to-world of a camera at `eye` looking at the origin: OpenCV's
  (x right, y down, looking down +z) or Blender's (x right, y up, looking
  down -z)."""
  eye = np.asarray(eye, np.float64)
  fwd = -eye / np.linalg.norm(eye)
  right = np.cross(fwd, up)
  right /= np.linalg.norm(right)
  c2w = np.eye(4)
  if opencv:
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = right, np.cross(fwd, right), fwd
  else:
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = right, np.cross(right, fwd), -fwd
  c2w[:3, 3] = eye
  return c2w


def ring_poses(sc, count, rng, opencv):
  """`count` camera-to-worlds on the scene's ring: evenly spaced angles,
  heights evenly spaced over the elevation range, assigned to the angles
  in an order drawn from `rng`. The grid's blob is symmetric about its
  centre, so every seed sends the same set of views, in another order."""
  up = np.array(sc["up"], np.float64)
  a = np.array([1.0, 0.0, 0.0]) if abs(up[0]) < 0.9 else np.array(
      [0.0, 1.0, 0.0])
  e1 = np.cross(up, a)
  e1 /= np.linalg.norm(e1)
  e2 = np.cross(up, e1)
  lifts = np.linspace(*sc["elevation"], count)[rng.permutation(count)]
  poses = []
  for i, lift in enumerate(lifts):
    theta = 2 * np.pi * (i + 0.5) / count
    eye = sc["radius"] * (np.cos(lift) * (np.cos(theta) * e1
                                          + np.sin(theta) * e2)
                          + np.sin(lift) * up)
    poses.append(look_at(eye, up, opencv))
  return np.stack(poses)


def image(w, h, rng):
  """A smooth [h, w, 3] colour field in (0, 1) from `rng`."""
  v, u = np.mgrid[0:h, 0:w].astype(np.float32)
  u, v = u / w, v / h
  freq = rng.uniform(1.0, 6.0, (3, 2)).astype(np.float32)
  phase = rng.uniform(0, 2 * np.pi, 3).astype(np.float32)
  return np.stack([0.5 + 0.4 * np.sin(freq[c, 0] * u + freq[c, 1] * v
                                      + phase[c]) for c in range(3)], -1)


def write_capture(cfg, data_dir, seed):
  """The capture's train split under data_dir, as a capture of the
  configuration's layout holds it; returns data_dir."""
  from PIL import Image
  sc = cfg["scene"]
  opencv = cfg["flags"]["dataset"] == "opencv"
  rng = _rng(seed, 1)
  w, h = sc["width"], sc["height"]
  poses = ring_poses(sc, sc["train_views"], rng, opencv)
  frames = []
  os.makedirs(os.path.join(data_dir, "train"), exist_ok=True)
  for i, c2w in enumerate(poses):
    name = f"train/r_{i:03d}"
    pix = (np.clip(image(w, h, rng), 0, 1) * 255).astype(np.uint8)
    Image.fromarray(pix).save(os.path.join(data_dir, name + ".png"),
                              compress_level=1)
    frames.append({"file_path": name + (".png" if opencv else ""),
                   "transform_matrix": c2w.tolist()})
  meta = {"frames": frames}
  if opencv:
    f = sc["focal_scale"] * w
    meta["cam_mat"] = [[f, 0.0, 0.5 * w + sc["principal_offset"][0]],
                       [0.0, f, 0.5 * h + sc["principal_offset"][1]],
                       [0.0, 0.0, 1.0]]
  else:
    meta["camera_angle_x"] = sc["camera_angle_x"]
  for split in ("train", "val", "test"):
    # val and test hold the train views: only the train split is read.
    with open(os.path.join(data_dir, f"transforms_{split}.json"), "w") as f:
      json.dump(meta, f)
  return data_dir


def test_poses(cfg, seed, count):
  """[count, 4, 4] camera-to-worlds of test views on the scene's ring."""
  return ring_poses(cfg["scene"], count, _rng(seed, 2),
                    cfg["flags"]["dataset"] == "opencv")


def raw_grid(cfg, device):
  """The scene's raw IOR values [N^3] on `device`: the blob
  1 + peak exp(-r^2 / sigma2) on the lattice, made on the device."""
  sc = cfg["scene"]
  n, e = sc["grid_n"], sc["grid_extent"]
  axis = torch.linspace(-e, e, n, dtype=torch.float64, device=device)
  r2 = (axis[:, None, None]**2 + axis[None, :, None]**2
        + axis[None, None, :]**2)
  vals = 1.0 + sc["blob_peak"] * torch.exp(-r2 / sc["blob_sigma2"])
  return vals.reshape(-1).to(torch.float32)
