"""A synthetic OpenCV capture at a real scene's sizes, made from a seed.

    python -m samplenerfro_torch.debug.real_scene <data_dir> [--width 320]
        [--height 240] [--grid_n 384]

Writes what a calibrated capture holds (transforms_{train,val,test}.json
with `cam_mat` and OpenCV camera-to-world poses, frames named with their
extension, RGB PNGs) and the IOR grid `<GLASS_GRID>/mesh.pkl` that
voxelize_mesh.py writes, here a smooth Gaussian blob
(utils/grid_io.synthetic_blob_grid) stored in float32. The defaults give
glass's layout (configs/tpu/glass.gin: `voxelize_uni384_bbox-3.5`, a 384^3
grid of extent 3.5; 226 MB). NUM_TRAIN train views, one val and one test
view; the cameras sit on a ring of radius RADIUS around the y axis, the
real scenes' up axis (their boundary cut lowers the box's top in y), a
little above the grid's centre and looking at it, with an off-centre
principal point. The images are smooth colour ramps that turn with the
view, so the loss has something to fit.
"""

import argparse
import json
import os
import pickle

import numpy as np

from samplenerfro_torch.utils import grid_io

GLASS_GRID = "voxelize_uni384_bbox-3.5"
EXTENT = 3.5
NUM_TRAIN = 8
RADIUS = 6.0
SEED = 0
# The blob 1 + PEAK * exp(-r^2 / SIGMA2). A SIGMA2 of 2 makes an object that
# fills most of the view, as a captured glass does, so that the training
# batches' 16x16 tiles march through its IOR gradients (at 0.25, whole
# batches miss it and the so3 head never runs).
PEAK = 0.33
SIGMA2 = 2.0


def write_blob_grid(grid_dir, n, extent):
  """<grid_dir>/mesh.pkl holding an n^3 blob in float32, with mesh.pkl's
  keys; returns its path."""
  values, _, _, _ = grid_io.synthetic_blob_grid(n, extent, PEAK, SIGMA2)
  os.makedirs(grid_dir, exist_ok=True)
  pth = os.path.join(grid_dir, "mesh.pkl")
  with open(pth, "wb") as f:
    pickle.dump({"data": values, "extent": float(extent),
                 "min_point": [-extent] * 3, "max_point": [extent] * 3,
                 "num_voxels": int(n)}, f, protocol=pickle.HIGHEST_PROTOCOL)
  return pth


def opencv_pose(eye, target, up=(0.0, 1.0, 0.0)):
  """OpenCV camera-to-world: x right, y down, the camera looks down +z at
  `target`."""
  eye = np.asarray(eye, np.float64)
  fwd = np.asarray(target, np.float64) - eye
  fwd /= np.linalg.norm(fwd)
  right = np.cross(fwd, up)
  right /= np.linalg.norm(right)
  down = np.cross(fwd, right)
  c2w = np.eye(4)
  c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, eye
  return c2w


def write_scene(data_dir, width=320, height=240, grid_n=384):
  """Write the capture and the grid; returns data_dir."""
  from PIL import Image
  rng = np.random.RandomState(SEED)
  fx = fy = 0.9 * width
  cam_mat = [[fx, 0.0, 0.5 * width + 7.25], [0.0, fy, 0.5 * height - 5.5],
             [0.0, 0.0, 1.0]]
  os.makedirs(os.path.join(data_dir, "imgs"), exist_ok=True)
  ys, xs = np.mgrid[0:height, 0:width].astype(np.float64)
  idx = 0
  for split, count in (("train", NUM_TRAIN), ("val", 1), ("test", 1)):
    frames = []
    for _ in range(count):
      theta = 2 * np.pi * idx / (NUM_TRAIN + 2) + rng.uniform(-0.1, 0.1)
      eye = [RADIUS * np.cos(theta), 1.5 + rng.uniform(-0.3, 0.3),
             RADIUS * np.sin(theta)]
      c2w = opencv_pose(eye, (0.0, 0.0, 0.0))
      u, v = xs / width, ys / height
      img = np.stack([0.5 + 0.4 * np.cos(theta + 2 * u),
                      0.3 + 0.5 * v * (1 + np.sin(theta)) / 2,
                      0.4 + 0.3 * np.sin(3 * u + 2 * v + theta)], axis=-1)
      name = f"imgs/r_{idx:03d}.png"
      Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
          os.path.join(data_dir, name))
      frames.append({"file_path": name, "transform_matrix": c2w.tolist()})
      idx += 1
    with open(os.path.join(data_dir, f"transforms_{split}.json"), "w") as f:
      json.dump({"cam_mat": cam_mat, "frames": frames}, f)
  write_blob_grid(os.path.join(data_dir, GLASS_GRID), grid_n, EXTENT)
  return data_dir


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("data_dir")
  p.add_argument("--width", type=int, default=320)
  p.add_argument("--height", type=int, default=240)
  p.add_argument("--grid_n", type=int, default=384)
  ns = p.parse_args(argv)
  print(write_scene(ns.data_dir, ns.width, ns.height, ns.grid_n))


if __name__ == "__main__":
  main()
