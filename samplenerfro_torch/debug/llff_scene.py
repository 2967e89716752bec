"""A synthetic LLFF capture, made from a seed.

    python -m samplenerfro_torch.debug.llff_scene <data_dir> [--views 16]
        [--width 160] [--height 136] [--factor 2] [--grid_n 128]
        [--inward]

Writes what imgs2poses (calib/imgs2poses.py, COLMAP) leaves for an LLFF
scene: images<_factor>/NNN.jpg and poses_bounds.npy (per view the 3x5
camera-to-world pose in LLFF's [down, right, backwards] columns with its
full-resolution height, width and focal length, then the near and far
bounds), and the IOR grid voxelize/mesh.pkl, a smooth Gaussian blob
(debug/real_scene.write_blob_grid). The cameras look at the origin from
the +z side: from a small arc (forward-facing, the spiral path's case)
or, with `inward`, from a ring of +-60 degrees around the y axis (the
spherified capture's case). The images are smooth colour ramps that turn
with the view.
"""

import argparse
import os

import numpy as np

from samplenerfro_torch.debug import real_scene

GRID_DIR = "voxelize"
EXTENT = 1.5
RADIUS = 4.0
SEED = 0


def look_at(eye, target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0)):
  """(right, up, backwards) camera axes and the eye, the columns of a
  camera-to-world pose that looks at `target`."""
  eye = np.asarray(eye, np.float64)
  back = eye - np.asarray(target, np.float64)
  back /= np.linalg.norm(back)
  right = np.cross(up, back)
  right /= np.linalg.norm(right)
  return right, np.cross(back, right), back, eye


def write_scene(data_dir, views=16, width=160, height=136, factor=2,
                grid_n=128, inward=False, focal=None, bounds=(2.0, 6.0)):
  """Write the capture and the grid; returns data_dir. The images are
  `width` x `height`, stored in images_<factor>/ (images/ for factor 0);
  poses_bounds.npy holds the full resolution's hwf, as COLMAP's does.
  `focal` is in the stored images' pixels (default 1.1 * width)."""
  from PIL import Image
  rng = np.random.RandomState(SEED)
  scale = max(factor, 1)
  focal = 1.1 * width if focal is None else focal
  imgdir = os.path.join(data_dir, f"images_{factor}" if factor else "images")
  os.makedirs(imgdir, exist_ok=True)
  ys, xs = np.mgrid[0:height, 0:width].astype(np.float64)
  u, v = xs / width, ys / height
  rows = []
  for i in range(views):
    t = i / max(views - 1, 1) - 0.5
    if inward:
      theta = np.pi / 3 * 2 * t
      eye = [RADIUS * np.sin(theta), 0.6 * np.cos(5 * t),
             RADIUS * np.cos(theta)]
    else:
      eye = [0.8 * t, 0.3 * np.sin(4 * t) + rng.uniform(-0.05, 0.05),
             RADIUS]
    right, up, back, eye = look_at(eye)
    pose = np.stack([-up, right, back, eye,
                     [height * scale, width * scale, focal * scale]], axis=1)
    rows.append(np.concatenate([pose.ravel(), bounds]))
    img = np.stack([0.5 + 0.4 * np.cos(3 * t + 2 * u),
                    0.3 + 0.5 * v * (1 + np.sin(2 * t)) / 2,
                    0.4 + 0.3 * np.sin(3 * u + 2 * v + t)], axis=-1)
    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
        os.path.join(imgdir, f"{i:03d}.jpg"), quality=95)
  np.save(os.path.join(data_dir, "poses_bounds.npy"), np.stack(rows))
  real_scene.write_blob_grid(os.path.join(data_dir, GRID_DIR), grid_n,
                             EXTENT)
  return data_dir


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("data_dir")
  p.add_argument("--views", type=int, default=16)
  p.add_argument("--width", type=int, default=160)
  p.add_argument("--height", type=int, default=136)
  p.add_argument("--factor", type=int, default=2)
  p.add_argument("--grid_n", type=int, default=128)
  p.add_argument("--inward", action="store_true")
  ns = p.parse_args(argv)
  print(write_scene(ns.data_dir, ns.views, ns.width, ns.height, ns.factor,
                    ns.grid_n, ns.inward))


if __name__ == "__main__":
  main()
