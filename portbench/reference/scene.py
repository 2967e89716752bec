"""The reference's own reading of a cell's inputs.

From the raw inputs the benchmark made (the capture's PNG files and
poses, the grid's raw values) it derives again what the program derives:
the downsampled images, each pixel's ray, the prefiltered grid and its
gradient, and the training batches (16x16 pixel tiles of one image, an
env-ray patch of another, drawn from a numpy RandomState in the order a
capture loader of this layout draws them) and their coarse-sample jitters.
"""

import json
import os

import numpy as np
import torch
from PIL import Image

from portbench.reference import model


class Scene:
  """A configuration's grid and stage on a device."""

  def __init__(self, cfg, raw_grid, stage, device):
    sc = cfg["scene"]
    n, e = sc["grid_n"], sc["grid_extent"]
    self.cfg, self.stage, self.device = cfg, stage, device
    self.spec = model.Spec([n] * 3, [-e] * 3, [e] * 3)
    values = model.prefilter(raw_grid.to(device), self.spec.ndim,
                             cfg["gin"]["Config.kernel_size"],
                             cfg["gin"]["Config.kernel_sigma"])
    self.data = model.grid_data(self.spec, values)
    self.lat = model.lattice(self.spec, device)
    self.cut_box = None
    if "cut_box_top_drop" in sc:
      nmax = list(self.spec.nmax)
      nmax[1] -= sc["cut_box_top_drop"]
      self.cut_box = (list(self.spec.nmin), nmax)


def _finish_rays(cam_dirs, c2w):
  world = (cam_dirs[None, ..., None, :] * c2w[:, None, None, :3, :3]).sum(-1)
  origins = np.broadcast_to(c2w[:, None, None, :3, -1], world.shape)
  viewdirs = world / np.linalg.norm(world, axis=-1, keepdims=True)
  return origins.astype(np.float32), viewdirs.astype(np.float32)


def pinhole_rays(w, h, focal, c2w):
  """(origins, viewdirs) [n, h, w, 3] of pixel centres, the camera looking
  down -z (the Blender layout)."""
  x, y = np.meshgrid(np.arange(w, dtype=np.float32) + 0.5,
                     np.arange(h, dtype=np.float32) + 0.5, indexing="xy")
  d = np.stack([(x - w * 0.5) / focal, -(y - h * 0.5) / focal,
                -np.ones_like(x)], -1)
  return _finish_rays(d, c2w)


def opencv_rays(w, h, k, c2w):
  """(origins, viewdirs) [n, h, w, 3] of an intrinsics matrix k, the camera
  looking down +z (the OpenCV layout; the half-pixel on the principal
  point)."""
  x, y = np.meshgrid(np.arange(w, dtype=np.float32),
                     np.arange(h, dtype=np.float32), indexing="xy")
  d = np.stack([(x - k[0][2] + 0.5) / k[0][0], (y - k[1][2] + 0.5) / k[1][1],
                np.ones_like(x)], -1)
  return _finish_rays(d, c2w)


def load_split(cfg, data_dir, split):
  """(origins, viewdirs, pixels) [n, h, w, 3] float32 of a capture split."""
  opencv = cfg["flags"]["dataset"] == "opencv"
  with open(os.path.join(data_dir, f"transforms_{split}.json")) as f:
    meta = json.load(f)
  images, c2w = [], []
  for frame in meta["frames"]:
    name = frame["file_path"] + ("" if opencv else ".png")
    with open(os.path.join(data_dir, name), "rb") as f:
      img = np.array(Image.open(f), dtype=np.float32) / 255.0
    if cfg["flags"]["factor"] == 2:
      h, w = img.shape[:2]
      img = img.reshape(h // 2, 2, w // 2, 2, -1).mean(axis=(1, 3),
                                                      dtype=np.float32)
    images.append(img[..., :3])
    c2w.append(np.array(frame["transform_matrix"], dtype=np.float32))
  images, c2w = np.stack(images), np.stack(c2w)
  h, w = images.shape[1:3]
  if opencv:
    o, d = opencv_rays(w, h, meta["cam_mat"], c2w)
  else:
    focal = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
    o, d = pinhole_rays(w, h, focal, c2w)
  return o, d, images


class Batches:
  """The training batches of a capture's train split, in draw order."""

  def __init__(self, cfg, data_dir, seed, jitter_seed):
    f = cfg["flags"]
    self.o, self.d, self.pix = load_split(cfg, data_dir, "train")
    self.n, self.h, self.w = self.pix.shape[:3]
    self.tile, self.patch = f["tile_size"], f["bg_patch_size"]
    self.tiles = f["batch_size"] // self.tile**2
    self.nc, self.np_ = f["num_coarse_samples"], f["num_path_samples"]
    self.rng = np.random.RandomState(seed)
    self.jitter_gen = torch.Generator().manual_seed(jitter_seed)

  def next(self, device):
    rng, t = self.rng, self.tile
    img = rng.randint(0, self.n, ())
    ys, xs = [], []
    for _ in range(self.tiles):
      x = rng.randint(0, self.w - t + 1)
      y = rng.randint(0, self.h - t + 1)
      yy, xx = np.mgrid[y:y + t, x:x + t]
      ys.append(yy.reshape(-1))
      xs.append(xx.reshape(-1))
    ys, xs = np.concatenate(ys), np.concatenate(xs)
    env_img = rng.randint(0, self.n, ())
    x = rng.randint(low=0, high=self.w - self.patch)
    y = rng.randint(low=0, high=self.h - self.patch)
    env = self.d[env_img, y:y + self.patch, x:x + self.patch]
    off = torch.randint(0, self.np_, (self.nc,), generator=self.jitter_gen)
    jitter = torch.arange(0, self.nc * self.np_, self.np_) + off
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return {"origins": to(self.o[img, ys, xs]),
            "viewdirs": to(self.d[img, ys, xs]),
            "pixels": to(self.pix[img, ys, xs]), "env_viewdirs": to(env),
            "jitter": jitter.to(device)}
