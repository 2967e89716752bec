"""Blender and OpenCV scenes: the val/test splits and the training batches.

Counterpart of samplenerfro_tpu/data/datasets.py:112-283 (the Blender
format) and :312-357 (OpenCV, the calibrated real scenes): transforms_
<split>.json + images -> rays and pixels; the test split's central crop of
OpenCV views (`eval_view`); and the training split's `all_images`,
`single_image` (with precrop) and `tile` batching with the `bg_patch_size`
env-ray patch, the JAX base class's for both formats. Batches are drawn on
the host from an explicit np.random.RandomState, with the same calls in
the same order as the JAX loader draws them from numpy's global state, and
are built synchronously (the JAX loader's prefetch thread is not ported).
The LLFF, NSVF and Grid formats are not ported yet.
"""

import json
import os

import numpy as np

from samplenerfro_torch.data import rays as rays_lib
from samplenerfro_torch.data.rays import namedtuple_map


# The dataset formats the port loads; samplenerfro_tpu/data/datasets.py:519
# (dataset_dict) has llff, nsvf and grid besides, which wait.
PORTED = ("blender", "opencv")


def check_dataset(args):
  """Raise NotImplementedError unless args.dataset is a ported format; the
  entry points call it before they read any scene file."""
  name = getattr(args, "dataset", "blender")
  if name not in PORTED:
    raise NotImplementedError(
        f"dataset {name!r} is not ported yet: samplenerfro_torch loads "
        f"{', '.join(PORTED)} scenes only")


def _load_image(fname):
  from PIL import Image
  with open(fname, "rb") as f:
    return np.array(Image.open(f), dtype=np.float32) / 255.0


def _downsample(image, factor):
  """factor 2: mean of each 2x2 block (what cv2.INTER_AREA computes for
  even sizes); factor 0: unchanged."""
  if factor == 0:
    return image
  if factor != 2:
    raise ValueError(f"dataset only supports factor=0 or 2, {factor} set.")
  h, w = image.shape[:2]
  if h % 2 or w % 2:
    raise ValueError(f"factor=2 needs even image sizes, got {h}x{w}")
  blocks = image.reshape(h // 2, 2, w // 2, 2, *image.shape[2:])
  return blocks.mean(axis=(1, 3), dtype=np.float32)


def _composite_white(images, white_bkgd):
  if white_bkgd:
    return images[..., :3] * images[..., -1:] + (1.0 - images[..., -1:])
  return images[..., :3]


def load_blender(data_dir, split, factor, use_pixel_centers, white_bkgd,
                 skip_frames=1):
  """Load one split of a Blender scene.

  Returns:
    (rays, images): Rays of [n, h, w, C] float32 numpy fields and
    [n, h, w, 3] float32 pixels (alpha composited on white when
    white_bkgd).
  """
  with open(os.path.join(data_dir, f"transforms_{split}.json")) as fp:
    meta = json.load(fp)
  images, cams = [], []
  for i in range(0, len(meta["frames"]), skip_frames):
    frame = meta["frames"][i]
    image = _load_image(os.path.join(data_dir, frame["file_path"] + ".png"))
    images.append(_downsample(image, factor))
    cams.append(np.array(frame["transform_matrix"], dtype=np.float32))
  images = _composite_white(np.stack(images, axis=0), white_bkgd)
  h, w = images.shape[1:3]
  focal = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
  rays = rays_lib.generate_pinhole_rays(w, h, focal, np.stack(cams, axis=0),
                                        use_pixel_centers)
  return rays, images


def load_opencv(data_dir, split, use_pixel_centers, white_bkgd,
                skip_frames=1, eval_train=False):
  """Load one split of an OpenCV (calibrated real) scene.

  Frames name their image file with its extension; the intrinsics are the
  meta's `cam_mat`, and the camera looks down +z. eval_train reads the
  train split whatever `split` says, as samplenerfro_tpu/data/
  datasets.py:318 does.

  Returns:
    (rays, images, cam_mat): Rays of [n, h, w, C] float32 numpy fields,
    [n, h, w, 3] float32 pixels and the 3x3 intrinsics as the json holds
    them.
  """
  if eval_train:
    split = "train"
  with open(os.path.join(data_dir, f"transforms_{split}.json")) as fp:
    meta = json.load(fp)
  images, cams = [], []
  for i in range(0, len(meta["frames"]), skip_frames):
    frame = meta["frames"][i]
    images.append(_load_image(os.path.join(data_dir, frame["file_path"])))
    cams.append(np.array(frame["transform_matrix"], dtype=np.float32))
  images = _composite_white(np.stack(images, axis=0), white_bkgd)
  h, w = images.shape[1:3]
  cam_mat = meta["cam_mat"]
  rays = rays_lib.generate_opencv_rays(w, h, cam_mat, np.stack(cams, axis=0),
                                       use_pixel_centers)
  return rays, images, cam_mat


def load_split(args, split):
  """(rays, images) of a split of args.data_dir in args.dataset's format;
  --eval_train reads the train split instead."""
  check_dataset(args)
  if args.dataset == "opencv":
    if args.factor > 0:
      raise ValueError(
          f"Opencv dataset does not support factor, {args.factor} set.")
    rays, images, _ = load_opencv(args.data_dir, split,
                                  args.use_pixel_centers, args.white_bkgd,
                                  args.skip_frames, args.eval_train)
    return rays, images
  return load_blender(args.data_dir, "train" if args.eval_train else split,
                      args.factor, args.use_pixel_centers, args.white_bkgd,
                      args.skip_frames)


def central_crop(h, w, precrop_iters, precrop_frac):
  """The slice of an OpenCV test view that is rendered and scored
  (samplenerfro_tpu/data/datasets.py:338-353): the precrop window when
  precrop_iters > 0, else h//2 - h//2 : h//2 + h//2 (and so for w), which
  drops the last row (column) of an odd-sized view."""
  if precrop_iters > 0:
    dh = int(h // 2 * precrop_frac)
    dw = int(w // 2 * precrop_frac)
  else:
    dh, dw = h // 2, w // 2
  return np.s_[(h // 2 - dh):(h // 2 + dh), (w // 2 - dw):(w // 2 + dw)]


def eval_view(args, rays, images, idx):
  """(rays [h', w', C], pixels [h', w', 3]) of view idx of a val or test
  split: OpenCV views centrally cropped, Blender views whole."""
  sl = np.s_[:, :]
  if args.dataset == "opencv":
    sl = central_crop(images.shape[1], images.shape[2], args.precrop_iters,
                      args.precrop_frac)
  return namedtuple_map(lambda r: r[idx][sl], rays), images[idx][sl]


class TrainBatches:
  """Iterator of training batches {"pixels", "rays", "env_rays"} of a
  Blender or OpenCV scene (load_split's train split).

  Each batch holds `batch_size` rays with their [batch, 3] pixels, and,
  when `bg_patch_size` > 0, a [p, p] patch of rays of one training image
  for the background smoothness loss (env_rays; None otherwise).
  `train_it` counts the batches drawn; precrop applies while it is below
  `precrop_iters`, and a resumed run sets it to the steps already taken.
  """

  def __init__(self, args, rng):
    rays, images = load_split(args, "train")
    self.n_examples, self.h, self.w = images.shape[:3]
    res = self.h * self.w
    self.images = images.reshape(self.n_examples, res, 3)
    self.rays = namedtuple_map(
        lambda r: r.reshape(self.n_examples, res, r.shape[-1]), rays)
    if args.batching not in ("all_images", "single_image", "tile"):
      raise NotImplementedError(
          f"{args.batching} batching strategy is not implemented.")
    self.batching = args.batching
    self.batch_size = args.batch_size
    self.precrop_iters = args.precrop_iters
    self.precrop_frac = args.precrop_frac
    self.patch_size = args.bg_patch_size
    self.tile_size = int(args.tile_size)
    self.tile_stride = int(args.tile_stride)
    self.tile_images = bool(args.tile_images)
    self.rng = rng
    self.train_it = 0

  def __iter__(self):
    return self

  def _coords(self, precrop):
    coords = np.arange(self.h * self.w).reshape(self.h, self.w)
    if not precrop:
      return coords
    dh = int(self.h // 2 * self.precrop_frac)
    dw = int(self.w // 2 * self.precrop_frac)
    return coords[(self.h // 2 - dh):(self.h // 2 + dh),
                  (self.w // 2 - dw):(self.w // 2 + dw)]

  def _env_rays(self, coords):
    """The env-ray patch (samplenerfro_tpu/data/datasets.py:159-177)."""
    image_index = self.rng.randint(0, self.n_examples, ())
    ph, pw = coords.shape
    x = self.rng.randint(low=0, high=pw - self.patch_size)
    y = self.rng.randint(low=0, high=ph - self.patch_size)
    idx = coords[y:(y + self.patch_size), x:(x + self.patch_size)]
    return namedtuple_map(lambda r: r[image_index][idx], self.rays)

  def __next__(self):
    precrop = self.train_it < self.precrop_iters
    if self.batching == "tile":
      pixels, rays = self._tile_batch()
      env_coords = self._coords(False)
    elif self.batching == "all_images":
      idx = self.rng.choice(self.n_examples * self.h * self.w,
                            (self.batch_size,), replace=False)
      pixels = self.images.reshape(-1, 3)[idx]
      rays = namedtuple_map(lambda r: r.reshape(-1, r.shape[-1])[idx],
                            self.rays)
      env_coords = self._coords(precrop)
    else:  # single_image
      image_index = self.rng.randint(0, self.n_examples, ())
      idx = self.rng.choice(self._coords(precrop).reshape(-1),
                            (self.batch_size,), replace=False)
      pixels = self.images[image_index][idx]
      rays = namedtuple_map(lambda r: r[image_index][idx], self.rays)
      env_coords = self._coords(precrop)
    env_rays = self._env_rays(env_coords) if self.patch_size > 0 else None
    self.train_it += 1
    return {"pixels": pixels, "rays": rays, "env_rays": env_rays}

  def _tile_batch(self):
    """Random pixel tiles (samplenerfro_tpu/data/datasets.py:183-243)."""
    tile, stride = self.tile_size, self.tile_stride
    n_tiles = self.batch_size // (tile * tile)
    if n_tiles * tile * tile != self.batch_size:
      raise ValueError("batch_size must be a multiple of tile_size^2 for "
                       "tile batching")
    span = (tile - 1) * stride + 1
    if span > self.h or span > self.w:
      raise ValueError(f"tile_size {tile} at stride {stride} exceeds the "
                       f"{self.h}x{self.w} image")
    image_index = self.rng.randint(0, self.n_examples, ())
    coords = self._coords(False)
    idx_list, img_list = [], []
    for _ in range(n_tiles):
      x = self.rng.randint(0, self.w - span + 1)
      y = self.rng.randint(0, self.h - span + 1)
      idx_list.append(coords[y:y + span:stride, x:x + span:stride]
                      .reshape(-1))
      img_list.append(self.rng.randint(0, self.n_examples, ())
                      if self.tile_images else image_index)
    pixels = np.concatenate(
        [self.images[im][idx] for im, idx in zip(img_list, idx_list)])
    rays = namedtuple_map(
        lambda r: np.concatenate(
            [r[im][idx] for im, idx in zip(img_list, idx_list)]), self.rays)
    return pixels, rays
