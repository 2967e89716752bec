"""Scene loaders, the training batches, and the boundary-point batches.

Counterpart of samplenerfro_tpu/data/datasets.py: the Blender format
(:112-283), NSVF (:284-311), OpenCV, the calibrated real scenes
(:312-357), and LLFF forward-facing captures with NDC rays and their
render paths (:360-469) -> rays and pixels; the test split's central crop
of OpenCV views (`eval_view`); the training split's `all_images`,
`single_image` (with precrop) and `tile` batching with the
`bg_patch_size` env-ray patch, the JAX base class's for every format; and
`Grid` (:471-513), the boundary points of the IOR grid with their
gradient targets that the `ior` stage trains on and the sparsity and
normal terms read. Batches are drawn on the host from an explicit
np.random.RandomState, with the same calls in the same order as the JAX
loaders draw them from numpy's global state, and are built synchronously
(data/prefetch.py runs them on its thread). The JAX train loop draws its
Grid batches from the same global state as its image batches, on a second
thread; the port gives the Grid a RandomState of its own, so the image
batches stay bit for bit the JAX loader's whether a Grid is drawn or not.
"""

import glob
import json
import os

import numpy as np

from samplenerfro_torch.data import pose_paths
from samplenerfro_torch.data import rays as rays_lib
from samplenerfro_torch.data.rays import Rays
from samplenerfro_torch.data.rays import namedtuple_map
from samplenerfro_torch.ops import grid as grid_ops
from samplenerfro_torch.parallel import mesh


# Every scene format of samplenerfro_tpu/data/datasets.py:519 (dataset_dict).
PORTED = ("blender", "llff", "nsvf", "opencv")


def check_dataset(args):
  """Raise ValueError unless args.dataset is a known scene format, and for
  --render_path on a format without a render path; the entry points call
  it before they read any scene file."""
  name = getattr(args, "dataset", "blender")
  if name not in PORTED:
    raise ValueError(f"unknown dataset {name!r}: the scene formats are "
                     f"{', '.join(PORTED)}")
  if getattr(args, "render_path", False) and name != "llff":
    # The JAX loaders' message (datasets.py:262,289,316).
    raise ValueError(f"render_path cannot be used for the {name} dataset.")


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


def load_nsvf(data_dir, split, factor, use_pixel_centers, white_bkgd):
  """Load one split of an NSVF scene: intrinsics.txt's focal length,
  rgb/<k>_*.png and pose/<k>_*.txt with k 0, 1, 2 for train, val, test,
  the poses' y and z axes flipped (samplenerfro_tpu/data/datasets.py:
  287-311).

  Returns:
    (rays, images) as load_blender's.
  """
  prefix = {"train": 0, "val": 1, "test": 2}[split]
  with open(os.path.join(data_dir, "intrinsics.txt")) as fp:
    f = float(fp.readline().split()[0])
  imgfiles = sorted(glob.glob(os.path.join(data_dir, "rgb", f"{prefix}_*.png")))
  camfiles = sorted(glob.glob(os.path.join(data_dir, "pose",
                                           f"{prefix}_*.txt")))
  images, cams = [], []
  for imgfile, camfile in zip(imgfiles, camfiles):
    images.append(_downsample(_load_image(imgfile), factor))
    cam = np.loadtxt(camfile, dtype=np.float32)
    cam[:3, 1:3] *= -1
    cams.append(cam)
  images = _composite_white(np.stack(images, axis=0), white_bkgd)
  h, w = images.shape[1:3]
  focal = f * (0.5 if factor == 2 else 1.0)
  rays = rays_lib.generate_pinhole_rays(w, h, focal, np.stack(cams, axis=0),
                                        use_pixel_centers)
  return rays, images


def _ndc_rays(rays, focal, w, h):
  """LLFF's NDC rays: origins and directions projected, radii from the
  mean spacing of neighbouring NDC origins, viewdirs the world directions
  (samplenerfro_tpu/data/datasets.py:447-462)."""
  ndc_origins, ndc_directions = rays_lib.convert_to_ndc(
      rays.origins, rays.directions, focal, w, h)
  mat = ndc_origins
  dx = np.sqrt(np.sum((mat[:, :-1, :, :] - mat[:, 1:, :, :])**2, -1))
  dx = np.concatenate([dx, dx[:, -2:-1, :]], 1)
  dy = np.sqrt(np.sum((mat[:, :, :-1, :] - mat[:, :, 1:, :])**2, -1))
  dy = np.concatenate([dy, dy[:, :, -2:-1]], 2)
  radii = (0.5 * (dx + dy))[..., None] * 2 / np.sqrt(12)
  return Rays(origins=ndc_origins, directions=ndc_directions,
              viewdirs=rays.directions, radii=radii)


def load_llff(data_dir, split, factor, spherify, llffhold, use_pixel_centers):
  """Load one split of an LLFF capture (samplenerfro_tpu/data/datasets.py:
  360-469): images<_factor>/*.jpg and poses_bounds.npy, poses scaled so the
  nearest bound is 4/3 and recentred; a capture of 200 or more images
  splits by index (100-199 train, 0-99 test), a smaller one holds out
  every llffhold-th view for the test split. Rays are NDC rays unless
  `spherify`.

  Returns:
    (rays, images, render_rays): Rays of [n, h, w, C] float32 fields, [n,
    h, w, 3] float32 pixels, and on the test split the Rays of the render
    path (the 120-frame spiral, or the orbit when `spherify`), else None.
  """
  suffix = f"_{factor}" if factor > 0 else ""
  factor = factor if factor > 0 else 1
  imgdir = os.path.join(data_dir, "images" + suffix)
  if not os.path.exists(imgdir):
    raise ValueError(f"Image folder {imgdir} doesn't exist.")
  imgfiles = [os.path.join(imgdir, f) for f in sorted(os.listdir(imgdir))
              if f.endswith("JPG") or f.endswith("jpg")]
  images = np.stack([_load_image(f) for f in imgfiles], axis=-1)

  with open(os.path.join(data_dir, "poses_bounds.npy"), "rb") as fp:
    poses_arr = np.load(fp)
  poses = poses_arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
  bds = poses_arr[:, -2:].transpose([1, 0])
  if poses.shape[-1] != images.shape[-1]:
    raise RuntimeError(f"Mismatch between imgs {images.shape[-1]} and poses "
                       f"{poses.shape[-1]}")
  poses[:2, 4, :] = np.array(images.shape[:2]).reshape([2, 1])
  poses[2, 4, :] = poses[2, 4, :] * 1.0 / factor
  poses = np.concatenate(
      [poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1)
  poses = np.moveaxis(poses, -1, 0).astype(np.float32)
  images = np.moveaxis(images, -1, 0)
  bds = np.moveaxis(bds, -1, 0).astype(np.float32)

  scale = 1.0 / (bds.min() * 0.75)
  poses[:, :3, 3] *= scale
  bds *= scale
  poses = pose_paths.recenter_poses(poses)
  render_poses = None
  if spherify:
    poses, render_poses, bds = pose_paths.spherify_poses(poses, bds)
  elif split == "test":
    render_poses = pose_paths.spiral_path(poses, bds)

  if images.shape[0] >= 200:
    indices = np.arange(100, 200) if split == "train" else np.arange(0, 100)
  else:
    i_test = np.arange(images.shape[0])[::llffhold]
    indices = (np.array([i for i in np.arange(images.shape[0])
                         if i not in i_test])
               if split == "train" else i_test)
  images = images[indices]
  poses = poses[indices]
  camtoworlds = poses[:, :3, :4]
  focal = poses[0, -1, -1]
  h, w = images.shape[1:3]

  n_path = 0
  if split == "test":
    n_path = render_poses.shape[0]
    camtoworlds = np.concatenate([render_poses, camtoworlds], axis=0)
  rays = rays_lib.generate_pinhole_rays(w, h, focal, camtoworlds,
                                        use_pixel_centers)
  if not spherify:
    rays = _ndc_rays(rays, focal, w, h)
  if split != "test":
    return rays, images, None
  path_rays, view_rays = zip(*[np.split(r, [n_path], 0) for r in rays])
  return Rays(*view_rays), images, Rays(*path_rays)


def load_split(args, split):
  """(rays, images) of a split of args.data_dir in args.dataset's format;
  --eval_train reads the train split instead (Blender and OpenCV, as the
  JAX loaders honour it)."""
  check_dataset(args)
  if args.dataset == "opencv":
    if args.factor > 0:
      raise ValueError(
          f"Opencv dataset does not support factor, {args.factor} set.")
    rays, images, _ = load_opencv(args.data_dir, split,
                                  args.use_pixel_centers, args.white_bkgd,
                                  args.skip_frames, args.eval_train)
    return rays, images
  if args.dataset == "llff":
    rays, images, _ = load_llff(args.data_dir, split, args.factor,
                                args.spherify, args.llffhold,
                                args.use_pixel_centers)
    return rays, images
  if args.dataset == "nsvf":
    return load_nsvf(args.data_dir, split, args.factor,
                     args.use_pixel_centers, args.white_bkgd)
  return load_blender(args.data_dir, "train" if args.eval_train else split,
                      args.factor, args.use_pixel_centers, args.white_bkgd,
                      args.skip_frames)


def load_render_path(args):
  """Rays [frames, h, w, C] of the test split's render path, what eval
  renders under --render_path: LLFF's spiral (or orbit, with --spherify);
  every other format raises ValueError (check_dataset)."""
  check_dataset(args)
  _, _, path_rays = load_llff(args.data_dir, "test", args.factor,
                              args.spherify, args.llffhold,
                              args.use_pixel_centers)
  return path_rays


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
  scene (load_split's train split).

  Each batch holds this rank's `batch_size` // W rays with their
  [batch, 3] pixels (samplenerfro_tpu/data/datasets.py:84; ValueError
  unless W divides batch_size), and, when `bg_patch_size` > 0, a [p, p]
  patch of rays of one training image for the background smoothness loss
  (env_rays; None otherwise), which train/loop.py replaces with rank 0's.
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
    self.batch_size = mesh.per_rank(args.batch_size, "batch_size")
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


class Grid:
  """Iterator of boundary-point batches {"pts", "grads"} of an IOR grid
  (samplenerfro_tpu/data/datasets.py:471-513).

  The candidates are the voxels whose central-difference gradient is
  longer than 1e-3; a batch takes `extra_batch_size` // W of them
  (datasets.py:493; ValueError unless W divides it) with
  replacement, jitters each uniformly within a voxel's extent and
  interpolates the gradient grid there (ops/grid.trilinear_numpy): pts
  and grads [batch, 1, 3] float32. The grid is [N^3, 1] IOR values on the
  host (the model's grid: train/loop.py builds it from the path sampler's
  buffer). `train_it` counts the batches drawn, as the image batches'
  does; a resume sets it (train.py:155-158) and nothing else reads it.
  """

  def __init__(self, args, grid, ndim, nmax, nmin, rng):
    self.spec = grid_ops.GridSpec(ndim, nmin, nmax)
    self.ndim, self.nmax, self.nmin = ndim, nmax, nmin
    self.ndelta = self.spec.ndelta
    grad = grid_ops.central_difference_grad_numpy(self.spec, grid)
    self.candidate_indices = np.stack(
        np.where(np.linalg.norm(grad.reshape(*ndim, 3), axis=-1) > 1e-3),
        axis=-1)
    self.grid = grad
    self.extra_batch_size = mesh.per_rank(args.extra_batch_size,
                                          "extra_batch_size")
    self.rng = rng
    self.train_it = 0

  def __iter__(self):
    return self

  def __next__(self):
    return self._next_train()

  def _next_train(self):
    batch_indices = self.rng.choice(self.candidate_indices.shape[0],
                                    self.extra_batch_size)
    batch_pts = (self.candidate_indices[batch_indices]
                 / np.array(self.ndim)[None])
    batch_pts = (batch_pts * (np.array(self.nmax)[None]
                              - np.array(self.nmin)[None])
                 + np.array(self.nmin)[None])
    batch_pts += (self.rng.uniform(low=-1.0, high=1.0, size=batch_pts.shape)
                  * np.array(self.ndelta)[None])
    batch_grads = grid_ops.trilinear_numpy(self.spec, self.grid, batch_pts)
    self.train_it += 1
    return {"pts": batch_pts[:, None].astype(np.float32),
            "grads": batch_grads[:, None].astype(np.float32)}
