"""Blender test-split loader: transforms_test.json + images -> rays, pixels.

Counterpart of the test split of samplenerfro_tpu/data/datasets.py:258-283
(Blender._load_renderings with _generate_rays). The training split, its
batching and the other dataset formats are not ported yet.
"""

import json
import os

import numpy as np

from samplenerfro_torch.data import rays as rays_lib


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


def load_blender_test(data_dir, factor, use_pixel_centers, white_bkgd,
                      skip_frames=1):
  """Load the Blender test split.

  Returns:
    (rays, images): Rays of [n, h, w, C] float32 numpy fields and
    [n, h, w, 3] float32 pixels (alpha composited on white when
    white_bkgd).
  """
  with open(os.path.join(data_dir, "transforms_test.json")) as fp:
    meta = json.load(fp)
  images, cams = [], []
  for i in range(0, len(meta["frames"]), skip_frames):
    frame = meta["frames"][i]
    image = _load_image(os.path.join(data_dir, frame["file_path"] + ".png"))
    images.append(_downsample(image, factor))
    cams.append(np.array(frame["transform_matrix"], dtype=np.float32))
  images = np.stack(images, axis=0)
  if white_bkgd:
    images = images[..., :3] * images[..., -1:] + (1.0 - images[..., -1:])
  else:
    images = images[..., :3]
  h, w = images.shape[1:3]
  focal = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
  rays = rays_lib.generate_pinhole_rays(w, h, focal, np.stack(cams, axis=0),
                                        use_pixel_centers)
  return rays, images
