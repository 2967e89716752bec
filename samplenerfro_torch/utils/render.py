"""Chunked full-image rendering.

Counterpart of samplenerfro_tpu/utils/render.py:20-218 on one device.
Pixels are permuted into 16x16 tiles before chunking, so neighbouring
threads of the march kernel march neighbouring rays and share cache lines;
the outputs are un-permuted. The march reads the whole grid, so no chunk
is ever clamped and there is no repair pass.
"""

import numpy as np
import torch

from samplenerfro_torch.data.rays import namedtuple_map

TILE = 16


def tile_order(height, width, tile):
  """Pixel permutation grouping the image into row-major tile x tile blocks.

  Returns (perm, inv_perm) with flat_pixels[perm] tile-contiguous and
  x[inv_perm] undoing it; partial edge tiles come last
  (samplenerfro_tpu/ops/eikonal_tiled.py:tile_order).
  """
  idx = np.arange(height * width).reshape(height, width)
  full, partial = [], []
  for ty in range(0, height, tile):
    for tx in range(0, width, tile):
      blk = idx[ty:ty + tile, tx:tx + tile].reshape(-1)
      (full if blk.size == tile * tile else partial).append(blk)
  perm = np.concatenate(full + partial)
  inv = np.empty_like(perm)
  inv[perm] = np.arange(perm.size)
  return perm, inv


def render_image(render_fn, rays, normalize_disp, chunk=8192, device=None,
                 tile=TILE):
  """Render all pixels of an image in chunks.

  Args:
    render_fn: (Rays of [n, C] tensors on `device`) -> final-level tuple
      (rgb [n, 3], distance [n], acc [n], ...).
    rays: Rays with [height, width, C] numpy fields.
    normalize_disp: normalize distance to [0, 1] (LLFF).
    chunk: rays per render_fn call.
    device: where the chunks are rendered.
    tile: pixel-tile side of the render order; 0 keeps raster order.

  Returns:
    (rgb [h, w, 3], distance [h, w, 1], acc [h, w, 1]) numpy arrays.
  """
  height, width = rays[0].shape[:2]
  num_rays = height * width
  rays = namedtuple_map(lambda r: np.asarray(r).reshape(num_rays, -1), rays)
  inv_perm = None
  if tile > 0:
    perm, inv_perm = tile_order(height, width, tile)
    rays = namedtuple_map(lambda r: r[perm], rays)

  results = []
  with torch.no_grad():
    for i in range(0, num_rays, chunk):
      chunk_rays = namedtuple_map(
          lambda r: torch.from_numpy(np.ascontiguousarray(r[i:i + chunk])).to(
              device, non_blocking=True), rays)
      out = render_fn(chunk_rays)
      results.append((out[0], out[1], out[2]))
  rgb, distance, acc = [torch.cat(r, dim=0).cpu().numpy()
                        for r in zip(*results)]
  if inv_perm is not None:
    rgb, distance, acc = rgb[inv_perm], distance[inv_perm], acc[inv_perm]
  if normalize_disp:
    distance = (distance - distance.min()) / (distance.max() - distance.min())
  return (rgb.reshape(height, width, -1), distance.reshape(height, width, -1),
          acc.reshape(height, width, -1))
