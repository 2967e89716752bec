"""Chunked full-image rendering.

Counterpart of samplenerfro_tpu/utils/render.py:20-218 on one device.
Pixels are permuted into 16x16 tiles before chunking, so neighbouring
threads of the march kernel march neighbouring rays and share cache lines;
the outputs are un-permuted. The march reads the whole grid, so no chunk
is ever clamped and there is no repair pass.

Under W ranks (parallel/mesh.py) each chunk is padded to a multiple of W
with its last ray, each rank renders its rows of it, and the rows are
gathered and the padding cut (samplenerfro_tpu/utils/render.py:104-117):
every rank returns the whole image.
"""

import numpy as np
import torch

from samplenerfro_torch.data.rays import namedtuple_map
from samplenerfro_torch.parallel import mesh

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
                 tile=TILE, chunks_per_dispatch=1):
  """Render all pixels of an image in chunks.

  Args:
    render_fn: (Rays of [n, C] tensors on `device`) -> final-level tuple
      (rgb [n, 3], distance [n], acc [n], ...).
    rays: Rays with [height, width, C] numpy fields.
    normalize_disp: normalize distance to [0, 1] (LLFF).
    chunk: rays per render_fn call.
    device: where the chunks are rendered.
    tile: pixel-tile side of the render order; 0 keeps raster order.
    chunks_per_dispatch: chunks whose rays go to `device` in one copy
      (--render_chunks_per_dispatch; samplenerfro_tpu/utils/render.py's
      groups). Each chunk renders on its own, in order, at its own size
      (a ragged last chunk too, where the JAX package pads it), so the
      image is bit for bit the same whatever the grouping.

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

  group = chunk * max(1, int(chunks_per_dispatch))
  rgb, distance, acc = _render_chunks(render_fn, rays, chunk, group, device)
  if inv_perm is not None:
    rgb, distance, acc = rgb[inv_perm], distance[inv_perm], acc[inv_perm]
  if normalize_disp:
    distance = (distance - distance.min()) / (distance.max() - distance.min())
  return (rgb.reshape(height, width, -1), distance.reshape(height, width, -1),
          acc.reshape(height, width, -1))


def _render_chunks(render_fn, rays, chunk, group, device):
  """render_image's chunks of `rays` ([n, C] host fields), each padded to
  a multiple of W with its last ray (no padding at W = 1), this rank's
  rows of each rendered on its own (a group's rows copied to `device` in
  one copy), all of them gathered in one collective, the padding cut.
  Returns (rgb [n, 3], distance [n], acc [n]) numpy arrays."""
  w = mesh.world()
  num_rays = rays[0].shape[0]
  sizes, local = [], []
  with torch.no_grad():
    for g in range(0, num_rays, group):
      parts, counts = [], []
      for i in range(g, min(g + group, num_rays), chunk):
        c = min(chunk, num_rays - i)
        pad = -c % w
        lo, hi = mesh.local_rows(c + pad)
        parts.append(namedtuple_map(
            lambda r: np.pad(r[i:i + c], ((0, pad), (0, 0)),
                             mode="edge")[lo:hi], rays))
        counts.append(hi - lo)
        sizes.append((hi - lo, c))
      group_rays = type(parts[0])(*[
          torch.from_numpy(np.concatenate(cols)).to(device, non_blocking=True)
          for cols in zip(*parts)])
      start = 0
      for m in counts:
        out = render_fn(namedtuple_map(lambda r: r[start:start + m],
                                       group_rays))
        local.append(torch.cat([out[0], out[1][:, None], out[2][:, None]],
                               dim=-1))
        start += m
  rows = mesh.gather_rows(torch.cat(local)).cpu()
  rows = rows.reshape(w, -1, rows.shape[-1])
  full, start = [], 0
  for m, c in sizes:
    full.append(rows[:, start:start + m].reshape(w * m, -1)[:c])
    start += m
  full = torch.cat(full).numpy()
  return tuple(np.ascontiguousarray(full[:, sl])
               for sl in (np.s_[:3], 3, 4))
