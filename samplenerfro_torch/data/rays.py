"""Ray containers and host-side pinhole camera ray generation.

Copy of samplenerfro_tpu/data/rays.py (Rays, namedtuple_map,
generate_pinhole_rays): numpy on the host, moved to the device per chunk.
"""

import collections

import numpy as np

Rays = collections.namedtuple("Rays",
                              ("origins", "directions", "viewdirs", "radii"))


def namedtuple_map(fn, tup):
  """Apply fn to each field, preserving the namedtuple type."""
  return type(tup)(*map(fn, tup))


def _finalize_rays(directions, camtoworlds):
  """World-space dirs -> origins/viewdirs/mip radii."""
  world_dirs = ((directions[None, ..., None, :]
                 * camtoworlds[:, None, None, :3, :3]).sum(axis=-1))
  origins = np.broadcast_to(camtoworlds[:, None, None, :3, -1],
                            world_dirs.shape)
  viewdirs = world_dirs / np.linalg.norm(world_dirs, axis=-1, keepdims=True)

  # Per-ray cone base radius from the x-neighbour direction spacing.
  dx = np.sqrt(
      np.sum((world_dirs[:, :-1, :, :] - world_dirs[:, 1:, :, :])**2, -1))
  dx = np.concatenate([dx, dx[:, -2:-1, :]], 1)
  radii = dx[..., None] * 2 / np.sqrt(12)

  return Rays(origins=origins.astype(np.float32),
              directions=world_dirs.astype(np.float32),
              viewdirs=viewdirs.astype(np.float32),
              radii=radii.astype(np.float32))


def generate_pinhole_rays(w, h, focal, camtoworlds, use_pixel_centers):
  """Blender/NeRF convention: x right, y up, camera looks down -z.

  Returns Rays with [num_images, h, w, C] fields.
  """
  pixel_center = 0.5 if use_pixel_centers else 0.0
  x, y = np.meshgrid(
      np.arange(w, dtype=np.float32) + pixel_center,
      np.arange(h, dtype=np.float32) + pixel_center,
      indexing="xy")
  camera_dirs = np.stack(
      [(x - w * 0.5) / focal, -(y - h * 0.5) / focal, -np.ones_like(x)],
      axis=-1)
  return _finalize_rays(camera_dirs, camtoworlds)
