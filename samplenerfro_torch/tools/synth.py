"""A synthetic refractive scene with exact eikonal ground truth.

The port's counterpart of samplenerfro_tpu/tools/synth.py: a Blender-format
dataset of a transparent Gaussian IOR blob in front of an analytic
emissive environment. Each ground-truth pixel marches the model's own
eikonal ODE through the known grid (ops/march_kernel.march_full_plain: K2
with the so3 head off on the card, its plain version ops/eikonal.march on
CPU tensors) and shades the last vertex's direction with the envmap. The
model family contains the scene exactly (zero density, the background MLP,
the given grid), so a trainer that works reaches a high PSNR on it with no
outside data (tools/validate_quality.py).

Writes imgs/r_<i>.png, transforms_{train,val,test}.json and
voxelize/mesh.pkl (voxelize_mesh's schema), the poses drawn from
np.random.RandomState(seed) as the JAX tool draws them.
"""

import json
import os
import pickle

import numpy as np
import torch

from samplenerfro_torch import resolve_device
from samplenerfro_torch.data import rays as rays_lib
from samplenerfro_torch.ops import grid as grid_ops
from samplenerfro_torch.ops import march_kernel
from samplenerfro_torch.ops import math as math_ops
from samplenerfro_torch.utils import grid_io

GT_CHUNK = 8192  # rays a ground-truth march


def envmap(dirs):
  """Smooth analytic emissive environment: unit dirs -> rgb in [0, 1]."""
  x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
  r = 0.5 + 0.35 * torch.sin(3.0 * x + 1.0) * torch.cos(2.0 * y)
  g = 0.5 + 0.35 * torch.sin(2.0 * y + 2.0) * torch.cos(3.0 * z)
  b = 0.5 + 0.35 * torch.sin(4.0 * z + 0.5) * torch.cos(2.0 * x)
  return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 1.0)


def blob_ior_grid(grid_n=64, extent=1.5, peak=0.33, sigma2=0.25):
  """[grid_n^3, 1] float32 Gaussian IOR blob on mesh.pkl's lattice."""
  return grid_io.synthetic_blob_grid(grid_n, extent, peak, sigma2)[0]


def render_gt(spec, grid_values, origins, viewdirs, near, far, num_samples,
              device=None):
  """March the exact eikonal paths on `device`, GT_CHUNK rays a march,
  and shade the exit directions with the envmap; [..., 3] numpy origins
  and directions -> [..., 3] float32 rgb."""
  values = torch.from_numpy(np.asarray(grid_values, np.float32)).to(device)
  data = torch.cat([values, grid_ops.central_difference_grad(spec, values)],
                   dim=-1).contiguous()
  h = (far - near) / (num_samples - 1)
  flat_o = torch.from_numpy(np.ascontiguousarray(
      origins.reshape(-1, 3), np.float32)).to(device)
  flat_d = torch.from_numpy(np.ascontiguousarray(
      viewdirs.reshape(-1, 3), np.float32)).to(device)
  out = []
  with torch.no_grad():
    for i in range(0, flat_o.shape[0], GT_CHUNK):
      traj = march_kernel.march_full_plain(
          spec, data, flat_o[i:i + GT_CHUNK], flat_d[i:i + GT_CHUNK], near,
          h, num_samples)
      out.append(envmap(math_ops.safe_l2_normalize(traj[:, -1, 3:6])))
  return torch.cat(out, 0).cpu().numpy().reshape(origins.shape)


def look_at_pose(rng, radius):
  """A camera-to-world matrix on the sphere of `radius` looking at the
  origin (Blender convention: the camera's -z axis points at it)."""
  theta = rng.uniform(0, 2 * np.pi)
  phi = rng.uniform(-0.9, 0.9)
  eye = radius * np.array([
      np.cos(theta) * np.cos(phi),
      np.sin(theta) * np.cos(phi),
      np.sin(phi)])
  fwd = eye / np.linalg.norm(eye)  # +z away from the target
  up = np.array([0.0, 0.0, 1.0])
  if abs(np.dot(up, fwd)) > 0.99:
    up = np.array([0.0, 1.0, 0.0])
  right = np.cross(up, fwd)
  right /= np.linalg.norm(right)
  true_up = np.cross(fwd, right)
  c2w = np.eye(4)
  c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, true_up, fwd, eye
  return c2w


def make_scene(out_dir, n_train=16, n_val=2, n_test=2, res=128, grid_n=64,
               extent=1.5, near=2.0, far=6.0, radius=4.0, num_samples=768,
               camera_angle_x=0.6911112070083618, seed=0, device=None):
  """Write the dataset to out_dir on `device` (None: the card); returns
  out_dir."""
  from PIL import Image
  device = resolve_device(device)
  rng = np.random.RandomState(seed)
  os.makedirs(os.path.join(out_dir, "imgs"), exist_ok=True)
  os.makedirs(os.path.join(out_dir, "voxelize"), exist_ok=True)

  grid_values = blob_ior_grid(grid_n, extent)
  spec = grid_ops.GridSpec([grid_n] * 3, [-extent] * 3, [extent] * 3)
  with open(os.path.join(out_dir, "voxelize", "mesh.pkl"), "wb") as f:
    pickle.dump({
        "data": grid_values.astype(np.float64),
        "extent": extent,
        "min_point": [-1, -1, -1],
        "max_point": [1, 1, 1],
        "num_voxels": grid_n,
    }, f)

  idx = 0
  for split, count in (("train", n_train), ("val", n_val), ("test", n_test)):
    frames = []
    for _ in range(count):
      c2w = look_at_pose(rng, radius)
      scene_rays = rays_lib.generate_pinhole_rays(
          res, res, 0.5 * res / np.tan(0.5 * camera_angle_x), c2w[None],
          use_pixel_centers=True)
      rgb = render_gt(spec, grid_values, scene_rays.origins[0],
                      scene_rays.viewdirs[0], near, far, num_samples, device)
      rgba = np.concatenate([rgb, np.ones_like(rgb[..., :1])], axis=-1)
      name = f"imgs/r_{idx}"
      Image.fromarray((np.clip(rgba, 0, 1) * 255).astype(np.uint8)).save(
          os.path.join(out_dir, name + ".png"))
      frames.append({"file_path": name, "transform_matrix": c2w.tolist()})
      idx += 1
    with open(os.path.join(out_dir, f"transforms_{split}.json"), "w") as f:
      json.dump({"camera_angle_x": camera_angle_x, "frames": frames}, f)
  return out_dir
