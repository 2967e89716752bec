"""Turntable depth and mask renders of a mesh with the raycast Renderer.

    python -m samplenerfro_torch.tools.sdf_demo mesh.obj out_dir \
        [--views 8] [--size 256]

The port's counterpart of samplenerfro_tpu/tools/sdf_demo.py: the mesh is
seen from `views` points on a ring at three times its radius around its
centre, slightly above it, and each view writes depth_<i>.png (nearest
hit white, farthest black) and mask_<i>.png and prints its coverage. Host
code (tools/sdf.Renderer); it needs no card.
"""

import argparse
import os

import numpy as np

from samplenerfro_torch.tools import objio
from samplenerfro_torch.tools import sdf as sdflib


def view_rotation(eye, center):
  """World-to-camera rotation of a camera at `eye` looking at `center`
  with +z up: rows x right, y image-down, z forward."""
  fwd = center - eye
  fwd /= np.linalg.norm(fwd)
  right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
  right /= np.linalg.norm(right)
  true_up = np.cross(right, fwd)
  return np.stack([right, -true_up, fwd])


def render_views(mesh, views, size):
  """[(depth [size, size], mask [size, size])] of each view of the ring."""
  center = mesh.vertices.mean(0)
  radius = float(np.max(np.linalg.norm(mesh.vertices - center, axis=-1)))
  out = []
  for theta in np.linspace(0, 2 * np.pi, views, endpoint=False):
    eye = center + 3.0 * radius * np.array(
        [np.cos(theta), np.sin(theta), 0.3])
    cam_verts = (mesh.vertices - eye) @ view_rotation(eye, center).T
    ren = sdflib.Renderer(cam_verts, mesh.faces, width=size, height=size,
                          fx=size, fy=size, cx=size / 2, cy=size / 2)
    depth = ren.render_depth()
    out.append((depth, depth > 0))
  return out


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("mesh")
  p.add_argument("out_dir")
  p.add_argument("--views", type=int, default=8)
  p.add_argument("--size", type=int, default=256)
  args = p.parse_args(argv)

  from PIL import Image
  os.makedirs(args.out_dir, exist_ok=True)
  for i, (depth, mask) in enumerate(
      render_views(objio.load(args.mesh), args.views, args.size)):
    vis = np.zeros_like(depth)
    if mask.any():
      d = depth[mask]
      vis[mask] = 1.0 - (d - d.min()) / max(float(d.max() - d.min()), 1e-6)
    Image.fromarray((vis * 255).astype(np.uint8)).save(
        os.path.join(args.out_dir, f"depth_{i:02d}.png"))
    Image.fromarray((mask * 255).astype(np.uint8)).save(
        os.path.join(args.out_dir, f"mask_{i:02d}.png"))
    print(f"view {i}: {mask.mean() * 100:.1f}% coverage")


if __name__ == "__main__":
  main()
