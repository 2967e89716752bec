"""Voxelize a scene's proxy mesh into its IOR grid (voxelize/mesh.pkl).

    python -m samplenerfro_torch.voxelize_mesh --data_dir=<scene> \
        [--num_samples=4] [--num_voxels=128] [--extent=1.5] \
        [--min_point=X --min_point=Y --min_point=Z] [--max_point=...] \
        [--threshold=1.165] [--config=configs/<scene>]

The port's counterpart of voxelize_mesh.py, with its flags: reads
<data_dir>/mesh.obj and writes <data_dir>/voxelize/mesh.pkl with the keys
{data, extent, min_point, max_point, num_voxels} (data: [num_voxels^3, 1]
float64, the mean IOR of each voxel's num_samples^3 lattice, 1.33 inside
the mesh and 1.0 outside) and the preview
voxelize/mesh_<num_samples>_<num_voxels>_<extent>_<threshold>.obj, the
marching-tetrahedra surface at --threshold. --extent > 0 gives the box
[-extent, extent]^3, else --min_point/--max_point. The containment
queries run on the host (tools/sdf.py, threaded over the CPU's cores), as
in the JAX tool; a 128^3 grid of 4^3 samples is 134M queries.
"""

import argparse
import os
import pickle
import time

import numpy as np

from samplenerfro_torch.tools import isosurface
from samplenerfro_torch.tools import objio
from samplenerfro_torch.tools import sdf as sdflib
from samplenerfro_torch.utils import config as config_lib

IOR_INSIDE = 1.33


def voxelize(mesh, num_samples, num_voxels, extent, min_point, max_point):
  """[num_voxels^3, 1] float64 mean IOR over each voxel's sample lattice.

  The meshgrid orders and the batch size are voxelize_mesh.py's, which fix
  the grid's axis order.
  """
  intersector = sdflib.SDF(mesh.vertices, mesh.faces)
  ns = num_samples
  yy, xx, zz = np.meshgrid(np.linspace(-1, 1, ns), np.linspace(-1, 1, ns),
                           np.linspace(-1, 1, ns))
  offset = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3)

  nv = num_voxels
  yy, xx, zz = np.meshgrid(np.linspace(0, 1, nv), np.linspace(0, 1, nv),
                           np.linspace(0, 1, nv))
  if extent > 0:
    x_max = y_max = z_max = extent
    x_min = y_min = z_min = -extent
  else:
    x_max, y_max, z_max = max_point
    x_min, y_min, z_min = min_point
  offset_scale = (2 * np.array([x_max - x_min, y_max - y_min,
                                z_max - z_min])[None]) / (nv - 1) * 0.5
  xx = xx * (x_max - x_min) + x_min
  yy = yy * (y_max - y_min) + y_min
  zz = zz * (z_max - z_min) + z_min
  grid = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3)

  scaled_offsets = (offset * offset_scale).astype(np.float32)  # [S, 3]
  out = np.zeros((grid.shape[0], 1))
  chunk = max(1, (1 << 22) // scaled_offsets.shape[0])
  for i in range(0, grid.shape[0], chunk):
    centers = grid[i:i + chunk].astype(np.float32)  # [C, 3]
    samples = (centers[:, None, :] + scaled_offsets[None, :, :]).reshape(-1, 3)
    inside = intersector.contains(samples).reshape(len(centers), -1)
    out[i:i + chunk, 0] = np.where(inside, IOR_INSIDE, 1.0).mean(axis=1)
  return out


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--data_dir", default=None)
  p.add_argument("--config", default=None,
                 help="flag overlay path without .yaml (checked, and its "
                 "data_dir used when --data_dir is not given)")
  p.add_argument("--num_samples", type=int, default=4,
                 help="sampling resolution of voxelization")
  p.add_argument("--num_voxels", type=int, default=128,
                 help="resolution of voxel grid")
  p.add_argument("--extent", type=float, default=3.0,
                 help="extent of voxel grid")
  p.add_argument("--min_point", type=float, action="append", default=None,
                 help="minimum point of voxel grid (three times)")
  p.add_argument("--max_point", type=float, action="append", default=None,
                 help="maximum point of voxel grid (three times)")
  p.add_argument("--threshold", type=float, default=1.0,
                 help="threshold of isosurface")
  ns = p.parse_args(argv)
  min_point = ns.min_point or [-1.0, -1.0, -1.0]
  max_point = ns.max_point or [1.0, 1.0, 1.0]
  data_dir = ns.data_dir
  if ns.config is not None:
    args, _, _ = config_lib.load_args(ns.config)
    data_dir = data_dir or args.data_dir
  if data_dir is None:
    raise ValueError("data_dir must be set. None set now.")

  out_dir = os.path.join(data_dir, "voxelize")
  os.makedirs(out_dir, exist_ok=True)
  mesh = objio.load(os.path.join(data_dir, "mesh.obj"))
  t0 = time.time()
  out = voxelize(mesh, ns.num_samples, ns.num_voxels, ns.extent, min_point,
                 max_point)
  print(f"voxelize: {out.shape[0] * ns.num_samples**3} containment queries "
        f"in {time.time() - t0:.1f} s", flush=True)
  with open(os.path.join(out_dir, "mesh.pkl"), "wb") as f:
    pickle.dump({
        "data": out,
        "extent": ns.extent,
        "min_point": min_point,
        "max_point": max_point,
        "num_voxels": ns.num_voxels,
    }, f)

  nv = ns.num_voxels
  sigma = out.reshape(nv, nv, nv)
  print("fraction occupied", np.mean(sigma > ns.threshold))
  vertices, triangles = isosurface.marching_cubes(sigma, ns.threshold)
  print("done", vertices.shape, triangles.shape)
  preview = objio.Trimesh(vertices / nv - 0.5, triangles)
  preview_path = os.path.join(
      out_dir, f"mesh_{ns.num_samples}_{ns.num_voxels}_{ns.extent}_"
      f"{ns.threshold}.obj")
  preview.export(preview_path)
  return out, preview_path


if __name__ == "__main__":
  main()
