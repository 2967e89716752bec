"""mesh.pkl IOR-grid loading, rescaling and prefiltering.

Counterpart of samplenerfro_tpu/utils/grid_io.py, plus
`synthetic_blob_grid`, the port's copy of
samplenerfro_tpu/tools/synth.py:blob_ior_grid, for runs without a
voxelized scene.
"""

import pickle
from os import path

import numpy as np
import torch

from samplenerfro_torch.ops import grid as grid_ops

# Scene-name substrings that select refractive_index = 0.33.
_K033_SUBSTRINGS = ("glass", "wineglass", "pen", "torus_skydome-bkgd_cycles",
                    "dolphin", "lighthouse", "yellow")


def refractive_rescale_factor(config_name):
  """The k in (data-1)*k/0.33+1, selected by scene-name substring."""
  name = config_name or ""
  return 0.33 if any(s in name for s in _K033_SUBSTRINGS) else 0.5


def load_mesh_pkl(data_dir, voxel_grid_dir):
  """Load <data_dir>/<voxel_grid_dir>/mesh.pkl -> (data [N^3,1], ndim, nmin, nmax).

  mesh.pkl is the file voxelize_mesh.py writes for a scene.
  """
  with open(path.join(data_dir, voxel_grid_dir, "mesh.pkl"), "rb") as f:
    mesh_dict = pickle.load(f)
  if mesh_dict["extent"] > 0:
    e = mesh_dict["extent"]
    nmin, nmax = [-e, -e, -e], [e, e, e]
  else:
    nmin = list(mesh_dict["min_point"])
    nmax = list(mesh_dict["max_point"])
  n = mesh_dict["num_voxels"]
  data = np.asarray(mesh_dict["data"], np.float32).reshape(-1, 1)
  return data, [n, n, n], nmin, nmax


def load_ior_grid(data_dir, cfg, config_name, device=None):
  """Load + rescale + optional Gaussian prefilter (on `device`).

  Returns (grid [N^3, 1] float32 tensor on `device`, ndim, nmin, nmax).
  """
  data, ndim, nmin, nmax = load_mesh_pkl(data_dir, cfg.voxel_grid)
  k = refractive_rescale_factor(config_name)
  grid = torch.from_numpy((data - 1.0) * k / 0.33 + 1.0).to(device)
  if cfg.kernel_size > 0:
    grid = grid_ops.gaussian_prefilter(grid, tuple(ndim), cfg.kernel_size,
                                       cfg.kernel_sigma)
  return grid, ndim, nmin, nmax


def synthetic_blob_grid(n, extent=1.5, peak=0.33, sigma2=0.25):
  """Smooth Gaussian IOR blob 1 + peak*exp(-r^2/sigma2) on an n^3 lattice.

  Returns ([n^3, 1] float32 numpy, ndim, nmin, nmax). The axes broadcast
  instead of going through a meshgrid, so a 512^3 grid needs no three
  full-size coordinate arrays; the values are the same.
  """
  axes = np.linspace(-extent, extent, n)
  r2 = (axes[:, None, None]**2 + axes[None, :, None]**2
        + axes[None, None, :]**2)
  vals = 1.0 + peak * np.exp(-r2 / sigma2)
  return (vals.reshape(-1, 1).astype(np.float32), [n] * 3, [-extent] * 3,
          [extent] * 3)
