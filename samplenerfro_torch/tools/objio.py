"""Minimal Wavefront OBJ mesh IO (vertices + triangular faces).

The port's own copy of samplenerfro_tpu/tools/objio.py, for the voxelizer
and mesh extraction: v/f records only, polygon faces fan-triangulated,
negative indices resolved.
"""

import numpy as np


def load_obj(path):
  """Load an OBJ file -> (vertices [V, 3] float64, faces [F, 3] int64)."""
  verts = []
  faces = []
  with open(path, "r") as f:
    for line in f:
      if line.startswith("v "):
        parts = line.split()
        verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
      elif line.startswith("f "):
        idx = []
        for tok in line.split()[1:]:
          # f v, f v/vt, f v/vt/vn, f v//vn
          i = int(tok.split("/")[0])
          idx.append(i - 1 if i > 0 else len(verts) + i)
        for k in range(1, len(idx) - 1):  # fan triangulation
          faces.append([idx[0], idx[k], idx[k + 1]])
  return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def save_obj(path, vertices, faces):
  """Write (vertices [V, 3], faces [F, 3]) as OBJ."""
  with open(path, "w") as f:
    for v in np.asarray(vertices):
      f.write(f"v {v[0]} {v[1]} {v[2]}\n")
    for tri in np.asarray(faces):
      f.write(f"f {tri[0] + 1} {tri[1] + 1} {tri[2] + 1}\n")


class Trimesh:
  """Tiny mesh value object with the trimesh attrs our tools use."""

  def __init__(self, vertices, faces):
    self.vertices = np.asarray(vertices, np.float64)
    self.faces = np.asarray(faces, np.int64)

  @property
  def bounds(self):
    return np.stack([self.vertices.min(0), self.vertices.max(0)])

  @property
  def extents(self):
    return self.vertices.max(0) - self.vertices.min(0)

  def export(self, path):
    save_obj(path, self.vertices, self.faces)


def load(path):
  v, f = load_obj(path)
  return Trimesh(v, f)
