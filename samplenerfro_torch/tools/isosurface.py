"""Iso-surface extraction by vectorized marching tetrahedra, on the host.

The port's own copy of samplenerfro_tpu/tools/isosurface.py: the same
vertices and faces on the same volume. Each cube is split with its body
centre and 6 face centres into 24 tetrahedra (4 per face); shared cube
faces are split into the same 4 triangles from both sides, so the surface
is crack-free. Centre values are corner averages. Vertices are returned
in voxel index space (i, j, k in [0, N-1]), as mcubes returns them.
"""

import numpy as np

# Point layout per cube: 0..7 corners (bit0->+x, bit1->+y, bit2->+z),
# 8..13 face centers (-x, +x, -y, +y, -z, +z), 14 body center.
_CORNER_OFFSETS = np.array(
    [[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], np.float64)

_FACES = [  # (center offset, corner ids of the face in ring order)
    (np.array([0.0, 0.5, 0.5]), [0, 2, 6, 4]),  # -x
    (np.array([1.0, 0.5, 0.5]), [1, 3, 7, 5]),  # +x
    (np.array([0.5, 0.0, 0.5]), [0, 1, 5, 4]),  # -y
    (np.array([0.5, 1.0, 0.5]), [2, 3, 7, 6]),  # +y
    (np.array([0.5, 0.5, 0.0]), [0, 1, 3, 2]),  # -z
    (np.array([0.5, 0.5, 1.0]), [4, 5, 7, 6]),  # +z
]

_POINT_OFFSETS = np.concatenate([
    _CORNER_OFFSETS,
    np.stack([f[0] for f in _FACES]),
    np.array([[0.5, 0.5, 0.5]]),
])  # [15, 3]

# 24 tets: (body center, face center, edge corner a, edge corner b).
_TETS = []
for fi, (_, ring) in enumerate(_FACES):
  fc = 8 + fi
  for k in range(4):
    _TETS.append([14, fc, ring[k], ring[(k + 1) % 4]])
_TETS = np.array(_TETS, np.int64)  # [24, 4]


def marching_tetrahedra(volume, iso):
  """Extract the iso-surface of a dense scalar volume.

  Args:
    volume: [Nx, Ny, Nz] scalar field.
    iso: float iso-level.

  Returns:
    (vertices [V, 3] float64 in index space, faces [F, 3] int64).
  """
  volume = np.asarray(volume, np.float64)
  nx, ny, nz = volume.shape
  if min(nx, ny, nz) < 2:
    return np.zeros((0, 3)), np.zeros((0, 3), np.int64)

  bx, by, bz = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1),
                           np.arange(nz - 1), indexing="ij")
  base = np.stack([bx, by, bz], axis=-1).reshape(-1, 3)  # [C, 3]

  corner_vals = np.stack([
      volume[base[:, 0] + int(o[0]), base[:, 1] + int(o[1]),
             base[:, 2] + int(o[2])]
      for o in _CORNER_OFFSETS], axis=-1)  # [C, 8]
  active = (corner_vals.min(-1) <= iso) & (corner_vals.max(-1) > iso)
  base = base[active]
  corner_vals = corner_vals[active]
  if base.shape[0] == 0:
    return np.zeros((0, 3)), np.zeros((0, 3), np.int64)

  face_vals = np.stack(
      [corner_vals[:, ring].mean(-1) for _, ring in _FACES], axis=-1)
  body_val = corner_vals.mean(-1, keepdims=True)
  vals = np.concatenate([corner_vals, face_vals, body_val], axis=-1)  # [C,15]
  pts = base[:, None, :] + _POINT_OFFSETS[None, :, :]  # [C, 15, 3]

  tris = []
  for tet in _TETS:
    v = vals[:, tet]  # [C, 4]
    p = pts[:, tet]  # [C, 4, 3]
    inside = v > iso
    code = (inside * np.array([1, 2, 4, 8])).sum(-1)

    def edge_point(mask, a, b):
      va, vb = v[mask, a], v[mask, b]
      t = (iso - va) / np.where(vb != va, vb - va, 1.0)
      t = np.clip(t, 0.0, 1.0)[:, None]
      return p[mask, a] * (1 - t) + p[mask, b] * t

    # One vertex separated from the other three -> single triangle.
    for corner, c_in, c_out in ((0, 1, 14), (1, 2, 13), (2, 4, 11),
                                (3, 8, 7)):
      others = [x for x in range(4) if x != corner]
      for cc in (c_in, c_out):
        mask = code == cc
        if not mask.any():
          continue
        e0 = edge_point(mask, corner, others[0])
        e1 = edge_point(mask, corner, others[1])
        e2 = edge_point(mask, corner, others[2])
        tris.append(np.stack([e0, e1, e2], axis=1))

    # Two/two split -> quad as two triangles.
    for pair, cc in (((0, 1), 3), ((0, 2), 5), ((0, 3), 9),
                     ((1, 2), 6), ((1, 3), 10), ((2, 3), 12)):
      mask = code == cc
      if not mask.any():
        continue
      a, b = pair
      others = [x for x in range(4) if x not in pair]
      e_a0 = edge_point(mask, a, others[0])
      e_a1 = edge_point(mask, a, others[1])
      e_b0 = edge_point(mask, b, others[0])
      e_b1 = edge_point(mask, b, others[1])
      tris.append(np.stack([e_a0, e_b0, e_b1], axis=1))
      tris.append(np.stack([e_a0, e_b1, e_a1], axis=1))

  if not tris:
    return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
  tri_pts = np.concatenate(tris, axis=0)  # [T, 3, 3]

  flat = tri_pts.reshape(-1, 3)
  quant = np.round(flat * 1e6).astype(np.int64)
  uniq, inv = np.unique(quant, axis=0, return_inverse=True)
  faces = inv.reshape(-1, 3)
  ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2]))
  verts = uniq.astype(np.float64) / 1e6
  return verts, faces[ok]


def marching_cubes(volume, iso):
  """mcubes-compatible alias used by the voxelizer/extractor CLIs."""
  return marching_tetrahedra(volume, iso)
