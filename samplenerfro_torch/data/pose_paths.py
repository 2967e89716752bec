"""Camera-path generation for LLFF forward-facing captures.

The port's own copy of samplenerfro_tpu/data/pose_paths.py: pose
recentering around the average camera, the spiral render path of a
forward-facing capture, and the spherified poses and orbit path of an
inward-facing one, each as batched numpy (no per-frame loop).

Pose convention: [3, 5] rows = camera-to-world rotation columns
(x_right, y_up, z_back), translation, and an hwf column appended last.
"""

import numpy as np


def _unit(v, axis=-1):
  return v / np.linalg.norm(v, axis=axis, keepdims=True)


def _lookat_frames(z, up, origin):
  """Batched camera frames: columns (x, y, z, origin) -> [..., 3, 4].

  x = up x z and y = z x x re-orthogonalized, the LLFF `viewmatrix`
  convention.
  """
  z = _unit(np.asarray(z, np.float64))
  up = np.broadcast_to(np.asarray(up, np.float64), z.shape)
  x = _unit(np.cross(up, z))
  y = _unit(np.cross(z, x))
  return np.stack([x, y, z, np.broadcast_to(origin, z.shape)], axis=-1)


def average_pose(poses):
  """The 'central' camera frame of a capture: [3, 5] incl. the hwf column.

  Position is the mean camera center; forward/up are the (renormalized)
  summed forward/up axes of all views.
  """
  frame = _lookat_frames(poses[:, :3, 2].sum(0), poses[:, :3, 1].sum(0),
                         poses[:, :3, 3].mean(0))
  return np.concatenate([frame, poses[0, :3, -1:]], axis=1)


def _as_homogeneous(mats34):
  bottom = np.broadcast_to(np.eye(4)[3], mats34.shape[:-2] + (1, 4))
  return np.concatenate([mats34, bottom], axis=-2)


def recenter_poses(poses):
  """Express all poses in the average camera's frame (world re-basing)."""
  avg44 = _as_homogeneous(average_pose(poses)[None, :, :4])[0]
  rebased = np.einsum("ij,njk->nik", np.linalg.inv(avg44),
                      _as_homogeneous(poses[:, :3, :4]))
  out = poses.copy()
  out[:, :3, :4] = rebased[:, :3, :4]
  return out


def spiral_path(poses, bds, frames=120, rotations=2, zrate=0.5, dt=0.75):
  """Spiral render path around the average pose (forward-facing captures).

  Camera centers trace `rotations` turns of an ellipse whose radii are the
  90th-percentile camera offsets, bobbing in z at `zrate`; every frame
  looks at a fixed focus point at the harmonic-mean scene depth.
  Returns [frames, 3, 4] float32.
  """
  c2w = average_pose(poses)[:, :4].astype(np.float64)
  up = poses[:, :3, 1].sum(0)
  near, far = bds.min() * 0.9, bds.max() * 5.0
  focal = 1.0 / ((1.0 - dt) / near + dt / far)
  radii = np.append(np.percentile(np.abs(poses[:, :3, 3]), 90, axis=0), 1.0)
  theta = np.linspace(0.0, 2.0 * np.pi * rotations, frames, endpoint=False)
  offsets = np.stack([np.cos(theta), -np.sin(theta),
                      -np.sin(theta * zrate), np.ones_like(theta)], axis=-1)
  centers = np.einsum("ij,nj->ni", c2w, offsets * radii)
  focus = c2w @ np.array([0.0, 0.0, -focal, 1.0])
  return _lookat_frames(centers - focus, up, centers).astype(np.float32)


def spherify_poses(poses, bds):
  """Re-base an inward-facing capture onto the unit sphere + orbit path.

  Finds the point closest to all camera optical axes (least-squares),
  re-bases the world so that point is the origin with the mean camera
  offset as 'up', scales camera distances to unit RMS radius, and builds
  a 120-frame circular orbit at the cameras' mean height.

  Returns (poses_reset [n, 3, 5], render_poses [120, 3, 4], bds_scaled) —
  unlike the reference this does NOT mutate `bds` in place.
  """
  fwd = poses[:, :3, 2].astype(np.float64)          # [n, 3] optical axes
  pos = poses[:, :3, 3].astype(np.float64)          # [n, 3] camera centers
  # Least-squares point nearest all lines (pos_i + t * fwd_i): with the
  # per-line projector P_i = I - d_i d_i^T (idempotent), minimize
  # sum |P_i (x - pos_i)|^2  =>  mean(P_i) x = mean(P_i pos_i).
  proj = np.eye(3) - fwd[:, :, None] * fwd[:, None, :]
  center = np.linalg.solve(proj.mean(0), np.einsum("nij,nj->i", proj, pos)
                           / len(poses))

  # World frame: z_up = mean camera offset; x/y from an arbitrary seed.
  z_up = _unit((pos - center).mean(0))
  x_ax = _unit(np.cross([0.1, 0.2, 0.3], z_up))
  y_ax = _unit(np.cross(z_up, x_ax))
  frame44 = _as_homogeneous(
      np.stack([x_ax, y_ax, z_up, center], axis=1)[None])[0]
  rebased = np.einsum("ij,njk->nik", np.linalg.inv(frame44),
                      _as_homogeneous(poses[:, :3, :4].astype(np.float64)))

  scale = 1.0 / np.sqrt(np.square(rebased[:, :3, 3]).sum(-1).mean())
  rebased[:, :3, 3] *= scale
  bds_scaled = bds * scale

  height = rebased[:, :3, 3].mean(0)[2]
  orbit_r = np.sqrt(1.0 - height**2)  # unit RMS radius after scaling
  th = np.linspace(0.0, 2.0 * np.pi, 120)
  centers = np.stack([orbit_r * np.cos(th), orbit_r * np.sin(th),
                      np.full_like(th, height)], axis=-1)
  # Orbit frames look inward: z points away from the origin, with
  # x = z x (-e_z) and y = z x x (note the flipped cross order vs
  # _lookat_frames — the LLFF orbit convention).
  z = _unit(centers)
  x = _unit(np.cross(z, np.array([0.0, 0.0, -1.0])))
  y = _unit(np.cross(z, x))
  render = np.stack([x, y, z, centers], axis=-1)

  hwf = poses[0, :3, -1:]
  poses_reset = np.concatenate(
      [rebased[:, :3, :4], np.broadcast_to(hwf, (len(poses), 3, 1))], -1)
  return (poses_reset.astype(poses.dtype), render[:, :3, :4],
          bds_scaled)
