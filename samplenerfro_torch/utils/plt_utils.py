"""Plots of one ray's curved path, drawn with PIL.

Counterpart of samplenerfro_tpu/utils/plt_utils.py:plot_path, the mesh
extraction's debug figure: the path's vertices (white, green-edged), its
projection on a floor under the path and a dropline from every 16th
vertex and the last one, seen from the same four viewpoints (top, right,
front, free: elevation 90, 0, 0, 30 and azimuth 0, 0, 90, -60 degrees) in
an orthographic projection of the path's bounding cube. Drawn with PIL's
ImageDraw, so the port needs no matplotlib.
"""

import numpy as np
from PIL import Image
from PIL import ImageDraw

VIEWS = (("top", 90.0, 0.0), ("right", 0.0, 0.0), ("front", 0.0, 90.0),
         ("free", 30.0, -60.0))
SIZE = 720
GREEN = (139, 206, 151)


def view_axes(elev, azim):
  """(right, up) unit vectors of the screen at elevation/azimuth degrees,
  as matplotlib's 3-D axes orient a view."""
  e, a = np.radians(elev), np.radians(azim)
  right = np.array([-np.sin(a), np.cos(a), 0.0])
  up = np.array([-np.sin(e) * np.cos(a), -np.sin(e) * np.sin(a), np.cos(e)])
  return right, up


def _draw(pts, floor_pts, drops, elev, azim, center, side):
  right, up = view_axes(elev, azim)
  scale = 0.8 * SIZE / (side * np.sqrt(3.0))

  def px(p):
    q = np.asarray(p) - center
    return (SIZE / 2 + scale * (q @ right), SIZE / 2 - scale * (q @ up))

  img = Image.new("RGB", (SIZE, SIZE), "white")
  draw = ImageDraw.Draw(img)
  floor = [px(p) for p in floor_pts]
  draw.line([tuple(map(float, f)) for f in floor], fill=GREEN, width=2)
  for top, bottom in drops:
    a, b = px(top), px(bottom)
    n = max(2, int(np.hypot(b[0] - a[0], b[1] - a[1]) // 4))
    for k in range(0, n, 2):  # dotted
      t0, t1 = k / n, min((k + 1) / n, 1.0)
      draw.line([(a[0] + t0 * (b[0] - a[0]), a[1] + t0 * (b[1] - a[1])),
                 (a[0] + t1 * (b[0] - a[0]), a[1] + t1 * (b[1] - a[1]))],
                fill="black", width=1)
  for p in pts:
    x, y = px(p)
    draw.ellipse([x - 4, y - 4, x + 4, y + 4], fill="white", outline=GREEN)
  return img


def plot_path(ray_pos, out_dir=None):
  """Plot the first ray's path; with out_dir, write top.png, right.png,
  front.png and free.png there. Returns the four images by name."""
  ray_pos = np.asarray(ray_pos, np.float64)
  flat = ray_pos.reshape(-1, 3)
  nmax, nmin = flat.max(0), flat.min(0)
  center = flat.mean(0)
  side = max(float(np.max(nmax - nmin)), 1e-6)
  path = ray_pos[0]
  floor = center[2] - side * 0.5
  floor_pts = np.concatenate([path[:, :2], np.full((len(path), 1), floor)],
                             axis=-1)
  drops = [(path[i], floor_pts[i])
           for i in list(range(0, len(path), 16)) + [-1]]
  images = {}
  for name, elev, azim in VIEWS:
    images[name] = _draw(path, floor_pts, drops, elev, azim, center, side)
    if out_dir is not None:
      images[name].save(f"{out_dir}/{name}.png")
  return images
