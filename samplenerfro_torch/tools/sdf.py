"""ctypes binding of the port's sdfcore (native/sdfcore.cpp).

The port's counterpart of samplenerfro_tpu/tools/sdf.py: the `SDF` class
(containment, signed distance, nearest vertex, surface samples, the
bounding box and the face normals) of a triangle mesh, and `Renderer`,
the raycast depth, mask and nearest-vertex images of a mesh seen by a
pinhole camera at the origin looking down +z. The library is
built with g++ at first use into build/sdfcore/libsdfcore-<hash>.so in the
checkout, keyed by a hash of the source and the flags as
ops/cuda_build.py keys the CUDA kernels; a failed build raises. This is
host code, as in the JAX package.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "native" / "sdfcore.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sdfcore"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lib = None
_lock = threading.Lock()


def library_path():
  """Where the library of this source and these flags is built."""
  digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode())
  return BUILD_DIR / f"libsdfcore-{digest.hexdigest()[:16]}.so"


def _build(so):
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = so.with_suffix(f".{os.getpid()}.tmp")
  proc = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                        capture_output=True, text=True)
  if proc.returncode != 0:
    raise RuntimeError(f"g++ failed for {SRC} (exit {proc.returncode}):\n"
                       f"{proc.stdout}{proc.stderr}")
  os.replace(tmp, so)


def _load():
  global _lib
  with _lock:
    if _lib is not None:
      return _lib
    so = library_path()
    if not so.exists():
      _build(so)
    lib = ctypes.CDLL(str(so))
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    fp = ctypes.POINTER(ctypes.c_float)
    lib.sdf_create.restype = vp
    lib.sdf_create.argtypes = [fp, i64, ctypes.POINTER(ctypes.c_int32), i64,
                               ctypes.c_int]
    for fn, argtypes in (
        (lib.sdf_destroy, [vp]),
        (lib.sdf_contains, [vp, fp, i64, ctypes.POINTER(ctypes.c_uint8)]),
        (lib.sdf_calc, [vp, fp, i64, fp]),
        (lib.sdf_nn, [vp, fp, i64, ctypes.POINTER(ctypes.c_int32)]),
        (lib.sdf_sample_surface, [vp, i64, ctypes.c_uint64, fp]),
        (lib.sdf_aabb, [vp, fp]),
        (lib.sdf_face_normals, [vp, fp]),
        (lib.sdf_render_depth, [vp, ctypes.c_int, ctypes.c_int] + [
            ctypes.c_float] * 4 + [fp]),
        (lib.sdf_render_nn, [vp, ctypes.c_int, ctypes.c_int] + [
            ctypes.c_float] * 4 + [ctypes.POINTER(ctypes.c_int32)])):
      fn.argtypes, fn.restype = argtypes, None
    _lib = lib
    return lib


def _fptr(a):
  return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _points(points):
  return np.ascontiguousarray(points, np.float32).reshape(-1, 3)


class SDF:
  """Containment, signed distance and sampling queries of a watertight
  triangle mesh (pysdf's SDF)."""

  def __init__(self, verts, faces, robust=True):
    self._lib = _load()
    self.verts = np.ascontiguousarray(verts, np.float32)
    self.faces = np.ascontiguousarray(faces, np.int32)
    # robust: containment by a majority over several rays (the default of
    # both bindings); Renderer's mesh needs ray hits only.
    self._h = self._lib.sdf_create(
        _fptr(self.verts), len(self.verts),
        self.faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(self.faces), int(robust))
    self._seed = 0

  def __del__(self):
    if getattr(self, "_h", None):
      self._lib.sdf_destroy(self._h)
      self._h = None

  def contains(self, points):
    """[N] bool: True where a point is inside the mesh."""
    pts = _points(points)
    out = np.empty(len(pts), np.uint8)
    self._lib.sdf_contains(self._h, _fptr(pts), len(pts),
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.astype(bool)

  def calc(self, points):
    """[N] float32 signed distance, positive inside."""
    pts = _points(points)
    out = np.empty(len(pts), np.float32)
    self._lib.sdf_calc(self._h, _fptr(pts), len(pts), _fptr(out))
    return out

  def nn(self, points):
    """[N] int32 index of each point's nearest vertex."""
    pts = _points(points)
    out = np.empty(len(pts), np.int32)
    self._lib.sdf_nn(self._h, _fptr(pts), len(pts),
                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out

  def sample_surface(self, num_points):
    """[N, 3] float32 area-weighted uniform samples of the surface; each
    call draws with the next seed."""
    out = np.empty((num_points, 3), np.float32)
    self._seed += 1
    self._lib.sdf_sample_surface(self._h, num_points, self._seed, _fptr(out))
    return out

  @property
  def aabb(self):
    """[2, 3] float32: the mesh's (min, max) corners."""
    out = np.empty(6, np.float32)
    self._lib.sdf_aabb(self._h, _fptr(out))
    return out.reshape(2, 3)

  @property
  def face_normals(self):
    """[F, 3] float32 unit normals of the faces."""
    out = np.empty((len(self.faces), 3), np.float32)
    self._lib.sdf_face_normals(self._h, _fptr(out))
    return out


class Renderer:
  """Raycast images of a mesh in camera space (pysdf's Renderer): a pinhole
  camera at the origin looking down +z, the ray of pixel (u, v) along
  ((u - cx) / fx, (v - cy) / fy, 1)."""

  def __init__(self, verts, faces, width=1080, height=1080, fx=2600.0,
               fy=2600.0, cx=540.0, cy=540.0):
    self._sdf = SDF(verts, faces, robust=False)
    self.width, self.height = int(width), int(height)
    self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy

  def render_depth(self):
    """[height, width] float32 distance of each pixel's first hit along its
    ray (in units of the ray's length at z = 1), 0 where it hits nothing."""
    out = np.empty(self.height * self.width, np.float32)
    self._sdf._lib.sdf_render_depth(
        self._sdf._h, self.width, self.height, self.fx, self.fy, self.cx,
        self.cy, _fptr(out))
    return out.reshape(self.height, self.width)

  def render_mask(self):
    """[height, width] bool: where a ray hits the mesh."""
    return self.render_depth() > 0

  def render_nn(self, fill_outside=False):
    """[height, width] int32 index of the hit face's vertex nearest to the
    hit, -1 where nothing is hit; `fill_outside` gives such a pixel the
    value of its nearest hit pixel."""
    out = np.empty(self.height * self.width, np.int32)
    self._sdf._lib.sdf_render_nn(
        self._sdf._h, self.width, self.height, self.fx, self.fy, self.cx,
        self.cy, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    out = out.reshape(self.height, self.width)
    if fill_outside and (out < 0).any() and (out >= 0).any():
      ys, xs = np.nonzero(out >= 0)
      ey, ex = np.nonzero(out < 0)
      d2 = (ey[:, None] - ys[None, :])**2 + (ex[:, None] - xs[None, :])**2
      out[ey, ex] = out[ys, xs][np.argmin(d2, axis=1)]
    return out
