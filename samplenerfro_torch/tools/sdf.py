"""ctypes binding of the port's sdfcore (native/sdfcore.cpp).

The port's counterpart of samplenerfro_tpu/tools/sdf.py:24-160: the `SDF`
class (containment, signed distance, nearest vertex, surface samples, the
bounding box and the face normals) of a triangle mesh. The library is
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
        (lib.sdf_face_normals, [vp, fp])):
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

  def __init__(self, verts, faces):
    self._lib = _load()
    self.verts = np.ascontiguousarray(verts, np.float32)
    self.faces = np.ascontiguousarray(faces, np.int32)
    # robust=1: containment by a majority over several rays, as the JAX
    # binding's default.
    self._h = self._lib.sdf_create(
        _fptr(self.verts), len(self.verts),
        self.faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(self.faces), 1)
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
