"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by nvcc
for sm_90a into `build/torch_kernels/<name>-<hash>.so` inside the
checkout, then loaded with ctypes. The hash covers the source and the
flags, so an edited source rebuilds and an unchanged one is reused. Builds
happen at first use, never at import.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    # Each product and sum rounds on its own, as in the plain PyTorch
    # versions the kernels are held against.
    "-fmad=false",
)

_loaded = {}
_lock = threading.Lock()


def nvcc_path():
  """The nvcc to build with: $CUDA_HOME/bin, /usr/local/cuda/bin or PATH."""
  for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
      return os.path.join(home, "bin", "nvcc")
  found = shutil.which("nvcc")
  if found is None:
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the port's CUDA kernels")
  return found


def _target(name):
  src = CSRC / f"{name}.cu"
  digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
  return src, BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name):
  """Start nvcc for one kernel; returns (Popen, tmp, so, log) or None."""
  src, so = _target(name)
  if so.exists():
    return None
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = so.with_suffix(f".{os.getpid()}.tmp")
  log = so.with_suffix(".log")
  cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
  proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
  return proc, tmp, so, log


def _finish(name, job):
  proc, tmp, so, log = job
  out, _ = proc.communicate()
  log.write_text(out)
  if proc.returncode != 0:
    raise RuntimeError(f"nvcc failed for {name} (exit {proc.returncode}):\n"
                       f"{out}")
  os.replace(tmp, so)


def build(names):
  """Compile the named kernels, all nvcc processes started together.

  Returns {name: nvcc output} for the kernels built by this call.
  """
  with _lock:
    jobs = {n: _start(n) for n in names}
    for n, job in jobs.items():
      if job is not None:
        _finish(n, job)
    return {n: _target(n)[1].with_suffix(".log").read_text()
            for n, job in jobs.items() if job is not None}


def kernel_names():
  return sorted(p.stem for p in CSRC.glob("*.cu"))


def load(name):
  """The ctypes library of kernel `name`, built first if needed."""
  with _lock:
    lib = _loaded.get(name)
  if lib is not None:
    return lib
  build([name])
  lib = ctypes.CDLL(str(_target(name)[1]))
  with _lock:
    _loaded[name] = lib
  return lib
