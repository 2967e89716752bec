"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by nvcc
for sm_90a into `build/torch_kernels/<name>-<hash>.so` inside the
checkout, then loaded with ctypes. The hash covers the source, the
`csrc/*.cuh` headers it includes, the flags and any `-D` defines (a
kernel's trial switches), so an edited source or header rebuilds and an
unchanged one is reused. Builds happen at first use, never at import.
"""

import ctypes
import hashlib
import os
import re
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


def _local_headers(src):
  """The csrc headers a source includes by quoted name, and those they
  include, each once, in order."""
  found = []
  for m in re.finditer(r'^#include "([^"]+)"', src.read_text(),
                       flags=re.MULTILINE):
    header = CSRC / m.group(1)
    for h in [header, *_local_headers(header)]:
      if h not in found:
        found.append(h)
  return found


def _flags(defines):
  return (*NVCC_FLAGS, *(f"-D{d}" for d in defines))


def _target(name, defines=()):
  src = CSRC / f"{name}.cu"
  content = src.read_bytes() + b"".join(h.read_bytes()
                                        for h in _local_headers(src))
  digest = hashlib.sha256(content + " ".join(_flags(defines)).encode())
  return src, BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name, defines=()):
  """Start nvcc for one kernel; returns (Popen, tmp, so, log) or None."""
  src, so = _target(name, defines)
  if so.exists():
    return None
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = so.with_suffix(f".{os.getpid()}.tmp")
  log = so.with_suffix(".log")
  cmd = [nvcc_path(), *_flags(defines), "-o", str(tmp), str(src)]
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


def build(names, defines=(), also=()):
  """Compile the named kernels with the given `-D` defines, and each
  (name, defines) of `also`, all nvcc processes started together.

  Returns {(name, defines): nvcc output} for the kernels built by this
  call.
  """
  targets = [(n, tuple(defines)) for n in names]
  targets += [(n, tuple(d)) for n, d in also]
  with _lock:
    jobs = {t: _start(*t) for t in targets}
    for t, job in jobs.items():
      if job is not None:
        _finish(t[0], job)
    return {t: _target(*t)[1].with_suffix(".log").read_text()
            for t, job in jobs.items() if job is not None}


def kernel_names():
  return sorted(p.stem for p in CSRC.glob("*.cu"))


def load(name, defines=()):
  """The ctypes library of kernel `name` built with `defines`, built first
  if needed."""
  key = (name, tuple(defines))
  with _lock:
    lib = _loaded.get(key)
  if lib is not None:
    return lib
  build([name], defines)
  lib = ctypes.CDLL(str(_target(name, defines)[1]))
  with _lock:
    _loaded[key] = lib
  return lib
