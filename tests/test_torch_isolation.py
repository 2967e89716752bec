"""The PyTorch port stands alone: it imports no JAX, no flax, none of the
packages behind flax's checkpoint formats (msgpack, tensorstore, zstd)
and nothing of samplenerfro_tpu, not even that package's numpy-only
modules.

Every .py file under samplenerfro_torch/ and chip_smoke.py is parsed with
ast and its imports checked; a second test imports every module of the
port in a fresh interpreter in which those packages cannot be imported.
"""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
# The JAX stack, and the packages of its checkpoint formats, which the
# card's machine cannot be counted on to have: the port reads flax's
# checkpoints with its own codecs (train/ocdbt.py, utils/flax_msgpack.py,
# utils/zstd.py).
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "chex", "msgpack",
             "tensorstore", "zstandard", "zstd", "samplenerfro_tpu")
FILES = sorted(
    str(p.relative_to(ROOT))
    for p in [*(ROOT / "samplenerfro_torch").rglob("*.py"),
              ROOT / "chip_smoke.py"])


def _imported_modules(tree):
  """Top-level names of every module an AST imports, including by string."""
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      for alias in node.names:
        yield alias.name, node.lineno
    elif isinstance(node, ast.ImportFrom):
      if node.level == 0 and node.module:
        yield node.module, node.lineno
    elif isinstance(node, ast.Call):
      fn = node.func
      name = getattr(fn, "attr", None) or getattr(fn, "id", None)
      if (name in ("import_module", "__import__") and node.args
          and isinstance(node.args[0], ast.Constant)
          and isinstance(node.args[0].value, str)):
        yield node.args[0].value, node.lineno


def test_port_files_found():
  assert "chip_smoke.py" in FILES
  for rel in ("ops/march_kernel.py", "ops/eikonal_vjp.py", "ops/mlp.py",
              "train/step.py", "train/checkpoints.py", "train/loop.py",
              "train/__main__.py", "ops/mlp_kernel.py", "utils/probes.py",
              "train/selfcheck.py", "debug/probe_so3_relu.py",
              "train/ocdbt.py", "train/flax_checkpoints.py",
              "utils/flax_msgpack.py", "utils/zstd.py",
              "debug/flax_fixture.py", "parallel/mesh.py",
              "debug/dist_worker.py", "debug/dist_probe.py"):
    assert f"samplenerfro_torch/{rel}" in FILES


@pytest.mark.parametrize("rel", FILES)
def test_no_forbidden_imports(rel):
  tree = ast.parse((ROOT / rel).read_text(), filename=rel)
  bad = [f"{rel}:{line}: {mod}" for mod, line in _imported_modules(tree)
         if mod.split(".")[0] in FORBIDDEN]
  assert not bad, "the port must not import the JAX stack:\n" + "\n".join(bad)


def test_every_module_imports_without_jax():
  import samplenerfro_torch
  names = ["samplenerfro_torch"] + [
      m.name for m in pkgutil.walk_packages(samplenerfro_torch.__path__,
                                            "samplenerfro_torch.")]
  # A None entry in sys.modules makes any import of that package fail.
  code = ("import importlib, sys\n"
          f"for m in {list(FORBIDDEN)!r}: sys.modules[m] = None\n"
          f"for m in {names!r}: importlib.import_module(m)\n")
  proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                        capture_output=True, text=True, timeout=120)
  assert proc.returncode == 0, proc.stderr
