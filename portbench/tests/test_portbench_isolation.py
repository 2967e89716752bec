"""The benchmark loads no JAX and no JAX package; the reference loads
nothing of the program it checks."""

import os
import subprocess
import sys

from portbench import harness

CODE = """
import importlib, sys
mods = {mods!r}
for m in mods:
  importlib.import_module(m)
top = sorted({{n.split(".")[0] for n in sys.modules}})
print(" ".join(top))
"""


def harness_modules():
  out = []
  for base, dirs, files in os.walk(harness.PKG):
    dirs[:] = [d for d in dirs if d not in ("tests", "__pycache__")]
    rel = os.path.relpath(base, harness.ROOT).replace(os.sep, ".")
    for f in files:
      if f.endswith(".py") and "." not in f[:-3] and f != "__init__.py":
        out.append(f"{rel}.{f[:-3]}")
  return sorted(out)


def loaded(mods):
  env = dict(os.environ, USE_FLAX="0")
  res = subprocess.run([sys.executable, "-c", CODE.format(mods=mods)],
                       cwd=harness.ROOT, env=env, capture_output=True,
                       text=True, timeout=300, check=True)
  return set(res.stdout.split())


def test_harness_loads_no_jax():
  mods = harness_modules()
  assert "portbench.cells.train" in mods and "portbench.run" in mods
  top = loaded(mods + ["samplenerfro_torch.train.loop",
                       "samplenerfro_torch.eval"])
  assert not top & set(harness.FORBIDDEN), top & set(harness.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
  top = loaded(["portbench.reference.model", "portbench.reference.scene",
                "portbench.counts.nerf"])
  assert "samplenerfro_torch" not in top
  assert not top & set(harness.FORBIDDEN)


def test_forbidden_names_compare_whole_top_level_names():
  near = ["jaxtyping", "samplenerfro_torch.ops", "samplenerfro_tpu_x",
          "optaxx.y"]
  assert harness.forbidden_modules(near) == []
  assert harness.forbidden_modules(near + ["flax.linen", "jax"]) == [
      "flax", "jax"]
