"""Carry radiance weights from the JAX package into the port's NerfModel.

A flax `Dense_i` of a module becomes `layers[i]` of the matching torch
module (models/mlp.py keeps the JAX layer order), with the kernel
[in, out] transposed into Linear.weight [out, in]. The path sampler's
`so3_mlp` belongs to the 'all' stage, which is not ported yet: it is
skipped. Weights also travel as a flat .npz whose keys are '/'-joined
param paths ("coarse_mlp/Dense_0/kernel"), a format that needs no flax.
"""

import numpy as np
import torch

_MLPS = ("coarse_mlp", "fine_mlp", "bkgd_mlp")
_SKIPPED = ("path_sampler",)


def flatten(tree, prefix=""):
  """Nested dict of arrays -> {'a/b/c': np.ndarray}."""
  out = {}
  for k, v in tree.items():
    key = f"{prefix}{k}"
    if hasattr(v, "items"):
      out.update(flatten(dict(v.items()), key + "/"))
    else:
      out[key] = np.asarray(v)
  return out


def params_from_flax(tree):
  """JAX `variables['params']` (nested dict of arrays) -> NerfModel state_dict.

  The returned dict holds every MLP weight; the path sampler's grid buffer
  is not a parameter and stays as the model built it (load_into).
  """
  sd = {}
  for mod, layers in tree.items():
    if mod in _SKIPPED:
      continue
    if mod not in _MLPS:
      raise ValueError(f"unexpected top-level param module {mod!r}")
    for name, p in layers.items():
      if not name.startswith("Dense_"):
        raise ValueError(f"unexpected layer {mod}/{name}")
      i = int(name[len("Dense_"):])
      kernel = np.asarray(p["kernel"], np.float32)
      sd[f"{mod}.layers.{i}.weight"] = torch.from_numpy(kernel.T.copy())
      sd[f"{mod}.layers.{i}.bias"] = torch.from_numpy(
          np.asarray(p["bias"], np.float32).copy())
  return sd


def params_from_npz(path):
  """Flat .npz of '/'-joined param paths -> NerfModel state_dict.

  A leading 'params/' on every key is accepted and dropped.
  """
  tree = {}
  with np.load(path) as f:
    for key in f.files:
      parts = key.split("/")
      if parts[0] == "params":
        parts = parts[1:]
      node = tree
      for p in parts[:-1]:
        node = node.setdefault(p, {})
      node[parts[-1]] = f[key]
  return params_from_flax(tree)


def load_into(model, state_dict):
  """Load converted weights; every MLP weight must be present and used."""
  missing, unexpected = model.load_state_dict(state_dict, strict=False)
  missing = [k for k in missing if k != "path_sampler.grid"]
  if missing or unexpected:
    raise ValueError(f"weights do not fit the model: missing {missing}, "
                     f"unexpected {unexpected}")
  return model
