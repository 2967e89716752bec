"""Carry weights from the JAX package into the port's NerfModel.

A flax `Dense_i` of a radiance MLP becomes `layers[i]` of the matching
torch module (models/mlp.py keeps the JAX layer order), and the path
sampler's `so3_mlp/Dense_*` become `path_sampler.so3_mlp.layers.Dense_*`
(ops/mlp.So3MLP keeps the flax names), each kernel [in, out] transposed
into Linear.weight [out, in]. Weights also travel as a flat .npz whose keys
are '/'-joined param paths ("coarse_mlp/Dense_0/kernel"), a format that
needs no flax.
"""

import numpy as np
import torch

_MLPS = ("coarse_mlp", "fine_mlp", "bkgd_mlp")


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


def _dense(sd, prefix, p):
  kernel = np.asarray(p["kernel"], np.float32)
  sd[f"{prefix}.weight"] = torch.from_numpy(kernel.T.copy())
  sd[f"{prefix}.bias"] = torch.from_numpy(
      np.asarray(p["bias"], np.float32).copy())


def params_from_flax(tree):
  """JAX `variables['params']` (nested dict of arrays) -> NerfModel state_dict.

  The returned dict holds every MLP weight and the so3 head; the path
  sampler's grid buffer is not a parameter and stays as the model built it
  (load_into).
  """
  sd = {}
  for mod, layers in tree.items():
    if mod == "path_sampler":
      if set(layers) != {"so3_mlp"}:
        raise ValueError(f"unexpected path_sampler params {sorted(layers)}")
      for name, p in layers["so3_mlp"].items():
        _dense(sd, f"path_sampler.so3_mlp.layers.{name}", p)
      continue
    if mod not in _MLPS:
      raise ValueError(f"unexpected top-level param module {mod!r}")
    for name, p in layers.items():
      if not name.startswith("Dense_"):
        raise ValueError(f"unexpected layer {mod}/{name}")
      _dense(sd, f"{mod}.layers.{int(name[len('Dense_'):])}", p)
  return sd


def params_to_flax(model):
  """NerfModel -> nested dict of numpy arrays in the JAX param layout."""
  tree = {}
  for key, v in model.state_dict().items():
    if key == "path_sampler.grid":
      continue
    *path, kind = key.split(".")
    if path[0] == "path_sampler":  # path_sampler.so3_mlp.layers.Dense_i
      node = tree.setdefault("path_sampler", {}).setdefault("so3_mlp", {})
      name = path[-1]
    else:  # <mlp>.layers.<i>
      node = tree.setdefault(path[0], {})
      name = f"Dense_{path[-1]}"
    arr = v.detach().cpu().numpy()
    node.setdefault(name, {})["kernel" if kind == "weight" else "bias"] = (
        arr.T.copy() if kind == "weight" else arr.copy())
  return tree


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
