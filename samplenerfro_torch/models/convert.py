"""Carry weights from the JAX package into the port's NerfModel.

A flax `Dense_i` of a radiance MLP becomes `layers[i]` of the matching
torch module (models/mlp.py keeps the JAX layer order), and the path
sampler's `so3_mlp/Dense_*` become `path_sampler.so3_mlp.layers.Dense_*`
(ops/mlp.So3MLP keeps the flax names), each kernel [in, out] transposed
into Linear.weight [out, in]. Weights also travel as a flat .npz whose keys
are '/'-joined param paths ("coarse_mlp/Dense_0/kernel"), a format that
needs no flax.

Adam's state crosses too (`optimizer_state_from_flax`): optax's
`multi_transform` state of train/step.py's create_optimizer holds, for
each label, `inner_states[label].inner_state` = (ScaleByAdamState(count,
mu, nu), ScaleByScheduleState(count) or EmptyState), mu and nu trees
shaped like the params with a MaskedNode where a module has another label
(restored as None from an orbax checkpoint, {} from a msgpack one). Each
module of a port param group takes its label's count and its moments,
transposed as its weights are.
"""

import numpy as np
import torch

from samplenerfro_torch.train.step import param_labels_for_stage
from samplenerfro_torch.utils import flax_msgpack

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


def _f32(a):
  """A leaf as float32; bfloat16 bits (utils/flax_msgpack.py) widened
  exactly."""
  if isinstance(a, flax_msgpack.Bfloat16Bits):
    return (np.asarray(a).astype(np.uint32) << 16).view(np.float32)
  return np.asarray(a, np.float32)


def _dense(sd, prefix, p):
  sd[f"{prefix}.weight"] = torch.from_numpy(_f32(p["kernel"]).T.copy())
  sd[f"{prefix}.bias"] = torch.from_numpy(_f32(p["bias"]).copy())


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
  return _state_dict_to_flax({k: v for k, v in model.state_dict().items()
                              if k != "path_sampler.grid"})


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


def _masked(node):
  """An optax MaskedNode as a checkpoint restores it: None from orbax,
  {} from msgpack (a namedtuple without fields)."""
  return node is None or (isinstance(node, dict) and not node)


def moments_from_flax(opt_state, labels):
  """Adam moments of the modules of `labels` ({module: label}, the port's
  param groups) in optax's restored multi_transform state.

  Returns:
    {module: {"label", "count" (int, the label's Adam count),
    "schedule_count" (its scale_by_schedule count, or None for a constant
    rate), "exp_avg", "exp_avg_sq" (state_dict-keyed tensors)}}; a module
    masked in the checkpoint (trained under another label there) is left
    out.

  Raises:
    ValueError: a label has no Adam state, or a module has one moment but
      not the other.
  """
  out = {}
  for module, label in labels.items():
    try:
      inner = opt_state["inner_states"][label]["inner_state"]
      adam = inner["0"]
      mu, nu = adam["mu"].get(module), adam["nu"].get(module)
    except (KeyError, TypeError, AttributeError) as e:
      raise ValueError(f"opt_state has no Adam state for label {label!r} "
                       f"({type(e).__name__}: {e})") from e
    if _masked(mu) and _masked(nu):
      continue
    if _masked(mu) or _masked(nu):
      raise ValueError(f"opt_state label {label!r}: {module} has one of "
                       "mu and nu only")
    sched = inner.get("1")
    out[module] = {
        "label": label, "count": int(np.asarray(adam["count"])),
        "schedule_count": (int(np.asarray(sched["count"]))
                           if isinstance(sched, dict) and "count" in sched
                           else None),
        "exp_avg": params_from_flax({module: mu}),
        "exp_avg_sq": params_from_flax({module: nu})}
  return out


def optimizer_state_from_flax(opt_state, stage, num_fine_samples):
  """moments_from_flax for the param groups train/step.create_optimizer
  makes for `stage` (param_labels_for_stage without its "zero" modules)."""
  labels = {m: label for m, label in param_labels_for_stage(
      stage, num_fine_samples).items() if label != "zero"}
  return moments_from_flax(opt_state, labels)


def optimizer_state_to_flax(moments):
  """The inverse of moments_from_flax: {"inner_states": {label:
  {"inner_state": {"0": {"count", "mu", "nu"}, "1": {"count"}}}}} over
  the modules given, in the JAX layout (masked modules left out)."""
  out = {}
  for module, m in moments.items():
    inner = out.setdefault(m["label"], {"inner_state": {
        "0": {"count": np.asarray(m["count"], np.int32), "mu": {}, "nu": {}}}})
    if m["schedule_count"] is not None:
      inner["inner_state"]["1"] = {
          "count": np.asarray(m["schedule_count"], np.int32)}
    for key, name in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
      tree = _state_dict_to_flax(m[name])
      inner["inner_state"]["0"][key].update(tree)
  return {"inner_states": out}


def _state_dict_to_flax(sd):
  """A state_dict subset (params_from_flax's keys) -> the JAX layout."""
  tree = {}
  for key, v in sd.items():
    *path, kind = key.split(".")
    if path[0] == "path_sampler":
      node = tree.setdefault("path_sampler", {}).setdefault("so3_mlp", {})
      name = path[-1]
    else:
      node = tree.setdefault(path[0], {})
      name = f"Dense_{path[-1]}"
    arr = v.detach().cpu().numpy()
    node.setdefault(name, {})["kernel" if kind == "weight" else "bias"] = (
        arr.T.copy() if kind == "weight" else arr.copy())
  return tree
