"""The flax side of samplenerfro_tpu/train/checkpoints.py, without flax.

`restore(path)` reads what `flax.training.checkpoints.restore_checkpoint(
path, None)` reads, and gives the same nested dict of numpy arrays and
Python scalars:

  * an orbax checkpoint directory (`_METADATA` beside an OCDBT database:
    what the JAX package's save_checkpoint writes), through train/ocdbt.py;
  * a legacy flax msgpack file (what flax writes with orbax off, and the
    original SampleNeRFRO's release checkpoints), through
    utils/flax_msgpack.py;
  * a stage directory: its newest `checkpoint_<step>` (numerically, as
    flax's natural sort orders them), leaving out flax's and orbax's
    temporary entries (`checkpoint_tmp`, `*.orbax-checkpoint-tmp*`).

The reference repo's layout (TrainState.params = the whole variables
dict, the so3 head under path_sampler/scan/idx_model/so3_mlp) converts to
the JAX package's and back as its checkpoints.py does (:42-118);
`export_reference_checkpoint` writes it as a legacy msgpack file, which
the JAX package and the original code both restore.
"""

import os
import re
import shutil

from samplenerfro_torch.train import ocdbt
from samplenerfro_torch.utils import flax_msgpack

_NAME = re.compile(r"^checkpoint_(\d+)$")
# flax's checkpoints._is_orbax_checkpoint: any of these names in a
# directory makes it an orbax checkpoint.
_ORBAX_FILES = ("checkpoint", "_METADATA", "manifest.ocdbt")


def checkpoint_steps(stage_dir):
  """[(step, path)] of the checkpoint_<step> entries of a directory,
  oldest first; temporary entries do not match."""
  if not os.path.isdir(stage_dir):
    return []
  found = [(int(m.group(1)), os.path.join(stage_dir, m.group(0)))
           for m in map(_NAME.match, os.listdir(stage_dir)) if m]
  return sorted(found)


def is_orbax_checkpoint(path):
  return os.path.isdir(path) and any(
      os.path.exists(os.path.join(path, f)) for f in _ORBAX_FILES)


def restore(path):
  """A flax checkpoint as a nested dict, or None when `path` does not
  exist or is a directory without checkpoints (flax then returns its
  target, None).

  Raises:
    ValueError: the checkpoint is in neither format, or is damaged (the
      message names the file).
  """
  path = os.path.abspath(path)
  if not os.path.exists(path):
    return None
  if os.path.isdir(path) and not is_orbax_checkpoint(path):
    found = checkpoint_steps(path)
    if not found:
      return None
    path = found[-1][1]
  if os.path.isdir(path):
    if not os.path.exists(os.path.join(path, "_METADATA")):
      raise ValueError(f"{path}: an orbax checkpoint without _METADATA "
                       "(an older orbax layout, not read)")
    return ocdbt.restore_orbax(path)
  with open(path, "rb") as f:
    return flax_msgpack.unpackb(f.read(), where=path)


def is_reference_layout(ckpt):
  """True if `ckpt` is a reference-repo checkpoint: a double "params"
  nesting (ckpt["params"]["params"][...]) over the radiance MLPs or the
  path sampler (samplenerfro_tpu/train/checkpoints.py:42-58)."""
  try:
    inner = ckpt["params"]["params"]
  except (KeyError, TypeError):
    return False
  return isinstance(inner, dict) and (
      "coarse_mlp" in inner or "path_sampler" in inner)


def convert_reference_params(inner):
  """A reference params/params subtree in the JAX package's layout: the
  radiance MLPs as they are, the so3 head flattened to
  path_sampler/so3_mlp with its last Dense_<i> renamed Dense_out."""
  out = {k: inner[k]
         for k in ("bkgd_mlp", "coarse_mlp", "fine_mlp") if k in inner}
  if "path_sampler" in inner:
    so3 = inner["path_sampler"]["scan"]["idx_model"]["so3_mlp"]
    idxs = sorted(int(k.split("_", 1)[1]) for k in so3)
    last = f"Dense_{idxs[-1]}"
    converted = {k: v for k, v in so3.items() if k != last}
    converted["Dense_out"] = so3[last]
    out["path_sampler"] = {"so3_mlp": converted}
  return out


def convert_reference_checkpoint(ckpt):
  """Reference checkpoint dict -> (step, params tree in our layout)."""
  return int(ckpt["step"]), convert_reference_params(ckpt["params"]["params"])


def export_reference_params(params):
  """The inverse of convert_reference_params: path_sampler/so3_mlp
  re-nested under path_sampler/scan/idx_model/so3_mlp with Dense_out
  renamed back to the last Dense_<i>."""
  out = {k: params[k]
         for k in ("bkgd_mlp", "coarse_mlp", "fine_mlp") if k in params}
  if "path_sampler" in params:
    so3 = dict(params["path_sampler"]["so3_mlp"])
    idxs = [int(k.split("_", 1)[1]) for k in so3 if k != "Dense_out"]
    so3[f"Dense_{max(idxs) + 1}"] = so3.pop("Dense_out")
    out["path_sampler"] = {"scan": {"idx_model": {"so3_mlp": so3}}}
  return out


def export_reference_checkpoint(out_dir, params, step, keep=100):
  """Write <out_dir>/checkpoint_<step>, a legacy flax msgpack file of
  {"step", "params": {"params": reference layout}} (the layout the
  reference's eval surgery reads), byte for byte what flax's legacy
  save_checkpoint writes for it, then drop all but the newest `keep`
  checkpoints. Returns the file's path.

  Args:
    params: the JAX package's params tree (convert.params_to_flax of the
      port's model), numpy leaves.
  """
  out_dir = os.path.abspath(out_dir)
  os.makedirs(out_dir, exist_ok=True)
  ckpt = {"step": int(step),
          "params": {"params": export_reference_params(params)}}
  final = os.path.join(out_dir, f"checkpoint_{int(step)}")
  tmp = os.path.join(out_dir, "checkpoint_tmp")
  with open(tmp, "wb") as f:
    f.write(flax_msgpack.packb(ckpt))
  if os.path.isdir(final):  # overwrite, as flax does
    remove(final)
  os.replace(tmp, final)
  remove_old(out_dir, keep)
  return final


def remove_old(stage_dir, keep):
  """Drop all but the newest `keep` checkpoint_<step> entries, files or
  (orbax) directories alike, as flax's `keep` does."""
  for _, old in checkpoint_steps(stage_dir)[:-keep]:
    remove(old)


def remove(path):
  """Remove a checkpoint: a file, or an orbax directory."""
  if os.path.isdir(path):
    shutil.rmtree(path)
  else:
    os.remove(path)
