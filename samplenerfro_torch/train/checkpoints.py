"""Save and resume training state in the stage directory.

Counterpart of samplenerfro_tpu/train/checkpoints.py's save/restore, with
the same on-disk naming (`<stage_dir>/checkpoint_<step>`, the newest
`keep` kept) but in torch's format: the model's weights (not the IOR grid
buffer, which is rebuilt from the scene), the optimizer's state and the
step. `load_stage_weights` is the counterpart of load_stage_variables,
eval's per-stage surgery over these checkpoints.

Both read the newest checkpoint_<step> of a directory whichever package
wrote it, told apart by what is on disk: a directory is the JAX package's
orbax checkpoint, a file that starts as a zip archive ("PK\x03\x04") is
the port's torch.save, any other file a legacy flax msgpack checkpoint
(train/flax_checkpoints.py reads both flax formats, and converts the
reference repo's layout on the fly). A flax TrainState carries its step,
its params (models/convert.params_from_flax) and optax's Adam state
(convert.moments_from_flax) into the model and the port's Adam. Pruning
under `keep` removes old checkpoints of either kind.

Under ranks (parallel/mesh.py) rank 0 writes and prunes, then every rank
waits at a barrier (samplenerfro_tpu/train/checkpoints.py:21-27); every
rank restores, and train/loop.py then gives every rank rank 0's state.
"""

import os

import torch

from samplenerfro_torch.models import convert
from samplenerfro_torch.parallel import mesh
from samplenerfro_torch.train import flax_checkpoints

_GRID = "path_sampler.grid"
_ZIP = b"PK\x03\x04"


def latest_step(stage_dir):
  """Step of the newest checkpoint in the dir, or None."""
  steps = flax_checkpoints.checkpoint_steps(stage_dir)
  return steps[-1][0] if steps else None


def checkpoint_kind(path):
  """"orbax", "torch" or "msgpack": what wrote the checkpoint at path."""
  if os.path.isdir(path):
    return "orbax"
  with open(path, "rb") as f:
    return "torch" if f.read(4) == _ZIP else "msgpack"


def read_flax(path):
  """A flax checkpoint as {"step": int, "params": JAX params tree,
  "opt_state": optax state or None}, a reference-layout one converted
  (it carries no optax state the port reads)."""
  ckpt = flax_checkpoints.restore(path)
  if flax_checkpoints.is_reference_layout(ckpt):
    step, params = flax_checkpoints.convert_reference_checkpoint(ckpt)
    return {"step": step, "params": params, "opt_state": None}
  try:
    return {"step": int(ckpt["step"]), "params": ckpt["params"],
            "opt_state": ckpt.get("opt_state")}
  except (KeyError, TypeError) as e:
    raise ValueError(f"{path}: not a TrainState checkpoint (no step or "
                     f"params: {e})") from e


def save_checkpoint(stage_dir, model, optimizer, step, keep=100):
  """Write checkpoint_<step>, then drop all but the newest `keep`; returns
  its path. Under ranks rank 0 writes (the others return None), and every
  rank leaves once it is written."""
  final = None
  if mesh.rank() == 0:
    final = _write(stage_dir, model, optimizer, step, keep)
  mesh.barrier()
  return final


def _write(stage_dir, model, optimizer, step, keep):
  os.makedirs(stage_dir, exist_ok=True)
  state = {"step": int(step),
           "model": {k: v for k, v in model.state_dict().items()
                     if k != _GRID},
           "optimizer": optimizer.state_dict()}
  final = os.path.join(stage_dir, f"checkpoint_{int(step)}")
  tmp = final + ".tmp"
  torch.save(state, tmp)
  os.replace(tmp, final)
  flax_checkpoints.remove_old(stage_dir, keep)
  return final


def _load_optimizer(optimizer, saved):
  """Load a saved optimizer state whose groups may be another stage's.

  A stage seeded from another stage's checkpoint (tools/validate_quality's
  `all` arm starts in a copy of the radiance stage's directory) has other
  groups: each group of both keeps its Adam state, matched by name, and a
  group the checkpoint lacks (the path sampler's) starts fresh.
  """
  own = optimizer.state_dict()
  names = [g.get("name") for g in own["param_groups"]]
  saved_groups = {g.get("name"): g for g in saved["param_groups"]}
  if names == [g.get("name") for g in saved["param_groups"]]:
    optimizer.load_state_dict(saved)
    return
  state = {}
  for group in own["param_groups"]:
    old = saved_groups.get(group["name"])
    if old is None:
      continue
    if len(old["params"]) != len(group["params"]):
      raise ValueError(f"optimizer group {group['name']} has "
                       f"{len(group['params'])} tensors, the checkpoint's "
                       f"{len(old['params'])}")
    for mine, theirs in zip(group["params"], old["params"]):
      if theirs in saved["state"]:
        state[mine] = saved["state"][theirs]
  optimizer.load_state_dict({"state": state,
                             "param_groups": own["param_groups"]})


def _load_moments(optimizer, model, moments, step):
  """Load convert.moments_from_flax's moments into the port's Adam.

  Each group takes its module's count and moments; a group the
  checkpoint lacks starts fresh, as _load_optimizer starts one. The
  learning rate of update k is read from the step (loop.host_window), so a
  scheduled label's count must be the checkpoint's step, as in every
  state the JAX train step writes.
  """
  names = {p: k for k, p in model.named_parameters()}
  with torch.no_grad():
    for group, count in zip(optimizer.param_groups, optimizer.counts):
      m = moments.get(group["name"])
      if m is None:
        count.zero_()
        for p in group["params"]:
          optimizer.state[p]["exp_avg"].zero_()
          optimizer.state[p]["exp_avg_sq"].zero_()
        continue
      if m["schedule_count"] not in (None, step):
        raise ValueError(f"label {m['label']!r}: the schedule's count "
                         f"{m['schedule_count']} is not the step {step}")
      for p in group["params"]:
        for key in ("exp_avg", "exp_avg_sq"):
          saved = m[key].get(names[p])
          if saved is None or saved.shape != p.shape:
            raise ValueError(
                f"{key} of {names[p]}: the checkpoint has "
                f"{None if saved is None else tuple(saved.shape)}, the "
                f"model {tuple(p.shape)}")
          optimizer.state[p][key].copy_(saved)
      count.fill_(m["count"])


def restore_checkpoint(stage_dir, model, optimizer):
  """Load the newest checkpoint into model and optimizer; returns its step,
  or 0 when the dir holds none. The checkpoint may be another stage's
  (_load_optimizer), and the JAX package's (checkpoint_kind)."""
  steps = flax_checkpoints.checkpoint_steps(stage_dir)
  if not steps:
    return 0
  step, path = steps[-1]
  device = next(model.parameters()).device
  if checkpoint_kind(path) != "torch":
    ckpt = read_flax(path)
    convert.load_into(model, convert.params_from_flax(ckpt["params"]))
    labels = {g["name"]: g["label"] for g in optimizer.param_groups}
    moments = ({} if ckpt["opt_state"] is None else
               convert.moments_from_flax(ckpt["opt_state"], labels))
    _load_moments(optimizer, model, moments, ckpt["step"])
    return ckpt["step"]
  state = torch.load(path, map_location=device, weights_only=True)
  missing, unexpected = model.load_state_dict(state["model"], strict=False)
  if [k for k in missing if k != _GRID] or unexpected:
    raise ValueError(f"checkpoint_{step} does not fit the model: missing "
                     f"{missing}, unexpected {unexpected}")
  _load_optimizer(optimizer, state["optimizer"])
  return int(state["step"])


# The modules a stage's eval takes from a trained checkpoint
# (samplenerfro_tpu/train/checkpoints.py:148-170); the IOR grid buffer is
# rebuilt from the scene.
_RADIANCE_MODULES = ("bkgd_mlp", "coarse_mlp", "fine_mlp")


def _load_modules(model, train_dir, cfg, binding, modules, stage):
  """Copy `modules` of the newest checkpoint under <train_dir>/<cfg's
  binding> into `model`; returns its step (a flax checkpoint's own
  "step", as load_stage_variables returns it)."""
  name = getattr(cfg, binding)
  if name is None:
    raise ValueError(f"Config.{binding} is None: stage {stage!r} takes its "
                     f"weights from <train_dir>/<Config.{binding}>; bind it "
                     "(--gin_param) or pass --params_npz")
  stage_dir = os.path.join(train_dir, name)
  steps = flax_checkpoints.checkpoint_steps(stage_dir)
  if not steps:
    raise FileNotFoundError(f"no checkpoint found under {stage_dir}")
  step, path = steps[-1]
  own = model.state_dict()
  wanted = [k for k in own if k != _GRID
            and k.split(".", 1)[0] in modules]
  if checkpoint_kind(path) == "torch":
    device = next(model.parameters()).device
    saved = torch.load(path, map_location=device,
                       weights_only=True)["model"]
  else:
    ckpt = read_flax(path)
    step = ckpt["step"]
    present = {k.split(".", 1)[0] for k in wanted}
    lacking = sorted(present - set(ckpt["params"]))
    if lacking:
      raise ValueError(f"{path} lacks {lacking}")
    saved = convert.params_from_flax({m: ckpt["params"][m] for m in present})
  missing = [k for k in wanted if k not in saved]
  if missing:
    raise ValueError(f"{path} lacks {missing}")
  with torch.no_grad():
    for k in wanted:
      own[k].copy_(saved[k])
  return int(step)


def load_stage_weights(model, train_dir, cfg, stage):
  """Copy a stage's trained weights into `model`; returns the checkpoint's
  step.

  `radiance*` takes bkgd_mlp, coarse_mlp and (when the model has one)
  fine_mlp from <train_dir>/<cfg.radiance_weight_name>; `ior*` takes
  those from there too and path_sampler from <train_dir>/
  <cfg.ior_weight_name>, and returns the latter's step; `all*` takes all
  four from <train_dir>/<cfg.all_weight_name>; each from its newest
  checkpoint_<step>, the port's or the JAX package's (a reference-layout
  one converted).

  Raises:
    ValueError: a weight name the stage reads is None (every shipped gin
      sets Config.radiance_weight_name = None and Config.ior_weight_name =
      None), or the stage is unknown.
    FileNotFoundError: a directory holds no checkpoint.
  """
  if stage.startswith(("radiance", "ior")):
    step = _load_modules(model, train_dir, cfg, "radiance_weight_name",
                         _RADIANCE_MODULES, stage)
    if stage.startswith("ior"):
      step = _load_modules(model, train_dir, cfg, "ior_weight_name",
                           ("path_sampler",), stage)
    return step
  if stage.startswith("all"):
    return _load_modules(model, train_dir, cfg, "all_weight_name",
                         _RADIANCE_MODULES + ("path_sampler",), stage)
  raise ValueError(f"unknown stage {stage}")
