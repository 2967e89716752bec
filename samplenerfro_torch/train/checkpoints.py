"""Save and resume training state in the stage directory.

Counterpart of samplenerfro_tpu/train/checkpoints.py's save/restore, with
the same on-disk naming (`<stage_dir>/checkpoint_<step>`, the newest
`keep` kept) but in torch's format: the model's weights (not the IOR grid
buffer, which is rebuilt from the scene), the optimizer's state and the
step. `load_stage_weights` is the counterpart of load_stage_variables,
eval's per-stage surgery over these checkpoints. Restoring flax
checkpoints is not ported yet.
"""

import os
import re

import torch

_NAME = re.compile(r"^checkpoint_(\d+)$")
_GRID = "path_sampler.grid"


def _steps(stage_dir):
  if not os.path.isdir(stage_dir):
    return []
  return sorted(int(m.group(1)) for m in map(_NAME.match,
                                             os.listdir(stage_dir)) if m)


def latest_step(stage_dir):
  """Step of the newest checkpoint in the dir, or None."""
  steps = _steps(stage_dir)
  return steps[-1] if steps else None


def save_checkpoint(stage_dir, model, optimizer, step, keep=100):
  """Write checkpoint_<step>, then drop all but the newest `keep`."""
  os.makedirs(stage_dir, exist_ok=True)
  state = {"step": int(step),
           "model": {k: v for k, v in model.state_dict().items()
                     if k != _GRID},
           "optimizer": optimizer.state_dict()}
  final = os.path.join(stage_dir, f"checkpoint_{int(step)}")
  tmp = final + ".tmp"
  torch.save(state, tmp)
  os.replace(tmp, final)
  for old in _steps(stage_dir)[:-keep]:
    os.remove(os.path.join(stage_dir, f"checkpoint_{old}"))
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


def restore_checkpoint(stage_dir, model, optimizer):
  """Load the newest checkpoint into model and optimizer; returns its step,
  or 0 when the dir holds none. The checkpoint may be another stage's
  (_load_optimizer)."""
  step = latest_step(stage_dir)
  if step is None:
    return 0
  device = next(model.parameters()).device
  state = torch.load(os.path.join(stage_dir, f"checkpoint_{step}"),
                     map_location=device, weights_only=True)
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
  binding> into `model`; returns its step."""
  name = getattr(cfg, binding)
  if name is None:
    raise ValueError(f"Config.{binding} is None: stage {stage!r} takes its "
                     f"weights from <train_dir>/<Config.{binding}>; bind it "
                     "(--gin_param) or pass --params_npz")
  stage_dir = os.path.join(train_dir, name)
  step = latest_step(stage_dir)
  if step is None:
    raise FileNotFoundError(f"no checkpoint found under {stage_dir}")
  device = next(model.parameters()).device
  saved = torch.load(os.path.join(stage_dir, f"checkpoint_{step}"),
                     map_location=device, weights_only=True)["model"]
  own = model.state_dict()
  wanted = [k for k in own if k != _GRID
            and k.split(".", 1)[0] in modules]
  missing = [k for k in wanted if k not in saved]
  if missing:
    raise ValueError(f"{stage_dir}/checkpoint_{step} lacks {missing}")
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
  checkpoint_<step>.

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
