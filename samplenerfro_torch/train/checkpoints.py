"""Save and resume training state in the stage directory.

Counterpart of samplenerfro_tpu/train/checkpoints.py's save/restore, with
the same on-disk naming (`<stage_dir>/checkpoint_<step>`, the newest
`keep` kept) but in torch's format: the model's weights (not the IOR grid
buffer, which is rebuilt from the scene), the optimizer's state and the
step. Restoring flax checkpoints is not ported yet.
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


def restore_checkpoint(stage_dir, model, optimizer):
  """Load the newest checkpoint into model and optimizer; returns its step,
  or 0 when the dir holds none."""
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
  optimizer.load_state_dict(state["optimizer"])
  return int(state["step"])
