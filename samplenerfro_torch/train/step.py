"""Losses, Stats, the staged Adam optimizer and the train step.

Counterpart of samplenerfro_tpu/train/step.py:28-259. The loss is the one
the shipped configurations train: photometric MSE of both levels, the
background boundary term, the background smoothness term over an env-ray
patch and the weight-L2 term. The sparsity, beta and normal terms are
gated off by `annealing_rate = 0.0` in the JAX step (:204-206); the port
computes them only where that gate lets them through, which is nowhere,
and refuses configurations whose non-zero weights would need the
boundary-point dataset it does not have yet.

Param groups follow `param_labels_for_stage`: a "zero" group is left out
of the optimizer (optax.set_to_zero), every other group is an Adam group
whose learning rate for update k is its schedule at k, as optax's
scale_by_schedule reads its count before incrementing it.
"""

import dataclasses
import functools
import math

import torch

from samplenerfro_torch.models import nerf
from samplenerfro_torch.ops import math as math_ops


@dataclasses.dataclass
class Stats:
  """Per-step training statistics (samplenerfro_tpu/train/step.py:28-46).

  Fields are 0-d tensors on the model's device (or floats), so that a
  step does not wait for the device; `as_floats` fetches them.
  """
  loss: float
  psnr: float
  loss_c: float
  psnr_c: float
  weight_l2: float
  loss_nrm: float
  loss_sp: float
  annealing_rate: float
  loss_bg: float
  loss_bg_c: float
  loss_bg_smooth: float
  coarse_alpha_target: float
  fine_alpha_target: float
  # The JAX package's out-of-window clamp count; the port's march kernels
  # read the whole grid, so it is always 0.
  march_oow: int = 0

  def as_floats(self):
    return Stats(**{f.name: float(getattr(self, f.name))
                    for f in dataclasses.fields(self)})


def param_labels_for_stage(stage, num_fine_samples):
  """Trainable-module labels per stage (train.py:286-310)."""
  if stage.startswith("radiance"):
    labels = {"path_sampler": "zero",
              "bkgd_mlp": "adam_lr_scheduler",
              "coarse_mlp": "adam_lr_scheduler"}
    if num_fine_samples > 0:
      labels["fine_mlp"] = "adam_lr_scheduler"
  elif stage.startswith("ior"):
    labels = {"path_sampler": "adam_lr_scheduler",
              "bkgd_mlp": "zero",
              "coarse_mlp": "zero",
              "fine_mlp": "zero"}
  elif stage.startswith("all"):
    labels = {"path_sampler": "adam_lr_scheduler",
              "bkgd_mlp": "adam_lr_scheduler",
              "coarse_mlp": "adam_lr_scheduler"}
    if num_fine_samples > 0:
      labels["fine_mlp"] = "adam_lr_scheduler"
  else:
    raise ValueError(f"unknown stage {stage}")
  return labels


def create_optimizer(model, args):
  """Adam over the stage's trainable modules (train.py:286-317).

  Returns (optimizer, learning_rate_fn, learning_rate_fn1). Each param
  group carries its label; `set_learning_rates` sets the groups' rates
  for an update from its count.
  """
  check_supported(args)
  lr_fn = functools.partial(
      math_ops.learning_rate_decay, lr_init=args.lr_init,
      lr_final=args.lr_final, max_steps=args.max_steps,
      lr_delay_steps=args.lr_delay_steps, lr_delay_mult=args.lr_delay_mult)
  lr_fn1 = functools.partial(
      math_ops.learning_rate_decay, lr_init=args.lr_init,
      lr_final=args.lr_final, max_steps=args.max_steps,
      lr_start_steps=args.anneal_delay_steps, lr_delay_steps=0,
      lr_delay_mult=args.lr_delay_mult)
  groups = []
  for name, label in param_labels_for_stage(
      args.stage, args.num_fine_samples).items():
    module = getattr(model, name, None)
    if label == "zero" or module is None:
      continue
    groups.append({"params": list(module.parameters()), "name": name,
                   "label": label})
  rates = {"adam": lambda _: args.lr_init, "adam_lr_scheduler": lr_fn,
           "adam_lr_scheduler1": lr_fn1}
  # optax.adam's defaults; eps is added outside the square root in both.
  optimizer = torch.optim.Adam(groups, lr=0.0, betas=(0.9, 0.999), eps=1e-8)
  optimizer.rates = rates
  return optimizer, lr_fn, lr_fn1


def set_learning_rates(optimizer, count):
  """Rates of update number `count` (0 for the first update)."""
  for group in optimizer.param_groups:
    group["lr"] = optimizer.rates[group["label"]](count)


def _psnr(mse):
  return -10.0 * torch.log(mse) / math.log(10.0)


def weight_l2(model):
  """Mean square of all parameters (train.py:147-153)."""
  params = list(model.parameters())
  sum_sq = sum((p**2).sum() for p in params)
  return sum_sq / sum(p.numel() for p in params)


def check_supported(args):
  """Raise for the stages and loss terms the port does not train yet."""
  if args.stage.startswith("ior"):
    raise NotImplementedError("the 'ior' stage is not ported yet")
  if not (args.stage.startswith("radiance") or args.stage.startswith("all")):
    raise ValueError(f"unknown stage {args.stage}")
  if args.sparsity_weight > 0 and not args.use_online_sparsity:
    raise NotImplementedError("sparsity_weight > 0 needs the boundary-point "
                              "(Grid) dataset, which is not ported yet")
  if args.stage.startswith("all") and (
      args.normal_loss_weight + args.normal_smooth_weight) > 0:
    raise NotImplementedError("the normal losses need the boundary-point "
                              "(Grid) dataset, which is not ported yet")


def loss_fn(model, batch, args, jitter, generator=None):
  """(total loss, Stats) of one batch (samplenerfro_tpu/train/step.py:118-227).

  Args:
    model: NerfModel of a radiance or 'all' stage.
    batch: dict of tensors on the model's device: "rays" (Rays of
      [batch, C]), "pixels" [batch, >=3], "env_rays" (Rays of [p, p, C]
      or None) and "annealed_alpha" (float).
    args: flags namespace.
    jitter: [num_coarse] dense indices of the coarse subsample.
    generator: torch.Generator for the randomized sampling and noise.
  """
  alpha = float(batch["annealed_alpha"])
  gate = 1.0 if alpha > 0 else 0.0
  ret = model(batch["rays"], jitter, randomized=args.randomized,
              generator=generator, annealed_alpha=alpha)
  if len(ret) not in (1, 2):
    raise ValueError("ret should contain 1 (coarse) or 2 (coarse+fine) sets "
                     "of outputs.")
  pixels = batch["pixels"][..., :3]
  rgb, _, _, trans, trans_rgb_bkgd = ret[-1]
  loss = ((rgb - pixels)**2).mean()
  zero = torch.zeros((), dtype=loss.dtype, device=loss.device)
  if args.bg_weight > 0:
    mask_bg = trans > 0.5
    loss_bg = gate * ((mask_bg * (trans_rgb_bkgd - pixels).abs()).sum()
                      / (mask_bg.sum() + 1))
  else:
    loss_bg = zero
  if len(ret) > 1:
    loss_c = ((ret[0][0] - pixels)**2).mean()
    psnr_c = _psnr(loss_c.detach())
  else:
    loss_c, psnr_c = zero, zero

  if args.bg_smooth_weight > 0:
    viewdirs = batch["env_rays"].viewdirs
    ps = viewdirs.shape[0]
    rgb_env = model.forward_envmap(viewdirs.reshape(-1, 3)).reshape(ps, ps,
                                                                    -1)
    loss_bg_smooth = gate * torch.mean(
        0.5 * ((rgb_env[1:, :] - rgb_env[:-1, :])**2).reshape(-1)
        + 0.5 * ((rgb_env[:, 1:] - rgb_env[:, :-1])**2).reshape(-1))
  else:
    loss_bg_smooth = zero

  wl2 = weight_l2(model)
  total = (loss + loss_c + args.bg_weight * loss_bg
           + args.bg_smooth_weight * loss_bg_smooth
           + args.weight_decay_mult * wl2)
  d = lambda x: x.detach()
  stats = Stats(
      loss=d(loss), psnr=_psnr(d(loss)), loss_c=d(loss_c), psnr_c=psnr_c,
      weight_l2=d(wl2), loss_nrm=0.0, loss_sp=0.0, annealing_rate=alpha,
      loss_bg=args.bg_weight * d(loss_bg), loss_bg_c=0.0,
      loss_bg_smooth=d(loss_bg_smooth), coarse_alpha_target=0.0,
      fine_alpha_target=0.0, march_oow=0)
  return total, stats


def clip_gradients(params, args):
  """grad_max_val clipping, then grad_max_norm (step.py:247-254)."""
  grads = [p.grad for p in params if p.grad is not None]
  if args.grad_max_val > 0:
    for g in grads:
      g.clamp_(-args.grad_max_val, args.grad_max_val)
  if args.grad_max_norm > 0:
    norm = torch.sqrt(sum((g**2).sum() for g in grads))
    mult = torch.clamp(args.grad_max_norm / (1e-7 + norm), max=1.0)
    for g in grads:
      g.mul_(mult)


def train_step(model, optimizer, batch, step, args, generator=None,
               jitter=None):
  """One optimizer step; returns its Stats.

  Args:
    model, batch, args, generator: as loss_fn.
    optimizer: create_optimizer's.
    step: the 1-based training step; its update uses the learning rates
      at count step - 1.
    jitter: the coarse subsample (nerf.make_jitter, on the host), as the
      JAX model draws it from its per-step key; None draws it from torch's
      default host generator.
  """
  if jitter is None:
    jitter = nerf.make_jitter(args.num_coarse_samples, args.num_path_samples)
  optimizer.zero_grad(set_to_none=True)
  total, stats = loss_fn(model, batch, args, jitter, generator)
  total.backward()
  clip_gradients(list(model.parameters()), args)
  set_learning_rates(optimizer, step - 1)
  optimizer.step()
  return stats
