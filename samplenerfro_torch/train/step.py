"""Losses, Stats, the staged Adam optimizer and the train step.

Counterpart of samplenerfro_tpu/train/step.py:28-259. The radiance and
'all' stages' loss is photometric MSE of both levels, the background
boundary term, the background smoothness term over an env-ray patch and
the weight-L2 term; the `ior` stage's is the weight-L2 term alone. The
sparsity and normal terms, computed on the boundary points of
data/datasets.Grid, are multiplied by `annealing_rate = 0.0` as in the
JAX step (:204-206): they reach the total and Stats as zeros, and their
gradients are zeros. With use_online_sparsity the sparsity term is the
model's online one (models/nerf.py), gated the same way. The beta term is
gated the same way and not computed. So an `ior` step with
weight_decay_mult 0 (every shipped config) leaves every parameter and
Adam moment where it was.

Param groups follow `param_labels_for_stage`: a "zero" group is left out
of the optimizer (optax.set_to_zero), every other group is an Adam group
whose learning rate for update k is its schedule at k, as optax's
scale_by_schedule reads its count before incrementing it.

`make_train_step_multi` is the counterpart of :274-297, K steps a
dispatch: on the card one CUDA graph of K steps, replayed for each window
of K, which runs the same kernels on the same values as K eager steps.
So every per-step value the step reads lives on the device: the batch
carries its annealing alpha, its checked jitter and its learning rates,
the optimizer keeps its counts there, and the noise generator is
registered with the graph.

Under ranks (parallel/mesh.py) a step is the single-process step of the
global batch, as GSPMD makes the JAX step over a sharded batch: each rank
differentiates its share of the global loss (ray means / W, ratios over
all-reduced counts, terms of replicated inputs / W), one all-reduce sums
the gradients before the clipping reads them, and the Stats are the
global batch's. In a captured window the collectives are recorded in the
graph; the eager window before it makes the communicator.
"""

import dataclasses
import functools
import math

import torch

from samplenerfro_torch.data import prefetch
from samplenerfro_torch.ops import math as math_ops
from samplenerfro_torch.parallel import mesh


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

  def per_step(self):
    """The Stats of floats of each step of a stacked Stats (pack_stats),
    fetched from the device in one copy."""
    rows = torch.stack(_fields(self)).cpu()
    return [Stats(*[float(v) for v in col]) for col in rows.t()]


def _fields(stats):
  return [getattr(stats, f.name) for f in dataclasses.fields(stats)]


def pack_stats(stats):
  """K steps' Stats -> one [fields, K] float32 tensor (a Python number
  as its value); Stats(*packed.unbind(0)) is their stacked Stats."""
  dev = stats[0].weight_l2.device
  as_t = lambda v: (v.float() if torch.is_tensor(v) else
                    torch.full((), v, dtype=torch.float32, device=dev))
  return torch.stack([torch.stack([as_t(v) for v in _fields(s)])
                      for s in stats], dim=1)


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


class Adam:
  """optax.adam (samplenerfro_tpu/train/step.py:73-95) over param groups,
  its state on the parameters' device.

  Each update computes, as optax does,
      mu = b1 mu + (1 - b1) g,  nu = b2 nu + (1 - b2) g^2,  count += 1,
      p += -lr * (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)
  with torch._foreach ops, each group's count a 0-d float32 tensor and its
  rate a float32 tensor on the device. So an eager update and one replayed
  from a CUDA graph run the same kernels on the same values.
  torch.optim.Adam rounds its bias corrections as host doubles eagerly and
  as device floats with capturable=True, which would set the two apart.

  A group is a dict of "params", "name" and "label". state_dict() has
  torch.optim's layout (a "step", "exp_avg" and "exp_avg_sq" per
  parameter, "step" the group's count), so checkpoints of either load
  into the other's groups by name.
  """

  def __init__(self, groups, b1=0.9, b2=0.999, eps=1e-8):
    self.param_groups = groups
    self.b1, self.b2, self.eps = b1, b2, eps
    self.state = {}
    self.counts = []
    for group in groups:
      for p in group["params"]:
        self.state[p] = {"exp_avg": torch.zeros_like(p),
                         "exp_avg_sq": torch.zeros_like(p)}
      self.counts.append(torch.zeros((), dtype=torch.float32,
                                     device=group["params"][0].device))

  @torch.no_grad()
  def step(self, lrs):
    """One update of every parameter with a gradient.

    Args:
      lrs: [groups] float32 tensor of the groups' rates on the parameters'
        device (learning_rates).
    """
    b1, b2 = self.b1, self.b2
    for i, group in enumerate(self.param_groups):
      params = [p for p in group["params"] if p.grad is not None]
      if not params:
        continue
      count, lr = self.counts[i], lrs[i]
      grads = [p.grad for p in params]
      mu = [self.state[p]["exp_avg"] for p in params]
      nu = [self.state[p]["exp_avg_sq"] for p in params]
      torch._foreach_mul_(mu, b1)
      torch._foreach_add_(mu, grads, alpha=1 - b1)
      sq = torch._foreach_mul(grads, grads)
      torch._foreach_mul_(nu, b2)
      torch._foreach_add_(nu, sq, alpha=1 - b2)
      count.add_(1)
      update = torch._foreach_div(mu, 1 - torch.pow(b1, count))
      denom = torch._foreach_div(nu, 1 - torch.pow(b2, count))
      torch._foreach_sqrt_(denom)
      torch._foreach_add_(denom, self.eps)
      torch._foreach_div_(update, denom)
      torch._foreach_mul_(update, -lr)
      torch._foreach_add_(params, update)

  def state_dict(self):
    index, state, groups = 0, {}, []
    for group, count in zip(self.param_groups, self.counts):
      ids = []
      for p in group["params"]:
        state[index] = {"step": count, **self.state[p]}
        ids.append(index)
        index += 1
      groups.append({**{k: v for k, v in group.items() if k != "params"},
                     "params": ids})
    return {"state": state, "param_groups": groups}

  def load_state_dict(self, saved):
    """Load a state_dict() of these groups; a group none of whose
    parameters has saved state starts fresh."""
    if len(saved["param_groups"]) != len(self.param_groups):
      raise ValueError(f"{len(saved['param_groups'])} saved groups, "
                       f"{len(self.param_groups)} here")
    for group, count, old in zip(self.param_groups, self.counts,
                                 saved["param_groups"]):
      if len(old["params"]) != len(group["params"]):
        raise ValueError(f"group {group['name']}: {len(old['params'])} "
                         f"saved tensors, {len(group['params'])} here")
      count.zero_()
      for p, idx in zip(group["params"], old["params"]):
        mine = self.state[p]
        theirs = saved["state"].get(idx)
        if theirs is None:
          mine["exp_avg"].zero_()
          mine["exp_avg_sq"].zero_()
          continue
        mine["exp_avg"].copy_(theirs["exp_avg"])
        mine["exp_avg_sq"].copy_(theirs["exp_avg_sq"])
        count.copy_(torch.as_tensor(theirs["step"], dtype=torch.float32))


def create_optimizer(model, args):
  """Adam over the stage's trainable modules (train.py:286-317).

  Returns (optimizer, learning_rate_fn, learning_rate_fn1). Each param
  group carries its label; `learning_rates` lists the groups' rates of an
  update from its count.
  """
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
  optimizer = Adam(groups)
  optimizer.rates = rates
  return optimizer, lr_fn, lr_fn1


def learning_rates(optimizer, count):
  """The groups' rates of update number `count` (0 for the first), in
  group order, as floats."""
  return [optimizer.rates[g["label"]](count) for g in optimizer.param_groups]


def _psnr(mse):
  return -10.0 * torch.log(mse) / math.log(10.0)


def weight_l2(model):
  """Mean square of all parameters (train.py:147-153)."""
  params = list(model.parameters())
  sum_sq = sum((p**2).sum() for p in params)
  return sum_sq / sum(p.numel() for p in params)


# The JAX step's gate on the sparsity, beta and normal terms (:204-206).
ANNEALING_RATE = 0.0


def check_supported(args):
  """Raise ValueError for an unknown stage."""
  if not args.stage.startswith(("radiance", "ior", "all")):
    raise ValueError(f"unknown stage {args.stage}")


def uses_sparsity(args):
  """Whether loss_fn computes the offline sparsity term (its batch then
  carries Grid points)."""
  return (not args.stage.startswith("ior") and args.sparsity_weight > 0
          and not args.use_online_sparsity)


def uses_normals(args):
  """Whether loss_fn computes the normal terms on Grid points."""
  return args.stage.startswith("ior") or (
      args.stage.startswith("all")
      and (args.normal_loss_weight + args.normal_smooth_weight) > 0)


def needs_grid(args):
  """Whether a step's batch carries data/datasets.Grid's "pts" and
  "grads": the `ior` stage, and the terms that read them."""
  return uses_sparsity(args) or uses_normals(args)


def _normal_noise(batch, generator):
  """The smoothness offsets' standard normal draws: the batch's
  "normal_noise" when it has them (a test passes the JAX package's),
  else drawn on the points' device from `generator`."""
  if "normal_noise" in batch:
    return batch["normal_noise"]
  pts = batch["pts"]
  return torch.randn(pts.shape, generator=generator, dtype=pts.dtype,
                     device=pts.device)


def loss_fn(model, batch, args, generator=None):
  """(total loss, Stats) of one batch (samplenerfro_tpu/train/step.py:118-227).

  Args:
    model: NerfModel of args.stage.
    batch: one step's batch (train/loop.step_batch) on the model's device:
      "annealed_alpha" (a 0-d float32 tensor); in the radiance and 'all'
      stages "rays" (Rays of [batch, C]), "pixels" [batch, >=3],
      "env_rays" (Rays of [p, p, C] or None) and "jitter" (a
      march_kernel.CheckedJitter, the coarse subsample's dense indices);
      where needs_grid(args), "pts" and "grads" ([B, 1, 3], a Grid batch),
      and optionally "normal_noise" ([B, 1, 3] standard normal draws of
      the smoothness offsets).
    args: flags namespace.
    generator: torch.Generator on the model's device for the randomized
      sampling, the density noise and the offsets' draws.

  Under W ranks the batch's rays and pixels are this rank's rows, and the
  total is this rank's share of the global batch's loss (the shares sum
  to it); the Stats are the global batch's.
  """
  alpha = batch["annealed_alpha"]
  w = mesh.world()
  # This rank's share of a term that every rank computes alike (replicated
  # inputs) or of a mean over its own rows.
  share = (lambda x: x / w) if w > 1 else (lambda x: x)
  wl2 = weight_l2(model)
  zero = torch.zeros((), dtype=wl2.dtype, device=wl2.device)
  d = lambda x: x.detach() if torch.is_tensor(x) else x
  if args.stage.startswith("ior"):
    # The JAX step computes the smoothness here and drops it; loss_nrm is
    # the normal loss, 0.0.
    normal_loss, _ = model.wrapper_compute_normal_loss_and_smooth(
        batch["pts"], batch["grads"], alpha, _normal_noise(batch, generator))
    total = share(ANNEALING_RATE * normal_loss
                  + args.weight_decay_mult * wl2)
    stats = Stats(
        loss=0.0, psnr=0.0, loss_c=0.0, psnr_c=0.0, weight_l2=d(wl2),
        loss_nrm=ANNEALING_RATE * normal_loss, loss_sp=0.0,
        annealing_rate=alpha, loss_bg=0.0, loss_bg_c=0.0,
        loss_bg_smooth=0.0, coarse_alpha_target=0.0, fine_alpha_target=0.0,
        march_oow=0)
    return total, stats

  pixels = batch["pixels"][..., :3]
  # The background terms count once annealing has begun; a device tensor,
  # so that deciding reads nothing back.
  gate = (alpha > 0).to(torch.float32)
  ret, online_sp = model(batch["rays"], batch["jitter"],
                         randomized=args.randomized, generator=generator,
                         annealed_alpha=alpha)
  if len(ret) not in (1, 2):
    raise ValueError("ret should contain 1 (coarse) or 2 (coarse+fine) sets "
                     "of outputs.")
  rgb, _, _, trans, trans_rgb_bkgd = ret[-1]
  loss = ((rgb - pixels)**2).mean()
  if args.bg_weight > 0:
    mask_bg = trans > 0.5
    loss_bg = gate * ((mask_bg * (trans_rgb_bkgd - pixels).abs()).sum()
                      / (mesh.global_sum(mask_bg.sum()) + 1))
  else:
    loss_bg = zero
  if len(ret) > 1:
    loss_c = ((ret[0][0] - pixels)**2).mean()
    psnr_c = _psnr(loss_c.detach())
  else:
    loss_c, psnr_c = zero, zero

  # With online sparsity the model's own term (its samples' log alpha
  # where |grad n| > 1e-6) takes the offline term's place, gated alike.
  loss_sp, next_cat, next_fat = zero, 0.0, 0.0
  if args.use_online_sparsity:
    loss_sp = online_sp
  elif uses_sparsity(args):
    loss_sp, next_cat, next_fat = model.compute_sparsity_loss(
        batch["pts"], 0.0, 0.0)
  loss_nrm = zero
  if uses_normals(args):
    normal_loss, normal_smooth = model.wrapper_compute_normal_loss_and_smooth(
        batch["pts"], batch["grads"], alpha, _normal_noise(batch, generator))
    loss_nrm = (args.normal_loss_weight * normal_loss
                + args.normal_smooth_weight * normal_smooth)

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

  gated_sp = args.sparsity_weight * ANNEALING_RATE * loss_sp
  gated_nrm = ANNEALING_RATE * loss_nrm
  # The online term is already this rank's share of a ratio; the offline
  # one reads the replicated Grid points.
  sp_share = gated_sp if args.use_online_sparsity else share(gated_sp)
  total = (share(loss) + share(loss_c) + args.bg_weight * loss_bg + sp_share
           + share(gated_nrm) + args.bg_smooth_weight * share(loss_bg_smooth)
           + args.weight_decay_mult * share(wl2))
  s_loss, s_loss_c, s_bg, s_sp = d(loss), d(loss_c), d(loss_bg), d(gated_sp)
  if mesh.active():
    # The rows' terms summed over the ranks in one all-reduce: the means
    # over W, the ratios' shares as they are.
    parts = [s_loss, s_loss_c, s_bg]
    if args.use_online_sparsity:
      parts.append(torch.as_tensor(s_sp, dtype=s_loss.dtype,
                                   device=s_loss.device))
    sums = mesh.global_sum(torch.stack(parts))
    s_loss, s_loss_c, s_bg = sums[0] / w, sums[1] / w, sums[2]
    if args.use_online_sparsity:
      s_sp = sums[3]
    if len(ret) > 1:
      psnr_c = _psnr(s_loss_c)
  stats = Stats(
      loss=s_loss, psnr=_psnr(s_loss), loss_c=s_loss_c, psnr_c=psnr_c,
      weight_l2=d(wl2), loss_nrm=d(gated_nrm), loss_sp=s_sp,
      annealing_rate=alpha, loss_bg=args.bg_weight * s_bg,
      loss_bg_c=0.0, loss_bg_smooth=d(loss_bg_smooth),
      coarse_alpha_target=d(next_cat), fine_alpha_target=d(next_fat),
      march_oow=0)
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


def train_step(model, optimizer, batch, args, generator=None):
  """One optimizer step; returns its Stats.

  Args:
    model, args, generator: as loss_fn.
    optimizer: create_optimizer's.
    batch: as loss_fn's, with "lr", the [groups] rates of this update
      (learning_rates) as a float32 tensor on the model's device.
  """
  # Every parameter's gradient is dropped, the frozen groups' too: the
  # clipping reads them all, as the JAX step's fresh gradients.
  model.zero_grad(set_to_none=True)
  total, stats = loss_fn(model, batch, args, generator)
  total.backward()
  params = list(model.parameters())
  mesh.all_reduce_grads(params)
  clip_gradients(params, args)
  optimizer.step(batch["lr"])
  return stats


class MultiStep:
  """K optimizer steps a dispatch (make_train_step_multi)."""

  def __init__(self, model, optimizer, args, k, generator=None):
    if k < 1:
      raise ValueError(f"steps_per_dispatch must be at least 1, got {k}")
    self.model, self.optimizer, self.args = model, optimizer, args
    self.k, self.generator = k, generator
    self.warm = False
    self.graph = self.static = self.out = self.stream = None
    self.replays = 0

  def _steps(self, batch):
    """The window's steps one by one; their packed Stats (pack_stats)."""
    return pack_stats([
        train_step(self.model, self.optimizer,
                   prefetch.map_tensors(lambda t, i=i: t[i], batch),
                   self.args, self.generator)
        for i in range(batch["annealed_alpha"].shape[0])])

  def _capture(self, batch):
    """Capture K steps reading `static`, a copy of `batch`, into a graph.
    Nothing runs; the kernel wrappers count the launches they record."""
    self.static = prefetch.map_tensors(torch.clone, batch)
    graph = torch.cuda.CUDAGraph()
    if self.generator is not None:
      graph.register_generator_state(self.generator)
    # thread_local: the prefetch thread may pin and copy meanwhile.
    with torch.cuda.graph(graph, stream=self.stream,
                          capture_error_mode="thread_local"):
      out = self._steps(self.static)
    self.graph, self.out = graph, out

  def __call__(self, batch):
    """Run the window of steps that the stacked batch holds ([n, ...]
    leaves, n <= K, as train/loop.host_window makes them); returns their
    Stats stacked ([n] fields)."""
    n = batch["annealed_alpha"].shape[0]
    dev = batch["annealed_alpha"].device
    if dev.type != "cuda":
      return Stats(*self._steps(batch).unbind(0))
    if self.k > 1 and mesh.backend() == "gloo":
      raise ValueError("gloo collectives cannot be captured in a CUDA "
                       "graph: run gloo ranks at steps_per_dispatch 1, or "
                       "use NCCL")
    current = torch.cuda.current_stream(dev)
    if self.stream is None:
      self.stream = torch.cuda.Stream(dev)
    self.stream.wait_stream(current)
    prefetch.map_tensors(lambda t: t.record_stream(self.stream), batch)
    with torch.cuda.stream(self.stream):
      if self.k == 1 or n != self.k or not self.warm:
        # A window shorter than K, and the first full one, which warms
        # every kernel, cache and workspace the capture will meet, run
        # step by step: bit for bit what the graph runs.
        packed = self._steps(batch)
        self.warm = self.warm or n == self.k
      else:
        if self.graph is None:
          self._capture(batch)
        prefetch.map_tensors(lambda s, t: s.copy_(t), self.static, batch)
        self.graph.replay()
        self.replays += 1
        packed = self.out.clone()
    current.wait_stream(self.stream)
    packed.record_stream(current)
    return Stats(*packed.unbind(0))


def make_train_step_multi(model, optimizer, args, k, generator=None):
  """K optimizer steps a dispatch: step(stacked batch) -> stacked Stats.

  Counterpart of samplenerfro_tpu/train/step.py:make_train_step_multi. The
  batch's leaves carry a leading step axis (train/loop.host_window); the
  returned Stats' fields are [n] per-step values. On the card the first
  window of K runs eagerly, step by step, and the next one captures K
  steps as one torch.cuda.CUDAGraph that reads its window from a static
  copy of the stacked batch and writes the [K] Stats; each later window of
  K copies its batch in and replays the graph (the lax.scan over the
  stacked batch). `generator`, the noise generator, is registered with the
  graph, so a replay draws fresh numbers in the eager order. A capture
  that fails raises. A window shorter than K (a resume off the K grid, the
  last one before max_steps), and every window on the CPU, runs step by
  step: bit for bit the same steps. The kernel wrappers count the
  launches of the eager steps and those a capture records, not a replay's:
  `replays` counts the replays.
  """
  return MultiStep(model, optimizer, args, k, generator)
