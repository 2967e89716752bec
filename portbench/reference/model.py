"""Plain PyTorch reference of the refractive NeRF's train step and render.

Written from the model's equations (a voxel IOR grid whose gradient bends
each ray by Euler steps of the eikonal equation, an so3 head that rotates
that gradient, coarse and fine NerfMLPs composited along the curved path, a
background MLP, photometric and background losses, Adam), in float32 with
TF32 off, one Python loop over the march's steps under autograd. It imports
nothing of the program it checks: it derives the prefiltered grid, its
gradient, the rays and every batch again from the raw inputs the benchmark
made (portbench/reference/scene.py).

`Prec` names the rounding of each product, by part of the model: its
operands in the forward pass and the cotangent of its result in the
backward, as a product at that precision rounds both. The reference runs
with none; the control (a lower precision than the configuration states)
rounds the bf16 parts to fp8 and the fp32 parts to TF32, as
`control_prec` builds it; `config_prec` rounds to the configuration's own
bf16, a witness of what that rounding alone does.
"""

import copy
import dataclasses
import math
import sys

import numpy as np
import torch
import torch.nn.functional as F

SO3_MAX_DEG = 10
RGB_PADDING = 0.001
SIGMA_BIAS = -1.0
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def fp8(x):
  """x rounded to float8 e4m3 at a per-tensor scale (amax to 448)."""
  s = x.abs().amax().clamp(min=1e-30) / 448.0
  return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s


def tf32(x):
  """x rounded to TF32's 10-bit mantissa (to nearest, ties away)."""
  bits = x.contiguous().view(torch.int32)
  return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def bf16(x):
  """x rounded to bfloat16 (to nearest even)."""
  return x.to(torch.bfloat16).to(x.dtype)


class _RoundCotangent(torch.autograd.Function):
  """The identity, whose backward rounds the cotangent by `rnd`."""

  @staticmethod
  def forward(ctx, y, rnd):
    ctx.rnd = rnd
    return y.view_as(y)

  @staticmethod
  def backward(ctx, g):
    return ctx.rnd(g), None


def operand(rnd, x):
  """x rounded by rnd (None: as it is) in the forward pass; its cotangent
  passes through."""
  if rnd is None:
    return x
  r = rnd(x.detach())
  return x + (r - x).detach() if x.requires_grad else r


def cotangent(rnd, y):
  """y, its cotangent rounded by rnd in the backward pass."""
  if rnd is None or not y.requires_grad:
    return y
  return _RoundCotangent.apply(y, rnd)


def linear(x, w, b, rnd):
  """x W^T + b, the product's operands and its result's cotangent rounded
  by rnd, the bias added after in float32."""
  if rnd is None:
    return F.linear(x, w, b)
  return cotangent(rnd, F.linear(operand(rnd, x), operand(rnd, w))) + b


@dataclasses.dataclass(frozen=True)
class Prec:
  """The rounding of the products (None: float32), by part of the model."""
  mlp: object = None     # coarse and fine NerfMLPs
  bkgd: object = None    # the background MLP
  head: object = None    # the so3 head
  interp: object = None  # the march's trilinear weights and corners


def _bf16_parts(cfg, render):
  flags = cfg["flags"]
  return {"mlp": flags.get("mlp_dtype") == "bfloat16" and not render,
          "bkgd": False,
          "head": flags.get("march_bwd_dtype") == "bfloat16",
          "interp": flags.get("march_interp", "highest") != "highest"}


def control_prec(cfg, render=False):
  """One step below each precision the configuration states: fp8 where it
  states bf16, TF32 where it states fp32."""
  return Prec(**{k: fp8 if v else tf32
                 for k, v in _bf16_parts(cfg, render).items()})


def config_prec(cfg, render=False):
  """The configuration's own rounding: bf16 where it states bf16, float32
  elsewhere."""
  return Prec(**{k: bf16 if v else None
                 for k, v in _bf16_parts(cfg, render).items()})


# ---------------------------------------------------------------- the grid


class Spec:
  """A cubic voxel grid's lattice: ndim points from nmin to nmax."""

  def __init__(self, ndim, nmin, nmax):
    self.ndim = tuple(int(n) for n in ndim)
    self.nmin = tuple(float(v) for v in nmin)
    self.nmax = tuple(float(v) for v in nmax)
    self.ndelta = tuple((self.nmax[i] - self.nmin[i]) / (self.ndim[i] - 1.0)
                        for i in range(3))


def prefilter(values, ndim, size, sigma):
  """Edge-padded isotropic Gaussian blur of a scalar grid, [N^3] -> [N^3]."""
  h = size // 2
  v = F.pad(values.reshape(1, 1, *ndim).float(), (h,) * 6, mode="replicate")
  a = torch.arange(-h, h + 1, dtype=torch.float32, device=values.device)
  k1 = torch.exp(-a**2 / (2.0 * sigma**2))
  k = k1[:, None, None] * k1[None, :, None] * k1[None, None, :]
  k = (k / k.sum())[None, None]
  return F.conv3d(v, k).reshape(-1)


def grid_data(spec, values):
  """[N^3, 4] of n and its central-difference gradient (edges
  replicated)."""
  v = F.pad(values.reshape(1, 1, *spec.ndim), (1,) * 6,
            mode="replicate")[0, 0]
  d = [(v[2:, 1:-1, 1:-1] - v[:-2, 1:-1, 1:-1]) / (2 * spec.ndelta[0]),
       (v[1:-1, 2:, 1:-1] - v[1:-1, :-2, 1:-1]) / (2 * spec.ndelta[1]),
       (v[1:-1, 1:-1, 2:] - v[1:-1, 1:-1, :-2]) / (2 * spec.ndelta[2])]
  return torch.cat([values.reshape(-1, 1),
                    torch.stack(d, -1).reshape(-1, 3)], -1).contiguous()


_CORNERS = [(x, y, z) for z in (0, 1) for y in (0, 1) for x in (0, 1)]


def lattice(spec, device):
  """The constants trilinear reads, made once (a CUDA graph cannot
  capture their copies from the host)."""
  t = lambda v: torch.tensor(v, device=device)
  off = t(_CORNERS)
  return (spec, t(spec.nmin), t(spec.ndelta), t(spec.ndim) - 1, off,
          off.bool())


def trilinear(lat, data, pts, q=None):
  """Clamp-to-edge trilinear interpolation of data [N^3, C] at pts [B, 3]:
  the 8 corners' weighted sum, a product rounded by q."""
  spec, nmin, ndelta, hi, off, upper = lat
  c = (pts - nmin) / ndelta
  c0 = torch.floor(c)
  f = c - c0
  idx = torch.minimum(torch.clamp(c0.long()[:, None, :] + off, min=0), hi)
  ny, nz = spec.ndim[1], spec.ndim[2]
  flat = (idx[..., 0] * ny + idx[..., 1]) * nz + idx[..., 2]
  corners = data[flat]                                        # [B, 8, C]
  sel = lambda a: torch.where(upper[:, a], f[:, None, a], 1 - f[:, None, a])
  w = sel(0) * sel(1) * sel(2)
  return cotangent(q, (operand(q, w)[..., None] * operand(q, corners)).sum(1))


# ------------------------------------------------------------ the so3 head


def easing_window(alpha, num_bands):
  """The annealed PE's cosine window over bands 0..num_bands-1."""
  bands = torch.arange(num_bands, dtype=torch.float32, device=alpha.device)
  x = torch.clamp(alpha - bands, 0.0, 1.0)
  return 0.5 * (1 + torch.cos(math.pi * x + math.pi))


def so3_encoding(alpha, device):
  """(scales [10, 1], window [10, 1]) of the head's annealed encoding."""
  scales = 2.0**torch.arange(SO3_MAX_DEG, dtype=torch.float32, device=device)
  return (scales[:, None],
          easing_window(alpha * SO3_MAX_DEG, SO3_MAX_DEG)[:, None])


def so3_embed(p, enc):
  """[B, 60]: per degree d, sin(p 2^d) and sin(p 2^d + pi/2), windowed."""
  scales, win = enc
  xb = p[:, None, :] * scales
  feat = torch.cat([torch.sin(xb) * win, torch.sin(xb + 0.5 * math.pi) * win],
                   -1)
  return feat.reshape(p.shape[0], -1)


def skip_mlp(layers, x, skip, q, act=torch.relu):
  """Hidden layers (W, b) with act, the input concatenated after every
  skip-th one past the first; returns the last hidden activation."""
  inputs = x
  for i, (w, b) in enumerate(layers):
    x = act(linear(x, w, b, q))
    if i % skip == 0 and i > 0:
      x = torch.cat([x, inputs], -1)
  return x


def rodrigues(raw, g):
  """g rotated about raw's axis by |raw| (norms floored at 1e-3)."""
  safe = lambda v: torch.sqrt(torch.clamp((v**2).sum(-1, keepdim=True),
                                          min=1e-6))
  theta = safe(raw)
  e = raw / theta
  a = safe(g)
  v = g / a
  cos_t = torch.cos(theta)
  return a * (cos_t * v + torch.sin(theta) * torch.cross(e, v, dim=-1)
              + (1 - cos_t) * (e * v).sum(-1, keepdim=True) * e)


def so3_refine(params, p, g, enc, q):
  pre = "path_sampler.so3_mlp.layers."
  hidden = [(params[f"{pre}Dense_{i}.weight"], params[f"{pre}Dense_{i}.bias"])
            for i in range(4)]
  h = skip_mlp(hidden, so3_embed(p, enc), 2, q)
  raw = linear(h, params[f"{pre}Dense_out.weight"],
               params[f"{pre}Dense_out.bias"], q)
  return rodrigues(raw, g)


# -------------------------------------------------------------- the march


def march(lat, data, o, d, near, num_samples, h, params=None, alpha=None,
          prec=Prec()):
  """Euler steps of the eikonal ODE from o + near d through the grid of
  `lat` (lattice()); with params, the so3 head refines the gradient where
  |grad n| > 1e-3. alpha: the annealing, a 0-d tensor. Returns (pos, raw
  dir, arclength, grad n), each [B, S, .], the state before each step."""
  rp, rd = o + near * d, d
  rt = torch.full(o.shape[:1], near, device=o.device)
  hs = torch.full((), h, device=o.device)
  enc = so3_encoding(alpha, o.device) if params is not None else None
  pos, dirs, dist, grads = [], [], [], []
  for _ in range(num_samples):
    ng = trilinear(lat, data, rp, prec.interp)
    n, g = ng[:, :1], ng[:, 1:]
    step = g
    if params is not None:
      active = torch.linalg.norm(g, dim=-1, keepdim=True) > 1e-3
      step = torch.where(active, so3_refine(params, rp, g, enc, prec.head),
                         g)
    pos.append(rp)
    dirs.append(rd)
    dist.append(rt)
    grads.append(g)
    nrp = rp + hs / n * rd
    rd = rd + h * step
    rt = rt + torch.sqrt(((rp - nrp)**2).sum(-1))
    rp = nrp
  return (torch.stack(pos, 1), torch.stack(dirs, 1), torch.stack(dist, 1),
          torch.stack(grads, 1))


# -------------------------------------------------------------- the MLPs


def pos_enc(x, deg):
  """[x, sin(x 2^d), sin(x 2^d + pi/2)], degree-major, xyz-minor."""
  scales = 2.0**torch.arange(deg, dtype=torch.float32, device=x.device)
  xb = (x[..., None, :] * scales[:, None]).reshape(*x.shape[:-1], -1)
  return torch.cat([x, torch.sin(torch.cat([xb, xb + 0.5 * math.pi], -1))],
                   -1)


def nerf_mlp(params, name, cfg, x, cond, q):
  """The NerfMLP: (raw rgb, raw sigma) of [R, F] points, [R, C] views."""
  f = cfg["flags"]
  depth = f["net_depth"]
  layer = lambda i: (params[f"{name}.layers.{i}.weight"],
                     params[f"{name}.layers.{i}.bias"])
  lin = lambda i, h: linear(h, *layer(i), q)
  h = skip_mlp([layer(i) for i in range(depth)], x, f["skip_layer"], q)
  raw_sigma = lin(depth, h)
  h = torch.cat([lin(depth + 1, h), cond], -1)
  k = depth + 2
  for _ in range(f["net_depth_condition"]):
    h = torch.relu(lin(k, h))
    k += 1
  return lin(k, h), raw_sigma


def bkgd_mlp(params, x, q):
  layers = [(params[f"bkgd_mlp.layers.{i}.weight"],
             params[f"bkgd_mlp.layers.{i}.bias"]) for i in range(4)]
  h = skip_mlp(layers, x, 2, q)
  return linear(h, params["bkgd_mlp.layers.4.weight"],
                params["bkgd_mlp.layers.4.bias"], q)


def colour(raw):
  return torch.sigmoid(raw) * (1 + 2 * RGB_PADDING) - RGB_PADDING


# ------------------------------------------------------------- rendering


def composite(rgb, sigma, t, dirs, bkgd, mask=None):
  """Transmittance compositing: (rgb, distance, acc, weights, trans_last,
  trans_last * bkgd)."""
  dt = torch.cat([t[:, 1:] - t[:, :-1], torch.full_like(t[:, :1], 1e-3)], -1)
  dd = sigma[..., 0] * dt * torch.linalg.norm(dirs, dim=-1)
  if mask is not None:
    dd = dd * mask
  alpha = 1 - torch.exp(-dd)
  trans = torch.exp(-torch.cat([torch.zeros_like(dd[:, :1]),
                                torch.cumsum(dd, -1)], -1))
  w = alpha * trans[:, :-1]
  comp = (w[..., None] * rgb).sum(1)
  if bkgd is not None:
    comp = comp + trans[:, -1:] * bkgd
  else:
    bkgd = torch.ones_like(comp)
  acc = w.sum(-1)
  dist = torch.nan_to_num((w * t).sum(-1) / acc, nan=float("inf"))
  dist = torch.clamp(dist, t[:, 0], t[:, -1])
  return comp, dist, acc, w, trans[:, -1:], trans[:, -1:] * bkgd.detach()


def fine_arclengths(bins, weights, z_coarse, n, noise):
  """Inverse-CDF samples of the coarse weights' piecewise-constant PDF
  over the bins' midpoints, merged with the coarse arclengths, sorted.
  noise: [B, n] uniform draws that stratify them, or None (evenly
  spaced)."""
  eps32 = torch.finfo(torch.float32).eps
  wsum = weights.sum(-1, keepdim=True)
  pad = torch.clamp(1e-5 - wsum, min=0)
  weights = weights + pad / weights.shape[-1]
  pdf = weights / (wsum + pad)
  cdf = torch.clamp(torch.cumsum(pdf[:, :-1], -1), max=1)
  cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf,
                   torch.ones_like(cdf[:, :1])], -1)
  b = cdf.shape[0]
  if noise is not None:
    u = torch.arange(n, dtype=torch.float32, device=bins.device) / n
    u = u + noise * (1 / n - eps32)
    u = torch.clamp(u, max=1 - eps32)
  else:
    u = torch.linspace(0, 1 - eps32, n, device=bins.device).expand(b, n)
  mask = u[:, None, :] >= cdf[:, :, None]

  def bracket(x):
    lo = torch.where(mask, x[:, :, None], x[:, :1, None]).amax(1)
    hi = torch.where(~mask, x[:, :, None], x[:, -1:, None]).amin(1)
    return lo, hi

  b0, b1 = bracket(bins)
  c0, c1 = bracket(cdf)
  t = torch.clamp(torch.nan_to_num((u - c0) / (c1 - c0), nan=0.0), 0, 1)
  z = b0 + t * (b1 - b0)
  return torch.sort(torch.cat([z_coarse, z], -1), -1).values


def on_path(z, pos, dirs, dist):
  """Samples at arclengths z placed on the dense path: from the last
  vertex before each, along its direction."""
  k = torch.clamp(torch.searchsorted(dist.contiguous(), z.contiguous()) - 1,
                  0, dist.shape[1] - 1)
  take = lambda a: torch.gather(a, 1, k[..., None].expand(-1, -1, 3))
  return take(pos) + take(dirs) * (z - torch.gather(dist, 1, k))[..., None], (
      take(dirs))


def unit(v):
  return v / torch.sqrt(torch.clamp((v**2).sum(-1, keepdim=True), min=1e-6))


def cut_mask(box, pos):
  """1 from a path's first sample inside the box to its end."""
  lo, hi = box
  inside = torch.ones(pos.shape[:-1], dtype=torch.bool, device=pos.device)
  for a in range(3):
    inside = inside & (pos[..., a] >= lo[a]) & (pos[..., a] <= hi[a])
  return (torch.cumsum(inside.flip(-1).int(), -1) > 0).flip(-1).float()


def trace_paths(scene, params, origins, viewdirs, alpha, prec=Prec()):
  """The dense paths of rays (origins, viewdirs [B, 3]): (pos, unit dirs,
  arclength), [B, S, .] each; the so3 head bends them in the 'all' stage."""
  f = scene.cfg["flags"]
  s = f["num_coarse_samples"] * f["num_path_samples"]
  h = (f["far"] - f["near"]) / (s - 1)
  head = params if scene.stage == "all" else None
  pos, rdir, dist, _ = march(scene.lat, scene.data, origins, viewdirs,
                             f["near"], s, h, head, alpha, prec)
  return pos, unit(rdir), dist.detach()


def shade(scene, params, paths, jitter, noise, prec=Prec()):
  """Both levels of rays marched along `paths` (trace_paths'): [(rgb,
  distance, acc, trans_last, trans_last * bkgd)], coarse then fine.
  jitter: [Nc] dense indices of the coarse samples; noise: the fine
  samples' draws (fine_arclengths)."""
  cfg = scene.cfg
  f = cfg["flags"]
  pos, dirs, dist = paths
  pc, dc, tc = (torch.index_select(a, 1, jitter) for a in (pos, dirs, dist))
  venc = pos_enc(dc, f["deg_view"])
  bkgd = colour(bkgd_mlp(params, venc[:, -1], prec.bkgd))

  def level(name, p, d):
    b, n = p.shape[:2]
    raw_rgb, raw_sigma = nerf_mlp(
        params, name, cfg, pos_enc(p, f["max_deg_point"]).reshape(b * n, -1),
        pos_enc(d, f["deg_view"]).reshape(b * n, -1), prec.mlp)
    return (colour(raw_rgb).reshape(b, n, 3),
            F.softplus(raw_sigma + SIGMA_BIAS).reshape(b, n, 1))

  rgb, sigma = level("coarse_mlp", pc, dc)
  comp, dd, acc, w, tr, trb = composite(rgb, sigma, tc, dc, bkgd)
  ret = [(comp, dd, acc, tr, trb)]
  with torch.no_grad():
    z = fine_arclengths(0.5 * (tc[:, 1:] + tc[:, :-1]), w[:, 1:-1], tc,
                        f["num_fine_samples"], noise)
    pf, df = on_path(z, pos, dirs, dist)
  rgb, sigma = level("fine_mlp", pf, df)
  comp, dd, acc, w, tr, trb = composite(rgb, sigma, z, df, bkgd)
  if scene.cut_box is not None:
    m = cut_mask(scene.cut_box, pf)
    tr = composite(rgb, sigma, z, df, None, m)[4]
    trb = tr * composite(rgb, sigma, z, df, bkgd, 1.0 - m)[0]
  ret.append((comp, dd, acc, tr, trb))
  return ret


# ------------------------------------------------------------- training


def lr_at(step, f):
  """The log-lerp learning rate with its delayed warm-up, at `step`."""
  f32 = np.float32
  step = f32(step)
  delay = f32(f["lr_delay_mult"]) + (f32(1) - f32(f["lr_delay_mult"])) * (
      np.sin(f32(0.5 * np.pi) * np.clip(step / f32(f["lr_delay_steps"]),
                                        f32(0), f32(1))))
  t = np.clip(step / f32(f["max_steps"]), f32(0), f32(1))
  lerp = np.exp(np.log(f32(f["lr_init"])) * (f32(1) - t)
                + np.log(f32(f["lr_final"])) * t)
  return float(f32(f32(np.clip(step, 0, 1)) * delay * lerp))


def annealed_alpha(step, f):
  return float(np.float32(max(step - f["anneal_delay_steps"], 0))
               / np.float32(f["anneal_max_steps"] - f["anneal_delay_steps"]))


def trained_names(params, stage):
  """The leaves Adam updates: every one in 'all', all but the so3 head's
  in 'radiance'."""
  return [k for k in params
          if stage == "all" or not k.startswith("path_sampler.")]


def loss(scene, params, batch, alpha, prec=Prec(), keep=None):
  """(total, fine photometric loss) of one batch; alpha the annealing, a
  0-d tensor. keep: rows of the batch that count (all by default). The
  batch's "noise" stratifies the fine samples where the configuration is
  randomized."""
  f = scene.cfg["flags"]
  paths = trace_paths(scene, params, batch["origins"], batch["viewdirs"],
                      alpha, prec)
  ret = shade(scene, params, paths, batch["jitter"],
              batch["noise"] if f["randomized"] else None, prec)
  pix = batch["pixels"]
  rows = slice(None) if keep is None else keep
  rgb, _, _, trans, trb = ret[-1]
  mse = ((rgb[rows] - pix[rows])**2).mean()
  mse_c = ((ret[0][0][rows] - pix[rows])**2).mean()
  gate = (alpha > 0).float()
  mask = (trans[rows] > 0.5).float()
  loss_bg = gate * (mask * (trb[rows] - pix[rows]).abs()).sum() / (
      mask.sum() + 1)
  env = batch["env_viewdirs"]
  p = env.shape[0]
  rgb_env = colour(bkgd_mlp(params, pos_enc(env.reshape(-1, 3),
                                            f["deg_view"]), prec.bkgd))
  rgb_env = rgb_env.reshape(p, p, 3)
  smooth = gate * torch.mean(
      0.5 * ((rgb_env[1:] - rgb_env[:-1])**2).reshape(-1)
      + 0.5 * ((rgb_env[:, 1:] - rgb_env[:, :-1])**2).reshape(-1))
  total = (mse + mse_c + f["bg_weight"] * loss_bg
           + f["bg_smooth_weight"] * smooth)
  return total, mse.detach()


class Adam:
  """Adam with bias correction by count, over named leaves."""

  def __init__(self, params, names):
    self.names = names
    self.mu = {k: torch.zeros_like(params[k]) for k in names}
    self.nu = {k: torch.zeros_like(params[k]) for k in names}
    self.count = 0

  @torch.no_grad()
  def step(self, params, grads, lr):
    self.count += 1
    c1 = 1 - ADAM_B1**self.count
    c2 = 1 - ADAM_B2**self.count
    for k in self.names:
      g = grads[k]
      self.mu[k].mul_(ADAM_B1).add_(g, alpha=1 - ADAM_B1)
      self.nu[k].mul_(ADAM_B2).add_(g * g, alpha=1 - ADAM_B2)
      upd = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + ADAM_EPS)
      params[k].sub_(lr * upd)


class Trainer:
  """Adam steps of the reference's train step over named leaves.

  On the card the step (forward and gradients) is captured once as a CUDA
  graph that reads a static copy of the batch and the leaves' own
  tensors, and is replayed for each batch; elsewhere, and where the
  capture fails, it runs eagerly: the same operations. `steps` sets the
  leaves (and Adam's moments) and runs a sequence of batches."""

  def __init__(self, scene, params, example, prec=Prec(), keep=None):
    self.scene, self.prec, self.keep = scene, prec, keep
    self.names = trained_names(params, scene.stage)
    self.params = {k: v.detach().clone().requires_grad_(k in self.names)
                   for k, v in params.items()}
    self.alpha = torch.zeros((), device=scene.device)
    self.run = None
    if torch.device(scene.device).type == "cuda":
      self.run = _graphed(scene, self.params, self.names, self._step,
                          example, prec, keep)
    self.run = self.run or self._step

  def _step(self, batch):
    total, mse = loss(self.scene, self.params, batch, self.alpha, self.prec,
                      self.keep)
    grads = torch.autograd.grad(total, [self.params[k] for k in self.names],
                                allow_unused=True)
    return mse, [torch.zeros_like(self.params[k]) if g is None else g
                 for k, g in zip(self.names, grads)]

  def steps(self, start, batches, first_step, moments=None):
    """Adam steps from leaves `start` over `batches` (scene.Batches' dicts,
    the first at global step `first_step`), from fresh moments or from
    moments = (mu, nu, count), dicts by leaf and the updates made.

    Returns {"losses" [steps], "grad" (the first gradient), "final" (the
    leaves), "mu", "nu"}, dicts by trained leaf."""
    f = self.scene.cfg["flags"]
    with torch.no_grad():
      for k, v in start.items():
        self.params[k].copy_(v)
    opt = Adam(self.params, self.names)
    if moments is not None:
      mu, nu, opt.count = moments
      for k in self.names:
        opt.mu[k].copy_(mu[k])
        opt.nu[k].copy_(nu[k])
    losses, first_grad = [], None
    for i, batch in enumerate(batches):
      self.alpha.fill_(annealed_alpha(first_step + i, f))
      mse, grads = self.run(batch)
      grads = dict(zip(self.names, grads))
      if first_grad is None:
        first_grad = {k: g.detach().clone() for k, g in grads.items()}
      opt.step(self.params, grads, lr_at(first_step + i - 1, f))
      losses.append(float(mse))
    return {"losses": losses, "grad": first_grad,
            "final": {k: self.params[k].detach().clone() for k in self.names},
            "mu": opt.mu, "nu": opt.nu}


def _graphed(scene, params, names, step, example, prec, keep):
  """step(batch) captured as a CUDA graph reading a static copy of the
  batch; returns a function that copies a batch in, replays and returns
  the static outputs, or None where the capture fails. A short march of
  the same operations runs first on the capture's stream, so that what
  libraries set up lazily is set up outside the capture."""
  static = {k: v.clone() for k, v in example.items()}
  stream = torch.cuda.Stream()
  stream.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(stream):
    short = copy.copy(scene)
    short.cfg = dict(scene.cfg, flags=dict(scene.cfg["flags"],
                                           num_path_samples=1))
    warm = dict(static, jitter=torch.arange(
        short.cfg["flags"]["num_coarse_samples"], device=scene.device))
    total, _ = loss(short, params, warm, torch.ones((), device=scene.device),
                    prec, keep)
    torch.autograd.grad(total, [params[k] for k in names], allow_unused=True)
    del total
  torch.cuda.synchronize()
  graph = torch.cuda.CUDAGraph()
  try:
    # thread_local: autograd's device threads run the backward.
    with torch.cuda.graph(graph, stream=stream,
                          capture_error_mode="thread_local"):
      out = step(static)
  except RuntimeError as exc:
    print(f"reference: the step's capture failed ({exc}); eager steps",
          file=sys.stderr, flush=True)
    torch.cuda.synchronize()
    return None

  def run(batch):
    for k, v in batch.items():
      static[k].copy_(v)
    graph.replay()
    return out
  return run


@torch.no_grad()
def render(scene, params, origins, viewdirs, jitter, prec=Prec(),
           block=8192):
  """(rgb [R, 3], distance [R], acc [R]) of the final level at annealing
  alpha 1, not randomized: every ray marched at once, shaded in blocks."""
  alpha = torch.tensor(1.0, device=scene.device)
  pos, dirs, dist = trace_paths(scene, params, origins, viewdirs, alpha, prec)
  out = []
  for i in range(0, origins.shape[0], block):
    sl = slice(i, i + block)
    comp, d, acc, _, _ = shade(scene, params, (pos[sl], dirs[sl], dist[sl]),
                               jitter, None, prec)[-1]
    out.append(torch.cat([comp, d[:, None], acc[:, None]], -1))
  out = torch.cat(out)
  return out[:, :3], out[:, 3], out[:, 4]


def param_shapes(cfg):
  """{leaf name: shape} of the model: the coarse and fine NerfMLPs, the
  background MLP and the so3 head, weights [out, in]."""
  f = cfg["flags"]
  fin, cond = 3 + 6 * f["max_deg_point"], 3 + 6 * f["deg_view"]
  w, wc = f["net_width"], f["net_width_condition"]
  shapes = {}

  def add(prefix, dims):
    for i, (n_in, n_out) in enumerate(dims):
      shapes[f"{prefix}.{i}.weight"] = (n_out, n_in)
      shapes[f"{prefix}.{i}.bias"] = (n_out,)

  dims, width = [], fin
  for i in range(f["net_depth"]):
    dims.append((width, w))
    width = w + (fin if i % f["skip_layer"] == 0 and i > 0 else 0)
  dims += [(width, 1), (width, w)]
  width = w + cond
  for _ in range(f["net_depth_condition"]):
    dims.append((width, wc))
    width = wc
  dims.append((width, 3))
  add("coarse_mlp.layers", dims)
  add("fine_mlp.layers", dims)
  add("bkgd_mlp.layers", [(cond, 128), (128, 128), (128, 128),
                          (128 + cond, 128), (128, 3)])
  pe = 6 * SO3_MAX_DEG
  for name, (n_in, n_out) in zip(
      ["Dense_0", "Dense_1", "Dense_2", "Dense_3", "Dense_out"],
      [(pe, 128), (128, 128), (128, 128), (128 + pe, 128), (128, 3)]):
    shapes[f"path_sampler.so3_mlp.layers.{name}.weight"] = (n_out, n_in)
    shapes[f"path_sampler.so3_mlp.layers.{name}.bias"] = (n_out,)
  return shapes


def check_supported(cfg):
  """Raise ValueError for a setting this reference does not compute."""
  f = cfg["flags"]
  want = {"net_activation": "relu", "rgb_activation": "sigmoid",
          "sigma_activation": "softplus", "noise_std": None,
          "grad_max_norm": 0.0, "grad_max_val": 0.0,
          "weight_decay_mult": 0.0, "legacy_posenc_order": False,
          "white_bkgd": False, "use_pixel_centers": True,
          "use_viewdirs": True, "use_online_sparsity": False,
          "sparsity_weight": 0.0, "normal_loss_weight": 0.0,
          "normal_smooth_weight": 0.0, "sh_deg": -1, "sh_direnc_deg": -1,
          "min_deg_point": 0, "num_rgb_channels": 3,
          "num_sigma_channels": 1, "tile_stride": 1, "tile_images": False,
          "precrop_iters": 0, "batching": "tile"}
  for k, v in want.items():
    if f.get(k) != v:
      raise ValueError(f"the reference computes {k} = {v!r}, the "
                       f"configuration states {f.get(k)!r}")
