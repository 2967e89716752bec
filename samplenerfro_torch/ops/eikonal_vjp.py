"""The 'all' stage's differentiable march: K2 forward, K3 backward.

Counterpart of samplenerfro_tpu/ops/eikonal_vjp.py:94-197 and 575-624
(make_march_allstage with the fused forward kernel and bwd_pallas). The
forward is K2 (ops/march_kernel.march_full); the backward is K3
(csrc/march_bwd.cu), the reverse sweep over the stored trajectory in the
JAX package's three-pass form (bwd_impl="passes", eikonal_vjp.py:
209-444), whose step adjoints the kernel's source comment lists.

`march_allstage` is a torch.autograd.Function returning the [B, S, 11]
trajectory; it is differentiable in the origins, the directions, the
annealing alpha and every so3 weight and bias, and passes no gradient to
the grid. `march_bwd` launches K3 for CUDA tensors and, for CPU tensors,
uses `march_bwd_reference`, which replays ops/eikonal.march under autograd.
`march_bwd_passes_reference` is a second plain version, in K3's three
passes.

The arms (MarchConfig.interp, .bwd_dtype; ops/precision.py): K2 marches
at the interpolation's precision with the head in the sweep's dtype; K3
in its bf16 arm is the JAX package's passes form with bwd_dtype bfloat16
(eikonal_vjp.py:270-275, 300-321, 428-430), whose plain version is
march_bwd_passes_reference in the same arm, on the CPU too.
"""

import collections
import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from samplenerfro_torch.ops import cuda_build
from samplenerfro_torch.ops import eikonal as eik_ops
from samplenerfro_torch.ops import grid as grid_ops
from samplenerfro_torch.ops import march_kernel
from samplenerfro_torch.ops import math as math_ops
from samplenerfro_torch.ops import mlp as mlp_ops
from samplenerfro_torch.ops import precision

MarchConfig = collections.namedtuple(
    "MarchConfig", ("spec", "near", "step_size", "num_samples", "max_deg",
                    "interp", "bwd_dtype"), defaults=("highest", "float32"))


def march_bwd_reference(cfg, data, origins, directions, so3_params, alpha,
                        dtraj):
  """Plain version of K3: autograd of the plain march with cotangent dtraj.

  Returns (origins_bar [B, 3], directions_bar [B, 3], alpha_bar (0-d),
  [grad of each so3 param]).
  """
  with torch.enable_grad():
    o = origins.detach().requires_grad_()
    d = directions.detach().requires_grad_()
    a = torch.as_tensor(alpha, dtype=torch.float32,
                        device=origins.device).detach().requires_grad_()
    ps = [p.detach().requires_grad_() for p in so3_params]
    traj = march_kernel.march_full_reference(
        cfg.spec, data, o, d, cfg.near, cfg.step_size, cfg.num_samples, ps,
        a, cfg.max_deg, cfg.interp)
    grads = torch.autograd.grad(traj, [o, d, a, *ps], dtraj,
                                allow_unused=True)
  grads = [torch.zeros_like(x) if gr is None else gr
           for gr, x in zip(grads, [o, d, a, *ps])]
  return grads[0], grads[1], grads[2], grads[3:]


def _segbar(ddist):
  """Arclength cotangent -> per-segment: segbar_j = sum_{k > j} ddist_k."""
  revcum = torch.flip(torch.cumsum(torch.flip(ddist, [-1]), -1), [-1])
  return torch.cat([revcum[:, 1:], torch.zeros_like(revcum[:, :1])], dim=-1)


def _trilinear_jacobian(spec, data, pts):
  """d[n, g]/dp of ops/grid.trilinear at pts [..., 3]: [..., 4, 3] (the
  lerps' derivative along each axis over the voxel size; clamped corners
  give 0), as K3's pass 1 takes it."""
  _, ndelta = spec.axis_tensors(pts.device)
  (c000, c100, c010, c110, c001, c101, c011, c111), (xd, yd, zd) = (
      grid_ops.cell_corners(spec, data, pts))
  lerp = lambda u, v, t: u * (1 - t) + v * t
  c00, c01 = lerp(c000, c100, xd), lerp(c001, c101, xd)
  c10, c11 = lerp(c010, c110, xd), lerp(c011, c111, xd)
  dvx = lerp(lerp(c100 - c000, c110 - c010, yd),
             lerp(c101 - c001, c111 - c011, yd), zd)
  dvy = lerp(c10 - c00, c11 - c01, zd)
  dvz = lerp(c01, c11, yd) - lerp(c00, c10, yd)
  return torch.stack([dvx / ndelta[0], dvy / ndelta[1], dvz / ndelta[2]],
                     dim=-1)


def trilinear_jacobian_bf16(spec, data, pts, rnd=precision.bf16):
  """The same derivative in the passes form's bf16 arm, as K3's 1a takes
  it there (csrc/march_bwd.cu:trilinear_jacobian_bf16): along axis a, its
  weights are the one-hot derivative (-1, +1) and the other axes' the lerp
  weights (1 - f, f); sum_z uz(z) sum_{y, x} rnd(c_xyz) rnd(ux(x) uy(y)),
  summed along x, then y, lower corner first, then over z in fp32; over
  the voxel size. rnd is the bf16 rounding."""
  _, ndelta = spec.axis_tensors(pts.device)
  corners, fracs = grid_ops.cell_corners(spec, data, pts)
  lerp_w = [(1 - f, f) for f in fracs]
  one = torch.ones_like(fracs[0])
  cols = []
  for ax in range(3):
    w = [(-one, one) if k == ax else lerp_w[k] for k in range(3)]
    t = []
    for z in range(2):
      q = [rnd(corners[xy + 4 * z]) * rnd(w[0][xy & 1] * w[1][xy >> 1])
           for xy in range(4)]
      t.append((q[0] + q[1]) + (q[2] + q[3]))
    cols.append((t[0] * w[2][0] + t[1] * w[2][1]) / ndelta[ax])
  return torch.stack(cols, dim=-1)


def _so3_tangents(so3_params, window, pts, max_deg):
  """The head's output raw [M, 3] at pts [M, 3] and its tangents
  d raw / d p [M, 3 (out), 3 (axis of p)], pushed forward through the
  annealed PE and each ReLU layer as K3's pass 1 does."""
  w = so3_params[0::2]
  b = so3_params[1::2]
  scales = torch.tensor([2.0**i for i in range(max_deg)], dtype=pts.dtype,
                        device=pts.device)
  xb = pts[:, None, :] * scales[:, None]                      # [M, D, 3]
  args = torch.cat([xb, xb + 0.5 * math.pi], dim=-1)         # [M, D, 6]
  win = window[:, None]
  x = (torch.sin(args) * win).reshape(pts.shape[0], -1)
  dco = (win * (torch.cos(args) * scales[:, None])).reshape(pts.shape[0],
                                                           -1)
  axis = torch.arange(6 * max_deg, device=pts.device) % 3
  tx = torch.stack([dco * (axis == c) for c in range(3)])     # [3, M, I]
  h, t = x, tx
  for i in range(4):
    if i == 3:
      h, t = torch.cat([h, x], -1), torch.cat([t, tx], -1)
    h = torch.relu(h @ w[i].t() + b[i])
    t = (t @ w[i].t()) * (h > 0)
  raw = h @ w[4].t() + b[4]
  traw = (t @ w[4].t()).permute(1, 2, 0)                      # [M, out, p]
  return raw, traw


def _so3_bf16(so3_params, window, pts, max_deg, rnd, replay=None):
  """K3's bf16 head at pts [M, 3], as passes 1b and 3 run it: the weights
  rnd-rounded, the PE's features x = rnd(sin(arg) w), its sines rnd(sin)
  and tangent seeds rnd(w cos(arg) 2^deg), the stored activations
  rnd(ReLU(z)), fp32 sums and biases. Returns (weights, x, sines, seeds,
  [h0, h1, h2, h3], raw). replay: ([pre] * 3, [flipped] * 3), [M, W] each,
  the pre-activations of layers 1-3 to take where flipped (another
  summation order's, as probe_so3_relu.replaying_refine_fn takes them)."""
  w = [rnd(p) for p in so3_params[0::2]]
  b = so3_params[1::2]
  m = pts.shape[0]
  scales = torch.tensor([2.0**i for i in range(max_deg)], dtype=pts.dtype,
                        device=pts.device)
  xb = pts[:, None, :] * scales[:, None]                      # [M, D, 3]
  args = torch.cat([xb, xb + 0.5 * math.pi], dim=-1)         # [M, D, 6]
  win = window[:, None]
  sines = torch.sin(args)
  x = rnd((sines * win).reshape(m, -1))
  val = rnd(sines.reshape(m, -1))
  seeds = rnd((win * (torch.cos(args) * scales[:, None])).reshape(m, -1))
  hs, h = [], x
  for i in range(4):
    z = F.linear(torch.cat([h, x], -1) if i == 3 else h, w[i], b[i])
    if replay is not None and i < 3:
      z = torch.where(replay[1][i], replay[0][i], z)
    h = rnd(torch.relu(z))
    hs.append(h)
  return w, x, val, seeds, hs, F.linear(h, w[4], b[4])


def _so3_bf16_tangents(w, seeds, hs, rnd):
  """d raw / d p [M, 3 (out), 3 (axis of p)] of the bf16 head: the PE's
  seeds along each axis pushed through each layer, rnd-rounded and masked
  by its activations, as pass 1b's tangents."""
  axis = torch.arange(seeds.shape[-1], device=seeds.device) % 3
  tx = torch.stack([seeds * (axis == c) for c in range(3)])   # [3, M, I]
  t = tx
  for i in range(4):
    t = rnd(((torch.cat([t, tx], -1) if i == 3 else t) @ w[i].t())
            * (hs[i] > 0))
  return (t @ w[4].t()).permute(1, 2, 0)


def _so3_bf16_grads(w, val, hs, rawbar, window, max_deg, rnd):
  """Pass 3 of the bf16 arm: the head's weight and bias cotangents (in
  nn.Linear layout) and the window's [max_deg] at rawbar [M, 3]. Each
  cotangent is rnd-rounded as the products' operand (masked by the next
  layer's activations), each dW = dz^T A sums fp32 products of bf16
  operands; the first layer's and the skip columns' are taken against the
  sines and scaled by the window, whose cotangent is their sum against the
  weights per degree (march_bwd's _unpack_grads)."""
  width = w[0].shape[0]
  rb = rnd(rawbar)
  gw, gb = [None] * 5, [None] * 5
  gw[4], gb[4] = rb.t() @ hs[3], rb.sum(0)
  dz = rnd((rb @ w[4]) * (hs[3] > 0))
  for i in (3, 2, 1, 0):
    gb[i] = dz.sum(0)
    if i == 3:
      gw[i] = dz.t() @ torch.cat([hs[2], val], -1)
    else:
      gw[i] = dz.t() @ (hs[i - 1] if i > 0 else val)
    if i > 0:
      dz = rnd((dz @ w[i][:, :width]) * (hs[i - 1] > 0))
  sine0, sine3 = gw[0], gw[3][:, width:]
  wbar = ((w[0] * sine0).sum(0) + (w[3][:, width:] * sine3).sum(0))
  scale = window.repeat_interleave(6)
  gw[0] = sine0 * scale
  gw[3] = torch.cat([gw[3][:, :width], sine3 * scale], -1)
  return wbar.view(max_deg, 6).sum(-1), [x for pair in zip(gw, gb)
                                         for x in pair]


def march_bwd_passes_reference(cfg, data, origins, directions, so3_params,
                               alpha, traj, dtraj, rnd=precision.bf16,
                               replay=None):
  """Plain version of K3 in its three passes (samplenerfro_tpu/ops/
  eikonal_vjp.py:209-444, bwd_impl="passes"), on the trajectory traj that
  K2 (or its plain version) emitted. Returns what march_bwd returns.

  Pass 1, per ray-step: a = dn/dp and B = dg/dp at p_s, inv_n, c_p, c_d;
  at the active ray-steps K = Jp^T + B^T Jg^T, Jp = d raw/dp (three
  tangents through the head) chained with Rodrigues' d u/d raw, Jg =
  d u/d g (Rodrigues' adjoint at three unit cotangents); K = B^T
  elsewhere. Pass 2: the linear recurrence in (pbar, dbar), s = S-1 .. 0.
  Pass 3: the head's VJP to its weights and alpha at ubar_s = h dbar_{s+1}
  over the active ray-steps.

  cfg.bwd_dtype "bfloat16" is K3's bf16 arm: the derivative of the
  interpolation (trilinear_jacobian_bf16), the head's tangents and its
  VJP at the passes form's bf16 operands (_so3_bf16*), rnd the rounding;
  replay as _so3_bf16's, at the active ray-steps in traj's order.
  """
  bf16 = precision.check_bwd_dtype(cfg.bwd_dtype) == "bfloat16"
  h = cfg.step_size
  so3 = [p.detach() for p in so3_params]
  traj, dtraj = traj.detach(), dtraj.detach()
  pos, d, n, g = traj[..., 0:3], traj[..., 3:6], traj[..., 7:8], traj[
      ..., 8:11]
  dp, dd, dn, dg = dtraj[..., 0:3], dtraj[..., 3:6], dtraj[..., 7:8], dtraj[
      ..., 8:11]
  sb = _segbar(dtraj[..., 6])[..., None]
  alpha_t = torch.as_tensor(alpha, dtype=torch.float32, device=pos.device)
  window = march_kernel.so3_window(alpha_t.detach(), cfg.max_deg)

  # Pass 1.
  jac = (trilinear_jacobian_bf16(cfg.spec, data, pos, rnd) if bf16 else
         _trilinear_jacobian(cfg.spec, data, pos))         # [B, S, 4, 3]
  a_vec, bg = jac[..., 0, :], jac[..., 1:, :]              # [B,S,3], [..3,3]
  bt = bg.transpose(-1, -2)
  mask = torch.sqrt((g * g).sum(-1)) > 1e-3
  dlen = torch.sqrt(torch.clamp((d * d).sum(-1, keepdim=True), min=1e-6))
  inv_n = 1.0 / n
  c_n = dn - sb * (h * inv_n * inv_n) * dlen
  c_p = a_vec * c_n + (bt @ dg[..., None])[..., 0] + dp
  c_d = dd + sb * (h * inv_n) * d / dlen
  k_mat = bt.clone()
  any_active = bool(mask.any())
  if any_active:
    if bf16:
      w_r, _, val, seeds, hs, raw = _so3_bf16(so3, window, pos[mask],
                                              cfg.max_deg, rnd, replay)
      traw = _so3_bf16_tangents(w_r, seeds, hs, rnd)
    else:
      raw, traw = _so3_tangents(so3, window, pos[mask], cfg.max_deg)
    gm = g[mask]
    rows = []
    with torch.enable_grad():
      r = raw.detach().requires_grad_()
      gg = gm.detach().requires_grad_()
      u = eik_ops.rodrigues_rotate(r, gg)
      for i in range(3):
        unit = torch.zeros_like(u)
        unit[:, i] = 1.0
        rows.append(torch.autograd.grad(u, [r, gg], unit, retain_graph=True))
    j_raw = torch.stack([x[0] for x in rows], dim=1)  # [M, i, out of head]
    j_g = torch.stack([x[1] for x in rows], dim=1)    # [M, i, j]
    j_p = j_raw @ traw                                # [M, i, axis]
    k_mat[mask] = j_p.transpose(-1, -2) + bt[mask] @ j_g.transpose(-1, -2)

  # Pass 2.
  pbar = torch.zeros_like(pos[:, 0])
  dbar = torch.zeros_like(pos[:, 0])
  dbar_traj = torch.empty_like(pos)
  for s in range(cfg.num_samples - 1, -1, -1):
    dbar_traj[:, s] = dbar
    pdot = (pbar * d[:, s]).sum(-1, keepdim=True)
    kd = (k_mat[:, s] @ dbar[..., None])[..., 0]
    new_p = (pbar + h * kd + a_vec[:, s] * (-(h * inv_n[:, s]**2) * pdot)
             + c_p[:, s])
    dbar = dbar + (h * inv_n[:, s]) * pbar + c_d[:, s]
    pbar = new_p

  # Pass 3.
  if bf16:
    if any_active:
      with torch.enable_grad():
        r = raw.detach().requires_grad_()
        rawbar, = torch.autograd.grad(eik_ops.rodrigues_rotate(r, gm), r,
                                      h * dbar_traj[mask])
      wbar, param_grads = _so3_bf16_grads(w_r, val, hs, rawbar, window,
                                          cfg.max_deg, rnd)
    else:
      wbar = torch.zeros_like(window)
      param_grads = [torch.zeros_like(p) for p in so3]
    with torch.enable_grad():
      a = alpha_t.detach().requires_grad_()
      alpha_bar, = torch.autograd.grad(march_kernel.so3_window(
          a, cfg.max_deg), a, wbar)
    return pbar, cfg.near * pbar + dbar, alpha_bar, param_grads
  with torch.enable_grad():
    a = alpha_t.detach().requires_grad_()
    ps = [p.requires_grad_() for p in (q.clone() for q in so3)]
    if any_active:
      x = math_ops.annealed_pos_enc(pos[mask], 0, cfg.max_deg,
                                    a * cfg.max_deg)
      u = eik_ops.rodrigues_rotate(mlp_ops.apply_params(ps, x), g[mask])
      grads = torch.autograd.grad(u, [a, *ps], h * dbar_traj[mask],
                                  allow_unused=True)
    else:
      grads = [None] * (1 + len(ps))
  grads = [torch.zeros_like(x) if gr is None else gr
           for gr, x in zip(grads, [a, *ps])]
  return pbar, cfg.near * pbar + dbar, grads[0], grads[1:]


HIDDEN = 128  # the width K3's products run at; narrower heads are padded


def _pack_sizes(in_dim):
  """Sizes of the padded forward pack's parts: W0t b0 W1t b1 W2t b2 W3t b3
  Woutt bout."""
  h = HIDDEN
  return [in_dim * h, h, h * h, h, h * h, h, (h + in_dim) * h, h, h * 3, 3]


def so3_packs(so3_params):
  """K3's and P3's weight packs of the so3 head, hidden units zero-padded
  to HIDDEN: (forward, input-major W0t b0 W1t b1 W2t b2 W3t b3 Woutt bout;
  backward, nn.Linear layout W1 W2 and W3's first HIDDEN inputs)."""
  w = [p.detach() for p in so3_params[0::2]]
  b = [p.detach() for p in so3_params[1::2]]
  width, in_dim = w[0].shape
  h = HIDDEN
  fwd = torch.zeros(sum(_pack_sizes(in_dim)), dtype=torch.float32,
                    device=w[0].device)
  parts = torch.split(fwd, _pack_sizes(in_dim))
  parts[0].view(in_dim, h)[:, :width].copy_(w[0].t())
  parts[2].view(h, h)[:width, :width].copy_(w[1].t())
  parts[4].view(h, h)[:width, :width].copy_(w[2].t())
  w3t = parts[6].view(h + in_dim, h)
  w3t[:width, :width].copy_(w[3][:, :width].t())
  w3t[h:, :width].copy_(w[3][:, width:].t())
  parts[8].view(h, 3)[:width].copy_(w[4].t())
  for i in range(4):
    parts[2 * i + 1][:width].copy_(b[i])
  parts[9].copy_(b[4])
  bwd = torch.zeros((3, h, h), dtype=torch.float32, device=w[0].device)
  bwd[0, :width, :width].copy_(w[1])
  bwd[1, :width, :width].copy_(w[2])
  bwd[2, :width, :width].copy_(w[3][:, :width])
  return fwd, bwd.reshape(-1)


def arm_packs(so3_params, bwd_dtype):
  """K3's and P3's packs in the arm bwd_dtype: (the fp32 forward pack, the
  fp32 backward pack, the products' forward pack, their backward pack).
  In the bf16 arm the weights are rounded to bf16 first (the biases stay
  fp32), so the fp32 packs hold the rounded weights and the products'
  packs are their bf16 copies; in fp32 the products' packs are the fp32
  ones."""
  if precision.check_bwd_dtype(bwd_dtype) == "float32":
    fwd, bwd = so3_packs(so3_params)
    return fwd, bwd, fwd, bwd
  fwd, bwd = so3_packs([precision.bf16(p.detach()) if i % 2 == 0 else p
                        for i, p in enumerate(so3_params)])
  return fwd, bwd, fwd.to(torch.bfloat16), bwd.to(torch.bfloat16)


def _unpack_grads(so3_params, flat, window, max_deg, wfwd):
  """K3's flat gradients in the padded forward pack's order -> (the
  window's cotangent [max_deg], [grad of each so3 param]). The first
  layer's rows and the skip rows of the fourth were summed against the
  PE's sines before the window: their gradients are those sums times the
  window, and the window's cotangent is their sum against the weights,
  per degree."""
  width, in_dim = so3_params[0].shape
  sizes = _pack_sizes(in_dim)
  g = torch.split(flat, sizes)
  w = torch.split(wfwd, sizes)
  g0, w0 = g[0].view(in_dim, HIDDEN), w[0].view(in_dim, HIDDEN)
  g3, w3 = g[6].view(HIDDEN + in_dim, HIDDEN), w[6].view(HIDDEN + in_dim,
                                                         HIDDEN)
  per_feature = ((w0 * g0).sum(-1) + (w3[HIDDEN:] * g3[HIDDEN:]).sum(-1))
  wbar = per_feature.view(max_deg, 6).sum(-1)
  scale = window.repeat_interleave(6)[:, None]
  hidden = lambda t: t.view(HIDDEN, HIDDEN)[:width, :width].t().contiguous()
  return wbar, [
      (g0 * scale)[:, :width].t().contiguous(), g[1][:width].clone(),
      hidden(g[2]), g[3][:width].clone(), hidden(g[4]), g[5][:width].clone(),
      torch.cat([g3[:width, :width], g3[HIDDEN:, :width] * scale], 0).t()
      .contiguous(), g[7][:width].clone(),
      g[8].view(HIDDEN, 3)[:width].t().contiguous(), g[9].clone()]


def march_bwd(cfg, data, origins, directions, so3_params, alpha, traj,
              dtraj):
  """Cotangents of K2's inputs from its trajectory's cotangent (K3).

  Args:
    cfg: MarchConfig of the march.
    data: [N^3, 4] grid; origins, directions: [B, 3] the march's inputs.
    so3_params: the so3 MLP's flat params; alpha: annealing progress.
    traj: [B, S, 11] K2's trajectory (read by the kernel only).
    dtraj: [B, S, 11] its cotangent (pos, raw dir, arclength, n, grad n).

  Returns:
    (origins_bar, directions_bar, alpha_bar, [so3 param grads]).

  cfg.bwd_dtype picks K3's arm; its plain version on the CPU is
  march_bwd_reference in fp32 and march_bwd_passes_reference in bf16.
  """
  bf16 = precision.check_bwd_dtype(cfg.bwd_dtype) == "bfloat16"
  dev = origins.device
  if dev.type == "cpu":
    if bf16:
      return march_bwd_passes_reference(cfg, data, origins, directions,
                                        so3_params, alpha, traj, dtraj)
    return march_bwd_reference(cfg, data, origins, directions, so3_params,
                               alpha, dtraj)
  if dev.type != "cuda":
    raise ValueError(f"march_bwd runs on CUDA or CPU tensors, not {dev}")
  batch, num_samples = origins.shape[0], cfg.num_samples
  shape = (batch, num_samples, 11)
  for name, t in (("traj", traj), ("dtraj", dtraj)):
    if (t.device != dev or t.dtype != torch.float32
        or tuple(t.shape) != shape):
      raise ValueError(f"march_bwd: {name} must be float32 {shape} on {dev},"
                       f" got {t.dtype} {tuple(t.shape)} on {t.device}")
  march_kernel.check_march_inputs("march_bwd", cfg.spec, data, origins,
                                  directions)
  march_kernel.so3_width(so3_params, cfg.max_deg)
  traj = traj.contiguous()
  cts = dtraj.contiguous().clone()
  cts[..., 6] = _segbar(dtraj[..., 6])
  wfwd, wbwd, wfwd_t, wbwd_t = arm_packs(so3_params, cfg.bwd_dtype)
  alpha_t = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
  window = march_kernel.so3_window(alpha_t.detach(), cfg.max_deg)
  window = window.contiguous()
  num_blocks = BLOCKS_PER_SM[cfg.bwd_dtype] * _sm_count(dev)
  num_params = wfwd.numel()
  bp = -(-batch // 32) * 32
  pieces = torch.empty((num_samples, PIECES, bp), dtype=torch.float32,
                       device=dev)
  dbar_traj = torch.empty((batch, num_samples, 3), dtype=torch.float32,
                          device=dev)
  raybar = torch.empty((batch, 6), dtype=torch.float32, device=dev)
  partial = torch.empty((num_blocks, num_params), dtype=torch.float32,
                        device=dev)
  grads = torch.empty((num_params,), dtype=torch.float32, device=dev)
  lib = _library()
  spec = cfg.spec
  with torch.cuda.device(dev):
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.march_bwd_launch(
        traj.data_ptr(), cts.data_ptr(), data.data_ptr(), wfwd.data_ptr(),
        wfwd_t.data_ptr(), wbwd_t.data_ptr(), window.data_ptr(),
        pieces.data_ptr(), dbar_traj.data_ptr(), raybar.data_ptr(),
        partial.data_ptr(), grads.data_ptr(), batch, num_samples,
        cfg.max_deg, num_blocks, int(bf16), *spec.ndim, cfg.step_size,
        *spec.nmin, *spec.ndelta, stream)
  if err != 0:
    raise RuntimeError(f"march_bwd: kernel launch failed with CUDA error "
                       f"{err}")
  march_bwd.launches += 1
  march_bwd.arms[cfg.bwd_dtype] += 1

  pbar, dbar = raybar[:, 0:3], raybar[:, 3:6]
  wbar, param_grads = _unpack_grads(so3_params, grads, window, cfg.max_deg,
                                    wfwd)
  with torch.enable_grad():
    a = alpha_t.detach().requires_grad_()
    alpha_bar, = torch.autograd.grad(
        march_kernel.so3_window(a, cfg.max_deg), a, wbar)
  return pbar, cfg.near * pbar + dbar, alpha_bar, param_grads


march_bwd.launches = 0
march_bwd.arms = collections.Counter()
# K3's pieces a ray-step (csrc/march_bwd.cu kFields) and the blocks of its
# passes 1b and 3 for each SM, by arm: a bf16 block's 128-row tiles take
# ~212 KB of shared memory, one block an SM.
PIECES = 22
BLOCKS_PER_SM = {"float32": 2, "bfloat16": 1}


class _AllStageMarch(torch.autograd.Function):
  """K2 forward, K3 backward; the trajectory is saved for the backward."""

  @staticmethod
  def forward(ctx, cfg, data, origins, directions, alpha, *so3_params):
    traj = march_kernel.march_full(
        cfg.spec, data, origins, directions, cfg.near, cfg.step_size,
        cfg.num_samples, list(so3_params), alpha, cfg.max_deg, cfg.interp,
        cfg.bwd_dtype)
    ctx.cfg = cfg
    ctx.save_for_backward(data, origins, directions, alpha, traj,
                          *so3_params)
    return traj

  @staticmethod
  def backward(ctx, dtraj):
    data, origins, directions, alpha, traj, *so3_params = ctx.saved_tensors
    obar, dbar, abar, pgrads = march_bwd(ctx.cfg, data, origins, directions,
                                         so3_params, alpha, traj, dtraj)
    return (None, None, obar, dbar, abar, *pgrads)


def march_allstage(cfg, data, origins, directions, alpha, so3_params):
  """Differentiable 'all'-stage march: the [B, S, 11] trajectory.

  Channels: pos 0:3, raw dir 3:6, arclength 6, n 7, grad n 8:11
  (ops/march_kernel.split_trajectory). alpha is a float or a 0-d float32
  tensor on the rays' device; the train step passes its batch's tensor,
  since a float is copied from the host, which a CUDA graph cannot capture.
  """
  alpha = torch.as_tensor(alpha, dtype=torch.float32, device=origins.device)
  return _AllStageMarch.apply(cfg, data, origins.contiguous(),
                              directions.contiguous(), alpha, *so3_params)


@functools.lru_cache(maxsize=None)
def _sm_count(dev):
  return torch.cuda.get_device_properties(dev).multi_processor_count


def _library():
  lib = cuda_build.load("march_bwd")
  fn = lib.march_bwd_launch
  if fn.restype is not ctypes.c_int or not fn.argtypes:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [vp] * 12 + [ci] * 8 + [cf] * 7 + [vp]
    fn.restype = ci
  return lib
