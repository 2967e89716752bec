"""The 'all' stage's differentiable march: K2 forward, K3 backward.

Counterpart of samplenerfro_tpu/ops/eikonal_vjp.py:94-197 and 575-624
(make_march_allstage with the fused forward kernel and bwd_pallas). The
forward is K2 (ops/march_kernel.march_full); the backward is K3
(csrc/march_bwd.cu), the reverse sweep over the stored trajectory, whose
step adjoints the kernel's source comment lists.

`march_allstage` is a torch.autograd.Function returning the [B, S, 11]
trajectory; it is differentiable in the origins, the directions, the
annealing alpha and every so3 weight and bias, and passes no gradient to
the grid. `march_bwd` launches K3 for CUDA tensors and, for CPU tensors,
uses `march_bwd_reference`, which replays ops/eikonal.march under autograd.
"""

import collections
import ctypes

import torch

from samplenerfro_torch.ops import cuda_build
from samplenerfro_torch.ops import march_kernel

MarchConfig = collections.namedtuple(
    "MarchConfig", ("spec", "near", "step_size", "num_samples", "max_deg"))


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
        a, cfg.max_deg)
    grads = torch.autograd.grad(traj, [o, d, a, *ps], dtraj,
                                allow_unused=True)
  grads = [torch.zeros_like(x) if gr is None else gr
           for gr, x in zip(grads, [o, d, a, *ps])]
  return grads[0], grads[1], grads[2], grads[3:]


def _segbar(ddist):
  """Arclength cotangent -> per-segment: segbar_j = sum_{k > j} ddist_k."""
  revcum = torch.flip(torch.cumsum(torch.flip(ddist, [-1]), -1), [-1])
  return torch.cat([revcum[:, 1:], torch.zeros_like(revcum[:, :1])], dim=-1)


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
  """
  dev = origins.device
  if dev.type == "cpu":
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
  width = march_kernel.so3_width(so3_params, cfg.max_deg)
  traj = traj.contiguous()
  cts = dtraj.contiguous().clone()
  cts[..., 6] = _segbar(dtraj[..., 6])
  wfwd = march_kernel.pack_so3(so3_params)
  wbwd = torch.cat([so3_params[i].detach().reshape(-1)
                    for i in range(0, len(so3_params), 2)])
  alpha_t = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
  window = march_kernel.so3_window(alpha_t.detach(), cfg.max_deg)
  window = window.contiguous()
  num_blocks = torch.cuda.get_device_properties(dev).multi_processor_count
  num_params = wfwd.numel()
  raybar = torch.empty((batch, 6), dtype=torch.float32, device=dev)
  rawbar = torch.empty((batch, num_samples, 3), dtype=torch.float32,
                       device=dev)
  wbar = torch.empty((batch, cfg.max_deg), dtype=torch.float32, device=dev)
  partial = torch.empty((num_blocks, num_params), dtype=torch.float32,
                        device=dev)
  grads = torch.empty((num_params,), dtype=torch.float32, device=dev)
  lib = _library()
  spec = cfg.spec
  with torch.cuda.device(dev):
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.march_bwd_launch(
        traj.data_ptr(), cts.data_ptr(), data.data_ptr(), wfwd.data_ptr(),
        wbwd.data_ptr(), window.data_ptr(), raybar.data_ptr(),
        rawbar.data_ptr(), wbar.data_ptr(), partial.data_ptr(),
        grads.data_ptr(), batch, num_samples, cfg.max_deg, width,
        num_blocks, *spec.ndim, cfg.step_size, *spec.nmin, *spec.ndelta,
        stream)
  if err != 0:
    raise RuntimeError(f"march_bwd: kernel launch failed with CUDA error "
                       f"{err}")
  march_bwd.launches += 1

  pbar, dbar = raybar[:, 0:3], raybar[:, 3:6]
  with torch.enable_grad():
    a = alpha_t.detach().requires_grad_()
    alpha_bar, = torch.autograd.grad(
        march_kernel.so3_window(a, cfg.max_deg), a, wbar.sum(dim=0))
  param_grads, off = [], 0
  for i in range(0, len(so3_params), 2):
    out_dim, in_dim = so3_params[i].shape
    n = in_dim * out_dim
    param_grads.append(grads[off:off + n].reshape(in_dim, out_dim).t()
                       .contiguous())
    param_grads.append(grads[off + n:off + n + out_dim].clone())
    off += n + out_dim
  return pbar, cfg.near * pbar + dbar, alpha_bar, param_grads


march_bwd.launches = 0


class _AllStageMarch(torch.autograd.Function):
  """K2 forward, K3 backward; the trajectory is saved for the backward."""

  @staticmethod
  def forward(ctx, cfg, data, origins, directions, alpha, *so3_params):
    traj = march_kernel.march_full(
        cfg.spec, data, origins, directions, cfg.near, cfg.step_size,
        cfg.num_samples, list(so3_params), alpha, cfg.max_deg)
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
  (ops/march_kernel.split_trajectory).
  """
  alpha = torch.as_tensor(alpha, dtype=torch.float32, device=origins.device)
  return _AllStageMarch.apply(cfg, data, origins.contiguous(),
                              directions.contiguous(), alpha, *so3_params)


def _library():
  lib = cuda_build.load("march_bwd")
  fn = lib.march_bwd_launch
  if fn.restype is not ctypes.c_int or not fn.argtypes:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [vp] * 11 + [ci] * 8 + [cf] * 7 + [vp]
    fn.restype = ci
  return lib
