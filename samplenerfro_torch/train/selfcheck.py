"""On-device correctness gate for the port's march kernels (K1, K2, K3).

Counterpart of samplenerfro_tpu/train/selfcheck.py. tests/test_torch_cuda.py
holds each kernel against its plain version at small shapes; this module
runs the kernels on the JAX gate's inputs, at the so3 head's ship width
(4x128, PE degree 10), on the given device, and asserts agreement:

  1. forward: K1 (march_lean, with the jittered subsample) against the
     plain scan march (ops/eikonal.march); K2 (march_full with the so3 head
     at alpha 0.6) against march_full_reference, all 11 channels. K1
     stands in for the JAX gate's Pallas full-emit arm without the head:
     the port has no such emit mode.
  2. backward ('all' stage): the loss and gradients of march_allstage (K2
     forward, K3 backward) against torch.autograd through
     march_full_reference.

The JAX gate's two bf16-interpolation arms are not run: the port's march
interpolates in fp32 only. check_march reports them among its soft
failures (SKIPPED_ARMS) rather than dropping them.

On a CUDA device every arm asserts that its kernel's launch counter moved,
so no arm can pass through a plain version. On the CPU the wrappers run
their plain versions and the gate checks its own plumbing.
"""

import numpy as np
import torch

from samplenerfro_torch import resolve_device
from samplenerfro_torch.ops import eikonal as eik_ops
from samplenerfro_torch.ops import eikonal_vjp
from samplenerfro_torch.ops import grid as grid_ops
from samplenerfro_torch.ops import march_kernel
from samplenerfro_torch.ops import math as math_ops
from samplenerfro_torch.ops import mlp as mlp_ops

SO3_KEY = (0, 10, True, True, True, False)  # shipped VoxMLP branch
ALPHA = 0.6
NEAR, FAR = 2.0, 6.0
SKIPPED_ARMS = (
    ("fwd_pallas_bf16", "the port's march interpolates in fp32 only"),
    ("fwd_tiled_bf16", "the port's march interpolates in fp32 only"),
)


def _blob_grid3d(spec, n):
  """The gate's [n^3, 4] float32 grid of [n, grad n]: a Gaussian IOR blob
  of peak 0.5 over 1.0, built on the host."""
  axes = np.linspace(spec.nmin[0], spec.nmax[0], n)
  xx, yy, zz = np.meshgrid(axes, axes, axes, indexing="ij")
  vals = (1.0 + 0.5 * np.exp(-(xx**2 + yy**2 + zz**2) / 0.25)).reshape(-1, 1)
  vals = vals.astype(np.float32)
  grad = grid_ops.central_difference_grad_numpy(spec, vals)
  return np.concatenate([vals, grad], axis=-1)


def _center_tile_rays(batch, tile=16, res=800, fov=0.69):
  """Tile-coherent camera bundles near the view center (tight spread):
  float32 numpy (origins, directions), each [batch, 3]."""
  rng = np.random.RandomState(3)
  dirs = []
  for _ in range(batch // (tile * tile)):
    cx, cy = rng.randint(res // 2 - 64, res // 2 + 64 - tile, 2)
    for py in range(tile):
      for px in range(tile):
        x = (cx + px - res / 2) / res * fov
        y = (cy + py - res / 2) / res * fov
        dd = np.array([np.tan(x), np.tan(y), 1.0])
        dirs.append(dd / np.linalg.norm(dd))
  d = np.asarray(dirs, np.float32)
  o = np.broadcast_to(np.array([0, 0, -4.0], np.float32), d.shape).copy()
  return o, d


def default_so3_params(device):
  """The gate's so3 head: 4x128 at PE degree 10, drawn from a seeded
  generator, output std 1e-2 so that the head visibly bends the paths."""
  head = mlp_ops.So3MLP(6 * SO3_KEY[1], net_depth=4, net_width=128,
                        skip_layer=2, num_out_channels=3,
                        output_init_std=1e-2,
                        generator=torch.Generator().manual_seed(7))
  return [p.detach().to(device) for p in head.params()]


def _assert_close(name, ref, got, scale_atol, deviations, soft=None,
                  envelopes=None):
  """Record max deviation; raise when out of envelope (or collect if soft).

  soft: optional list; when given, an out-of-envelope deviation is
  appended as a message instead of raising. envelopes: optional dict that
  receives the allowed deviation.
  """
  ref = ref.detach()
  scale = max(float(ref.abs().max()), 1e-3)
  dev = float((ref - got.detach()).abs().max())
  deviations[name] = dev
  if envelopes is not None:
    envelopes[name] = scale_atol * scale
  if not dev <= scale_atol * scale:  # NaN-safe: fails on NaN too
    msg = (f"{name} deviates by {dev:.3e} "
           f"(allowed {scale_atol * scale:.3e}, scale {scale:.3e})")
    if soft is not None:
      soft.append(msg)
      return
    raise AssertionError(f"marcher self-check FAILED: {msg}")


def _launched(kernel, before, what, on_card):
  if on_card and kernel.launches == before:
    raise AssertionError(f"marcher self-check FAILED: {what} ran without "
                         f"launching its kernel")


def check_march(grid_n=128, num_samples=768, block_size=256, nblocks=2,
                grad_samples=192, fwd_atol=2e-3, grad_atol=5e-3, device=None,
                so3_params=None, envelopes=None):
  """Run the forward + backward march parity gate on `device` (CUDA unless
  "cpu" is asked for).

  so3_params: the so3 head's flat [W_0, b_0, ..., W_out, b_out]; None
  draws default_so3_params. envelopes: optional dict that receives each
  arm's allowed deviation.

  Returns (deviations, soft_failures): a dict of max deviations and a list
  of messages for the arms that were not run (SKIPPED_ARMS). Every arm
  that runs is production code and raises AssertionError out of envelope.
  Tolerances are scale-relative and loose enough to absorb fp32 round-off
  amplified across the sequential march, but orders of magnitude below a
  genuinely broken kernel.
  """
  dev = resolve_device(device)
  on_card = dev.type == "cuda"
  spec = grid_ops.GridSpec([grid_n] * 3, [-1.5] * 3, [1.5] * 3)
  data = torch.from_numpy(_blob_grid3d(spec, grid_n)).to(dev)
  o, d = (torch.from_numpy(a).to(dev)
          for a in _center_tile_rays(block_size * nblocks))
  h = (FAR - NEAR) / (num_samples - 1)
  max_deg = SO3_KEY[1]
  so3 = (default_so3_params(dev) if so3_params is None else
         [p.detach().to(dev) for p in so3_params])
  deviations = {}
  soft_failures = [f"{name}: not run ({why})" for name, why in SKIPPED_ARMS]

  def close(name, ref, got, atol):
    _assert_close(name, ref, got, atol, deviations, envelopes=envelopes)

  with torch.no_grad():
    # --- Forward, K1: lean emit + jittered subsample vs the scan march ----
    scan_out = eik_ops.march(spec, data, o, d, NEAR, h, num_samples)
    jit_rng = np.random.RandomState(11)
    num_path = num_samples // 64
    # On the host: march_lean checks it there.
    jitter = torch.from_numpy(np.arange(0, num_samples, num_path)
                              + jit_rng.randint(0, num_path, 64))
    before = march_kernel.march_lean.launches
    lean_out = march_kernel.march_lean(spec, data, o, d, NEAR, h,
                                       num_samples, jitter)
    _launched(march_kernel.march_lean, before, "K1 (march_lean)", on_card)
    jitter = jitter.to(dev)
    ref = scan_out[:3] + tuple(a[:, jitter] for a in scan_out[:3])
    for name, a, b in zip(("pos", "dirs", "dist", "sub_pos", "sub_dirs",
                           "sub_dist"), ref, lean_out):
      close(f"fwd_lean_{name}", a, b, fwd_atol)

    # --- Forward, K2: the so3-refined march vs its plain version ----------
    args = (spec, data, o, d, NEAR, h, num_samples, so3, ALPHA, max_deg)
    before = march_kernel.march_full.launches
    full = march_kernel.march_full(*args)
    _launched(march_kernel.march_full, before, "K2 (march_full)", on_card)
    ref_full = march_kernel.march_full_reference(*args)
    for name, a, b in zip(("pos", "dirs", "dist", "n", "g"),
                          march_kernel.split_trajectory(ref_full),
                          march_kernel.split_trajectory(full)):
      close(f"fwd_so3_{name}", a, b, fwd_atol)

  # --- Backward ('all' stage): K2 + K3 vs autograd of the plain march -----
  s_grad = grad_samples
  og, dg = o[:block_size], d[:block_size]
  rng = np.random.RandomState(0)
  weights = [torch.from_numpy(rng.randn(block_size, s_grad, *c).astype(
      np.float32)).to(dev) for c in ((3,), (3,), (), (1,), (3,))]

  def loss_of(traj):
    pos, dirs, dist, nv, g = march_kernel.split_trajectory(traj)
    wp, wd, wt, wn, wg = weights
    return ((torch.sin(pos) * wp).sum()
            + (math_ops.safe_l2_normalize(dirs) * wd).sum()
            + (dist * wt).sum() + (nv * wn).sum() + (g * wg).sum())

  def value_and_grads(march):
    leaves = [og.clone().requires_grad_(), dg.clone().requires_grad_(),
              torch.tensor(ALPHA, dtype=torch.float32,
                           device=dev).requires_grad_(),
              *[p.clone().requires_grad_() for p in so3]]
    loss = loss_of(march(leaves[0], leaves[1], leaves[2], leaves[3:]))
    return loss.detach(), torch.autograd.grad(loss, leaves)

  val_ref, grads_ref = value_and_grads(
      lambda o_, d_, a_, th: march_kernel.march_full_reference(
          spec, data, o_, d_, NEAR, h, s_grad, th, a_, max_deg))
  cfg = eikonal_vjp.MarchConfig(spec, NEAR, h, s_grad, max_deg)
  before = (march_kernel.march_full.launches, eikonal_vjp.march_bwd.launches)
  val_new, grads_new = value_and_grads(
      lambda o_, d_, a_, th: eikonal_vjp.march_allstage(cfg, data, o_, d_,
                                                        a_, th))
  _launched(march_kernel.march_full, before[0], "the 'all' march's forward "
            "(K2)", on_card)
  _launched(eikonal_vjp.march_bwd, before[1], "the 'all' march's backward "
            "(K3)", on_card)
  close("allstage_loss", val_ref, val_new, 1e-4)
  names = ["origins", "directions", "alpha"] + [
      f"so3.{layer}.{kind}" for layer in ("Dense_0", "Dense_1", "Dense_2",
                                          "Dense_3", "Dense_out")
      for kind in ("weight", "bias")]
  for name, a, b in zip(names, grads_ref, grads_new):
    close(f"grad_{name}", a, b, grad_atol)
  return deviations, soft_failures
