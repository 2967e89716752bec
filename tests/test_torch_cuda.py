"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so on a machine with a card but without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(tests/conftest.py sets JAX up and is skipped by --noconftest).
"""

import numpy as np
import pytest
import torch

from samplenerfro_torch.data.rays import Rays
from samplenerfro_torch.debug import probe_so3_relu
from samplenerfro_torch.models import nerf
from samplenerfro_torch.ops import eikonal_vjp
from samplenerfro_torch.ops import grid as grid_ops
from samplenerfro_torch.ops import march_kernel
from samplenerfro_torch.ops import math as math_ops
from samplenerfro_torch.ops import mlp as mlp_ops
from samplenerfro_torch.utils import config as config_lib
from samplenerfro_torch.utils import grid_io
from samplenerfro_torch.utils import probes

# fp32 with FMA contraction off on both sides (see ops/cuda_build.py): over
# 32 steps the two agree to a few ulp; 1e-5 is the CPU tests' tolerance.
ATOL = 1e-5
S, NUM_PATH, NEAR, FAR = 32, 4, 2.0, 6.0
H = (FAR - NEAR) / (S - 1)
# The so3 march: K2 sums the MLP products in its own order, so the refined
# gradient differs from cuBLAS's by ~1e-7 a step; over 32 steps that stays
# well under the CPU tests' 1e-5.
SO3_ATOL = 1e-5
ALPHA = 0.7


@pytest.fixture
def cuda_device():
  """The first CUDA device; the test skips where there is none.

  Decided when the test runs, never at import, so every test worker
  collects the same tests.
  """
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
  return torch.device("cuda", 0)


def _march_inputs(nrays, n=64, seed=1):
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(n, 1.5, 0.33)
  spec = grid_ops.GridSpec(ndim, nmin, nmax)
  data = np.concatenate(
      [values, grid_ops.central_difference_grad_numpy(spec, values)], axis=-1)
  rng = np.random.RandomState(seed)
  d = np.array([0.0, 0.0, 1.0]) + 0.2 * rng.randn(nrays, 3)
  d /= np.linalg.norm(d, axis=-1, keepdims=True)
  o = np.array([0.1, -0.05, -4.0]) + 0.3 * rng.randn(nrays, 3)
  jitter = np.arange(0, S, NUM_PATH) + rng.randint(0, NUM_PATH, S // NUM_PATH)
  return spec, data.astype(np.float32), o.astype(np.float32), \
      d.astype(np.float32), jitter.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("nrays", [256, 100, 1, 1000, 1024, 8192])
def test_cuda_kernel_matches_plain_version(cuda_device, nrays):
  """K1 at the blocks' ragged edge (1, 100, 1000 rays: 8 a block) and at
  the radiance batch's and a render chunk's counts. The jitter stays on
  the host, where march_lean checks it."""
  spec, data, o, d, jitter = _march_inputs(nrays)
  data, o, d = [torch.from_numpy(a).to(cuda_device) for a in (data, o, d)]
  jitter = torch.from_numpy(jitter)
  before = march_kernel.march_lean.launches
  got = march_kernel.march_lean(spec, data, o, d, NEAR, H, S, jitter)
  torch.cuda.synchronize()
  assert march_kernel.march_lean.launches == before + 1
  want = march_kernel.march_lean_reference(spec, data, o, d, NEAR, H, S,
                                           jitter)
  for g, w in zip(got, want):
    assert g.device.type == "cuda"
    torch.testing.assert_close(g, w, atol=ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("nrays", [1, 100, 1024, 8192])
def test_cuda_head_off_march_matches_plain_and_k1(cuda_device, nrays):
  """K2 with the head off against its plain version, and its positions,
  directions and arclength against K1's, bit for bit (one template)."""
  spec, data, o, d, jitter = _march_inputs(nrays)
  data, o, d = [torch.from_numpy(a).to(cuda_device) for a in (data, o, d)]
  before = march_kernel.march_full_plain.launches
  got = march_kernel.march_full_plain(spec, data, o, d, NEAR, H, S)
  torch.cuda.synchronize()
  assert march_kernel.march_full_plain.launches == before + 1
  want = march_kernel.march_full_plain_reference(spec, data, o, d, NEAR, H, S)
  torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
  lean = march_kernel.march_lean(spec, data, o, d, NEAR, H, S,
                                 torch.from_numpy(jitter))
  assert torch.equal(lean[0], got[..., 0:3])
  assert torch.equal(lean[1], math_ops.safe_l2_normalize(got[..., 3:6]))
  assert torch.equal(lean[2], got[..., 6])
  with pytest.raises(ValueError):
    march_kernel.march_full_plain(spec, data, o.double(), d, NEAR, H, S)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_inputs(cuda_device):
  spec, data, o, d, jitter = _march_inputs(8, n=8)
  data, o, d = [torch.from_numpy(a).to(cuda_device) for a in (data, o, d)]
  jitter = torch.from_numpy(jitter)
  before = march_kernel.march_lean.launches
  for bad in (dict(o=o.double()), dict(d=d.t().contiguous().t()),
              dict(data=data[:-1]), dict(data=data.cpu()),
              # On the card: reading it back to check it would stall the
              # stream, so it is refused.
              dict(jitter=jitter.to(cuda_device))):
    args = dict(data=data, o=o, d=d, jitter=jitter)
    args.update(bad)
    with pytest.raises(ValueError):
      march_kernel.march_lean(spec, args["data"], args["o"], args["d"], NEAR, H,
                              S, args["jitter"])
  assert march_kernel.march_lean.launches == before


@pytest.mark.cuda
def test_cuda_march_wrappers_do_not_sync(cuda_device):
  """K1 with make_jitter's host jitter, K2, and K3 in both arms (alpha a
  tensor on the card, as the train step passes it; the bf16 arm's tile
  count is read on the card) read nothing back from the card: they run
  under the sync debug mode's "error"."""
  spec, data, o, d, _ = _march_inputs(64)
  data, o, d = [torch.from_numpy(a).to(cuda_device) for a in (data, o, d)]
  jitter = nerf.make_jitter(S // NUM_PATH, NUM_PATH,
                            torch.Generator().manual_seed(0))
  so3 = _so3_params(cuda_device)
  alpha = torch.tensor(ALPHA, device=cuda_device)
  march_kernel.march_lean(spec, data, o, d, NEAR, H, S, jitter)
  traj = march_kernel.march_full(spec, data, o, d, NEAR, H, S, so3, ALPHA)
  dtraj = torch.ones_like(traj)
  cfgs = [eikonal_vjp.MarchConfig(spec, NEAR, H, S, 10, "highest", arm)
          for arm in ("float32", "bfloat16")]
  for cfg in cfgs:
    eikonal_vjp.march_bwd(cfg, data, o, d, so3, alpha, traj, dtraj)
  torch.cuda.synchronize()
  torch.cuda.set_sync_debug_mode("error")
  try:
    march_kernel.march_lean(spec, data, o, d, NEAR, H, S, jitter)
    march_kernel.march_full(spec, data, o, d, NEAR, H, S, so3, ALPHA)
    for cfg in cfgs:
      eikonal_vjp.march_bwd(cfg, data, o, d, so3, alpha, traj, dtraj)
  finally:
    torch.cuda.set_sync_debug_mode(0)
  torch.cuda.synchronize()


def _so3_params(device, max_deg=10, width=128, std=1e-2, seed=0):
  """Seeded so3 head weights; std 1e-2 so the head visibly bends paths."""
  gen = torch.Generator().manual_seed(seed)
  head = mlp_ops.So3MLP(6 * max_deg, net_width=width, output_init_std=std,
                        generator=gen)
  return [p.detach().to(device) for p in head.params()]


def _allstage_inputs(device, nrays, seed=1):
  spec, data, o, d, _ = _march_inputs(nrays, seed=seed)
  data, o, d = [torch.from_numpy(a).to(device) for a in (data, o, d)]
  return spec, data, o, d, _so3_params(device)


@pytest.mark.cuda
@pytest.mark.parametrize("nrays", [256, 100])
def test_cuda_so3_march_matches_plain_version(cuda_device, nrays):
  spec, data, o, d, so3 = _allstage_inputs(cuda_device, nrays)
  before = march_kernel.march_full.launches
  got = march_kernel.march_full(spec, data, o, d, NEAR, H, S, so3, ALPHA)
  torch.cuda.synchronize()
  assert march_kernel.march_full.launches == before + 1
  want = march_kernel.march_full_reference(spec, data, o, d, NEAR, H, S, so3,
                                           ALPHA)
  assert got.shape == (nrays, S, 11) and got.device.type == "cuda"
  # The so3 products are summed in another order than cuBLAS sums them.
  torch.testing.assert_close(got, want, atol=SO3_ATOL, rtol=0)
  plain = march_kernel.march_lean_reference(spec, data, o, d, NEAR, H, S,
                                            torch.arange(0, S, NUM_PATH))
  assert float((plain[0] - got[..., 0:3]).abs().max()) > 10 * SO3_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("nrays,width,max_deg", [
    (1, 128, 10), (7, 128, 10), (257, 128, 10), (1000, 128, 10),
    (100, 32, 1), (100, 64, 4), (257, 32, 10), (7, 64, 1)])
def test_cuda_so3_march_ragged_and_narrow(cuda_device, nrays, width,
                                          max_deg):
  """K2 at the clusters' ragged edge (16 rays a cluster) and with heads
  narrower than the 128 columns and 60 inputs it pads to."""
  spec, data, o, d, _ = _allstage_inputs(cuda_device, nrays)
  so3 = _so3_params(cuda_device, max_deg=max_deg, width=width)
  got = march_kernel.march_full(spec, data, o, d, NEAR, H, S, so3, ALPHA,
                                max_deg)
  torch.cuda.synchronize()
  want = march_kernel.march_full_reference(spec, data, o, d, NEAR, H, S, so3,
                                           ALPHA, max_deg)
  assert got.shape == (nrays, S, 11)
  torch.testing.assert_close(got, want, atol=SO3_ATOL, rtol=0)


@pytest.mark.cuda
def test_cuda_so3_march_is_deterministic(cuda_device):
  spec, data, o, d, so3 = _allstage_inputs(cuda_device, 257)
  a = march_kernel.march_full(spec, data, o, d, NEAR, H, S, so3, ALPHA)
  b = march_kernel.march_full(spec, data, o, d, NEAR, H, S, so3, ALPHA)
  assert torch.equal(a, b)


def _sweep(spec, data, o, d, so3, seed=5):
  """K3's inputs: the plain march's trajectory, which march_bwd_reference
  replays exactly, so K3 and its plain version sweep the same path; and
  the cotangent of a seeded random linear loss."""
  cfg = eikonal_vjp.MarchConfig(spec, NEAR, H, S, 10)
  traj = march_kernel.march_full_reference(spec, data, o, d, NEAR, H, S, so3,
                                           ALPHA)
  gen = torch.Generator().manual_seed(seed)
  dtraj = torch.randn(traj.shape, generator=gen).to(traj.device)
  return cfg, traj, dtraj


def _flips(traj, so3):
  """P3 (K3's sums) and its plain version (cuBLAS, a step at a time on all
  rays, as the plain march calls the head) at every ray-step of the
  trajectory: P3's [B, S, W] pre-activations of layers 1-3, and the masks
  of the active entries whose ReLU masks the two set apart."""
  active = traj[..., 8:11].norm(dim=-1) > 1e-3
  by_step = probes.so3_preacts_by_step(traj[..., 0:3], so3, ALPHA)
  return ([k3 for k3, _ in by_step],
          [((k3 > 0) != (plain > 0)) & active[..., None]
           for k3, plain in by_step])


def _assert_grads(got, want, what):
  scale = max(float(want.abs().max()), 1e-3)
  torch.testing.assert_close(got, want, atol=2e-4 * scale, rtol=2e-3,
                             msg=lambda m: f"{what}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("seed,nrays", [(2, 256), (2, 100), (1, 100)])
def test_cuda_march_bwd_matches_plain_version(cuda_device, monkeypatch,
                                              seed, nrays):
  """K3 against autograd of the plain march, per tensor at the JAX
  package's reverse-sweep tolerance. K3 and cuBLAS sum the head's products
  in different orders; a pre-activation within that rounding of 0 passes
  ReLU on one side only (seed 1's 100 rays have one at 5e-9 in layer 3),
  and the flipped unit's cotangent at that ray-step then moves its row of
  the weight gradient and, through the layers below it, theirs: more than
  the tolerance on ~1.3k active ray-steps. P3 finds the flips; the plain
  version replays them, and K3 must then meet the tolerance everywhere."""
  spec, data, o, d, so3 = _allstage_inputs(cuda_device, nrays, seed=seed)
  cfg, traj, dtraj = _sweep(spec, data, o, d, so3)
  k3_pre, flipped = _flips(traj, so3)
  n_flips = sum(int(f.sum()) for f in flipped)
  if (seed, nrays) == (1, 100):
    assert n_flips > 0, "P3 found no flip"
  before = eikonal_vjp.march_bwd.launches
  got = eikonal_vjp.march_bwd(cfg, data, o, d, so3, ALPHA, traj, dtraj)
  torch.cuda.synchronize()
  assert eikonal_vjp.march_bwd.launches == before + 1
  if n_flips:
    monkeypatch.setattr(march_kernel, "so3_refine_fn",
                        probe_so3_relu.replaying_refine_fn(k3_pre, flipped))
  want = eikonal_vjp.march_bwd_reference(cfg, data, o, d, so3, ALPHA, dtraj)
  for name, g, w in zip(("origins", "directions", "alpha"), got[:3],
                        want[:3]):
    _assert_grads(g, w, name)
  for i, (g, w) in enumerate(zip(got[3], want[3])):
    assert g.shape == w.shape
    _assert_grads(g, w, f"so3 param {i} ({n_flips} flips replayed)")
  assert float(got[3][-2].abs().sum()) > 0


@pytest.mark.cuda
def test_cuda_march_bwd_is_deterministic(cuda_device):
  spec, data, o, d, so3 = _allstage_inputs(cuda_device, 256)
  cfg, traj, dtraj = _sweep(spec, data, o, d, so3)
  a = eikonal_vjp.march_bwd(cfg, data, o, d, so3, ALPHA, traj, dtraj)
  b = eikonal_vjp.march_bwd(cfg, data, o, d, so3, ALPHA, traj, dtraj)
  for x, y in zip(a[:3] + tuple(a[3]), b[:3] + tuple(b[3])):
    assert torch.equal(x, y)


@pytest.mark.cuda
def test_cuda_allstage_wrappers_reject_bad_inputs(cuda_device):
  spec, data, o, d, so3 = _allstage_inputs(cuda_device, 8)
  before = (march_kernel.march_full.launches, eikonal_vjp.march_bwd.launches)
  for bad in (dict(o=o.double()), dict(so3=so3[:-2]),
              dict(so3=[p.double() for p in so3]),
              dict(so3=[p.cpu() for p in so3])):
    args = dict(o=o, so3=so3)
    args.update(bad)
    with pytest.raises(ValueError):
      march_kernel.march_full(spec, data, args["o"], d, NEAR, H, S,
                              args["so3"], ALPHA)
  cfg, traj, dtraj = _sweep(spec, data, o, d, so3)
  march_kernel.march_full(spec, data, o, d, NEAR, H, S, so3, ALPHA)
  for bad in (dict(traj=traj[:, :-1]), dict(dtraj=dtraj.double()),
              dict(dtraj=dtraj.cpu())):
    args = dict(traj=traj, dtraj=dtraj)
    args.update(bad)
    with pytest.raises(ValueError):
      eikonal_vjp.march_bwd(cfg, data, o, d, so3, ALPHA, args["traj"],
                            args["dtraj"])
  assert (march_kernel.march_full.launches,
          eikonal_vjp.march_bwd.launches) == (before[0] + 1, before[1])


@pytest.mark.cuda
def test_cuda_render_matches_cpu(cuda_device):
  args, _, _ = config_lib.load_args(
      None, net_depth=4, net_width=32, num_coarse_samples=8,
      num_path_samples=4, num_fine_samples=16, use_online_sparsity=False,
      white_bkgd=False, randomized=False)
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(48, 1.5, 0.33)
  _, _, o, d, _ = _march_inputs(256)
  rays = Rays(*map(torch.from_numpy, (o, d, d, np.full((256, 1), 1e-3,
                                                       np.float32))))
  jitter = nerf.make_jitter(8, 4, torch.Generator().manual_seed(0))
  outs = []
  for dev in (cuda_device, torch.device("cpu")):
    model = nerf.construct_nerf(args, ndim, nmin, nmax, values, device=dev,
                                seed=0)
    with torch.no_grad():
      # The jitter stays on the host, where march_lean checks it.
      ret, _ = model(Rays(*[r.to(dev) for r in rays]), jitter)
    outs.append([[x.cpu() for x in level] for level in ret])
  for g_level, w_level in zip(*outs):
    for g, w in zip(g_level, w_level):
      torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


def _mlp_case(device, n, pe, seed=0, depth=4, width=128, skip=2):
  """A seeded NerfMLP (biases drawn too, so every bias path is exercised)
  and inputs on `device`: raw points/directions with pe, else features."""
  from samplenerfro_torch.models import mlp as mlp_modules
  from samplenerfro_torch.ops import mlp_kernel
  gen = torch.Generator().manual_seed(seed)
  mlp = mlp_modules.NerfMLP(63, 27, net_depth=depth, net_width=width,
                            skip_layer=skip, generator=gen)
  with torch.no_grad():
    for layer in mlp.layers:
      layer.bias.normal_(0.0, 0.1, generator=gen)
  rng = np.random.RandomState(seed)
  pts = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
  dirs = rng.randn(n, 3).astype(np.float32)
  dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
  x, c = torch.from_numpy(pts), torch.from_numpy(dirs)
  if pe is None:
    x, c = math_ops.pe_cols(x, 10), math_ops.pe_cols(c, 4)
  spec = mlp_kernel.mlp_spec(mlp, pe)
  params = [p.detach().to(device) for p in mlp_kernel.mlp_params(mlp)]
  return spec, params, x.to(device).contiguous(), c.to(device).contiguous()


# K4 against its plain version on the card. fp32: both sum fp32 products
# in different orders (the plain version through cuBLAS without TF32), a
# few ulp apart. bf16: the products are exact on both sides, but a sum in
# another order can land a pre-activation on the other side of a bf16
# rounding boundary, one bf16 ulp (2^-8 relative) that later layers carry.
# The CPU tests measure such a flip at up to 1.3e-3 in one row's raw
# outputs and 6.6e-6 in the mean (tests/test_torch_mlp_kernel.py); the same
# holds here.
K4_FP32_ATOL = 1e-5
K4_BF16_MAX, K4_BF16_MEAN = 4e-3, 3e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,pe,n", [
    (torch.float32, None, 256), (torch.float32, None, 70),
    (torch.float32, (10, 4), 130), (torch.bfloat16, None, 200),
    (torch.bfloat16, (10, 4), 64)])
def test_cuda_fused_mlp_forward_matches_plain_version(cuda_device, dtype, pe,
                                                      n):
  from samplenerfro_torch.ops import mlp_kernel
  spec, params, x, c = _mlp_case(cuda_device, n, pe)
  before = mlp_kernel.mlp_fwd.launches
  rgb, sigma = mlp_kernel.mlp_fwd(spec, params, x, c, dtype)
  torch.cuda.synchronize()
  assert mlp_kernel.mlp_fwd.launches == before + 1
  want = torch.cat(mlp_kernel.fused_nerf_mlp_reference(spec, params, x, c,
                                                       dtype), -1)
  got = torch.cat([rgb, sigma], -1)
  assert got.shape == (n, 4) and got.dtype == torch.float32
  err = (got - want).abs()
  if dtype == torch.float32:
    assert float(err.max()) <= K4_FP32_ATOL
  else:
    assert float(err.max()) <= K4_BF16_MAX
    assert float(err.mean()) <= K4_BF16_MEAN


def _k5_want(spec, params, x, c, drgb, dsigma, dtype):
  """The plain K5's gradients K5 is held to: in fp32 its own, in bf16 at
  the activations K4 stored (fused_nerf_mlp_bwd_reference's `at`), whose
  tensor-core sums round some pre-activations to the other bf16 neighbour
  than the plain version's do."""
  from samplenerfro_torch.ops import mlp_kernel
  acts = None
  if dtype == torch.bfloat16:
    acts = {}
    mlp_kernel.mlp_fwd(spec, params, x, c, dtype, acts=acts)
  return mlp_kernel.fused_nerf_mlp_bwd_reference(spec, params, x, c, drgb,
                                                 dsigma, dtype, at=acts)


def _assert_mlp_grads(got, want, frac):
  for i, (g, w) in enumerate(zip(got, want)):
    assert g.shape == w.shape
    scale = max(float(w.abs().max()), 1e-6)
    err = float((g - w).abs().max())
    assert err <= frac * scale, f"param {i}: {err} > {frac} * {scale}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,pe,n", [
    (torch.float32, None, 300), (torch.float32, (10, 4), 70),
    (torch.bfloat16, None, 256)])
def test_cuda_fused_mlp_backward_matches_plain_version(cuda_device, dtype,
                                                       pe, n):
  """K5 against its plain version, per tensor at a fraction of its scale:
  1e-4 in fp32 (summation order only), 2e-2 in bf16 (a pre-activation
  rounded to the other bf16 neighbour moves its row's contributions by an
  ulp, and a ReLU mask near 0 may flip). bf16 is held at K4's activations
  (_k5_want): K5 differentiates the forward K4 ran on tensor cores."""
  from samplenerfro_torch.ops import mlp_kernel
  spec, params, x, c = _mlp_case(cuda_device, n, pe, seed=3)
  gen = torch.Generator().manual_seed(4)
  drgb = torch.randn((n, 3), generator=gen).to(cuda_device)
  dsigma = torch.randn((n, 1), generator=gen).to(cuda_device)
  before = mlp_kernel.mlp_bwd.launches
  got = mlp_kernel.mlp_bwd(spec, params, x, c, drgb, dsigma, dtype)
  torch.cuda.synchronize()
  assert mlp_kernel.mlp_bwd.launches == before + 1
  want = _k5_want(spec, params, x, c, drgb, dsigma, dtype)
  _assert_mlp_grads(got, want, 1e-4 if dtype == torch.float32 else 2e-2)
  again = mlp_kernel.mlp_bwd(spec, params, x, c, drgb, dsigma, dtype)
  assert all(torch.equal(a, b) for a, b in zip(got, again))


# Row counts around the kernels' tiles (64 rows in fp32, 128 in bf16) and a
# count that leaves each K5 block's range (39,601 rows over the card's SMs)
# short of a whole number of 256-row super-tiles; widths 128 and 256 with
# and without the skip layer (depth 3, skip 4 has none); fed and pe.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,pe,n,width,depth,skip,super_rows", [
    (torch.float32, None, 1, 128, 4, 2, 1024),
    (torch.float32, (10, 4), 63, 256, 3, 4, 1024),
    (torch.float32, None, 65, 256, 4, 2, 1024),
    (torch.float32, (10, 4), 39601, 256, 4, 2, 256),
    (torch.bfloat16, (10, 4), 1, 256, 4, 2, 1024),
    (torch.bfloat16, None, 127, 128, 3, 4, 1024),
    (torch.bfloat16, (10, 4), 129, 256, 4, 2, 1024),
    (torch.bfloat16, None, 39601, 128, 4, 2, 256)])
def test_cuda_fused_mlp_tiling(cuda_device, dtype, pe, n, width, depth, skip,
                               super_rows):
  """K4 and K5 against their plain versions at the tolerances above (K5 in
  bf16 at K4's activations), K5 bit for bit across two runs, at the edges
  of the new tiling."""
  from samplenerfro_torch.ops import mlp_kernel
  spec, params, x, c = _mlp_case(cuda_device, n, pe, depth=depth,
                                 width=width, skip=skip, seed=5)
  got = torch.cat(mlp_kernel.mlp_fwd(spec, params, x, c, dtype), -1)
  want = torch.cat(mlp_kernel.fused_nerf_mlp_reference(spec, params, x, c,
                                                       dtype), -1)
  err = (got - want).abs()
  if dtype == torch.float32:
    assert float(err.max()) <= K4_FP32_ATOL
  else:
    assert float(err.max()) <= K4_BF16_MAX
    assert float(err.mean()) <= K4_BF16_MEAN
  gen = torch.Generator().manual_seed(6)
  drgb = torch.randn((n, 3), generator=gen).to(cuda_device)
  dsigma = torch.randn((n, 1), generator=gen).to(cuda_device)
  args = (spec, params, x, c, drgb, dsigma, dtype)
  grads = mlp_kernel.mlp_bwd(*args, super_rows=super_rows)
  _assert_mlp_grads(grads, _k5_want(*args),
                    1e-4 if dtype == torch.float32 else 2e-2)
  again = mlp_kernel.mlp_bwd(*args, super_rows=super_rows)
  assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.cuda
def test_cuda_fused_mlp_autograd_and_ship_width(cuda_device):
  """Through the autograd Function at the ship's 8x256 width: one K4 and
  one K5 launch, gradients for the weights only."""
  from samplenerfro_torch.ops import mlp_kernel
  spec, params, x, c = _mlp_case(cuda_device, 100, (10, 4), depth=8,
                                 width=256, skip=4)
  params = [p.requires_grad_() for p in params]
  before = (mlp_kernel.mlp_fwd.launches, mlp_kernel.mlp_bwd.launches)
  rgb, sigma = mlp_kernel.FusedNerfMLP.apply(spec, torch.float32, x, c,
                                             *params)
  (rgb.square().sum() + sigma.sum()).backward()
  assert (mlp_kernel.mlp_fwd.launches,
          mlp_kernel.mlp_bwd.launches) == (before[0] + 1, before[1] + 1)
  ref = [p.detach().clone().requires_grad_() for p in params]
  r_rgb, r_sigma = mlp_kernel.fused_nerf_mlp_reference(spec, ref, x, c,
                                                       torch.float32)
  (r_rgb.square().sum() + r_sigma.sum()).backward()
  _assert_mlp_grads([p.grad for p in params], [p.grad for p in ref], 1e-4)
  with pytest.raises(ValueError, match="require grad"):
    mlp_kernel.FusedNerfMLP.apply(spec, torch.float32,
                                  x.clone().requires_grad_(), c, *params)


@pytest.mark.cuda
def test_cuda_probes(cuda_device):
  from samplenerfro_torch.utils import probes
  x = probes.probe_inputs((8, 128)).to(cuda_device)
  assert torch.equal(probes.add_one(x), x + 1)
  for scale, err64, err_lib in probes.sin_errors(cuda_device):
    # CUDA documents sinf at 2 ulp: at |x| <= 8192 that is <= 1e-6 of a
    # value in [-1, 1].
    assert err64 <= 1e-6, (scale, err64)
    assert err_lib <= 1e-6, (scale, err_lib)


def _p3_case(device, n, width, max_deg, seed):
  gen = torch.Generator().manual_seed(seed)
  head = mlp_ops.So3MLP(6 * max_deg, net_width=width, output_init_std=1e-2,
                        generator=gen)
  so3 = [p.detach().clone() for p in head.params()]
  for b in so3[1::2]:
    b.normal_(0.0, 0.1, generator=gen)
  pos = torch.rand((n, 3), generator=gen) * 3.0 - 1.5
  return pos.to(device), [p.to(device) for p in so3]


# P3 against its plain version: the same fp32 products summed in other
# orders (K3's k order against cuBLAS's), a few ulp of the largest
# pre-activation apart.
P3_ATOL = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("n,width,max_deg,alpha", [
    (1000, 128, 10, 0.6), (37, 48, 6, 0.45)])
def test_cuda_so3_preacts_matches_plain_version(cuda_device, n, width,
                                                max_deg, alpha):
  pos, so3 = _p3_case(cuda_device, n, width, max_deg, seed=n)
  before = probes.so3_preacts.launches
  got = probes.so3_preacts(pos, so3, alpha, max_deg)
  torch.cuda.synchronize()
  assert probes.so3_preacts.launches == before + 1
  want = probes.so3_preacts_reference(pos, so3, alpha, max_deg)
  scale = max(float(w.abs().max()) for w in want)
  for g, w in zip(got, want):
    assert g.shape == (n, width) and g.device.type == "cuda"
    assert float((g - w).abs().max()) <= P3_ATOL * scale
  again = probes.so3_preacts(pos, so3, alpha, max_deg)
  assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_cuda_so3_preacts_rejects_bad_inputs(cuda_device):
  pos, so3 = _p3_case(cuda_device, 16, 128, 10, seed=0)
  wide_pos, wide = _p3_case(cuda_device, 16, 129, 10, seed=0)
  before = probes.so3_preacts.launches
  for args in ((pos.double(), so3, 10), (pos[:, :2], so3, 10),
               (pos.t().contiguous().t(), so3, 10),
               (pos, [p.cpu() for p in so3], 10), (pos, so3[:-2], 10),
               (wide_pos, wide, 10), (pos, so3, 11)):
    with pytest.raises(ValueError):
      probes.so3_preacts(args[0], args[1], 0.6, args[2])
  assert probes.so3_preacts.launches == before


@pytest.mark.cuda
def test_cuda_selfcheck_passes(cuda_device):
  from samplenerfro_torch.train import selfcheck
  before = (march_kernel.march_lean.launches,
            march_kernel.march_full.launches, eikonal_vjp.march_bwd.launches)
  deviations, not_run = selfcheck.check_march()
  after = (march_kernel.march_lean.launches,
           march_kernel.march_full.launches, eikonal_vjp.march_bwd.launches)
  assert all(a > b for a, b in zip(after, before))
  assert "grad_so3.Dense_0.bias" in deviations
  assert [m.split(":")[0] for m in not_run] == [
      name for name, _ in selfcheck.SKIPPED_ARMS]


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(1, 0), (3, 0), (1024, 0), (1027, 0),
                                      (70001, 0), (1024, 1), (37, 3)])
def test_cuda_add_one_is_exact(cuda_device, n, offset):
  """P1 on float4 loads with a scalar tail, and all scalar on a view that
  starts off 16 bytes."""
  x = torch.randn(n + offset, generator=torch.Generator().manual_seed(n))
  x = x.to(cuda_device)[offset:]
  assert torch.equal(probes.add_one(x), x + 1)


def _shape_inputs(device, shape, nrays=1024, seed=7):
  """The 'all' batch's shapes on a synthetic blob: the ship's (512^3 grid
  of extent 1.5 prefiltered 9/3, 768 steps from near 2 to far 6) or
  glass's (384^3 of extent 3.5 prefiltered 5/3, 1536 steps from 0.2 to
  14); rays from a camera at radius 4 towards the blob."""
  n, extent, ks, sigma, near, far, steps = {
      "ship": (512, 1.5, 9, 3.0, 2.0, 6.0, 768),
      "glass": (384, 3.5, 5, 3.0, 0.2, 14.0, 1536)}[shape]
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(n, extent, 0.33)
  spec = grid_ops.GridSpec(ndim, nmin, nmax)
  vals = grid_ops.gaussian_prefilter(torch.from_numpy(values).to(device),
                                     tuple(ndim), ks, sigma)
  data = torch.cat([vals, grid_ops.central_difference_grad(spec, vals)],
                   -1).contiguous()
  rng = np.random.RandomState(seed)
  eye = np.array([4.0 * np.cos(0.6), 4.0 * np.sin(0.6), 1.2])
  d = -eye / np.linalg.norm(eye) + 0.12 * rng.randn(nrays, 3)
  d /= np.linalg.norm(d, axis=-1, keepdims=True)
  o = np.broadcast_to(eye, d.shape)
  o, d = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
          for a in (o, d)]
  so3 = _so3_params(device)
  cfg = eikonal_vjp.MarchConfig(spec, near, (far - near) / (steps - 1),
                                steps, 10)
  traj = march_kernel.march_full_reference(spec, data, o, d, near,
                                           cfg.step_size, steps, so3, ALPHA)
  gen = torch.Generator().manual_seed(seed)
  dtraj = torch.randn(traj.shape, generator=gen).to(device)
  return cfg, data, o, d, so3, traj, dtraj


def _assert_k3(got, want, what):
  """The K3 tolerance per tensor: |got - want| <= 2e-4 max|want| + 2e-3
  |want|."""
  scale = float(want.abs().max())
  bound = 2e-4 * scale + 2e-3 * want.abs()
  assert bool(torch.isfinite(got).all()), what
  assert bool(((got - want).abs() <= bound).all()), (
      what, float((got - want).abs().max()), scale)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["ship", "glass"])
def test_cuda_march_bwd_at_the_shipped_shapes(cuda_device, monkeypatch,
                                              shape):
  """K3 (three passes) at the 'all' batch's ship and glass shapes against
  its two plain versions: the three-pass one and autograd of the plain
  march, this one with P3's ReLU flips replayed; two runs bit for bit."""
  cfg, data, o, d, so3, traj, dtraj = _shape_inputs(cuda_device, shape)
  active = traj[..., 8:11].norm(dim=-1) > 1e-3
  assert 0.05 < float(active.float().mean()) < 0.95
  args = (cfg, data, o, d, so3, ALPHA)
  before = eikonal_vjp.march_bwd.launches
  got = eikonal_vjp.march_bwd(*args, traj, dtraj)
  again = eikonal_vjp.march_bwd(*args, traj, dtraj)
  torch.cuda.synchronize()
  assert eikonal_vjp.march_bwd.launches == before + 2
  flat = lambda r: [r[0], r[1], r[2]] + list(r[3])
  assert all(torch.equal(a, b) for a, b in zip(flat(got), flat(again)))
  del again
  passes = eikonal_vjp.march_bwd_passes_reference(*args, traj, dtraj)
  for i, (g, w) in enumerate(zip(flat(got), flat(passes))):
    _assert_k3(g, w, f"{shape}: against the passes, tensor {i}")
  del passes
  pos = traj[..., 0:3]
  by_step = probes.so3_preacts_by_step(pos, so3, ALPHA)
  k3_pre = [k3 for k3, _ in by_step]
  flipped = [((k3 > 0) != (plain > 0)) & active[..., None]
             for k3, plain in by_step]
  del by_step
  if any(bool(f.any()) for f in flipped):
    monkeypatch.setattr(march_kernel, "so3_refine_fn",
                        probe_so3_relu.replaying_refine_fn(k3_pre, flipped))
  want = eikonal_vjp.march_bwd_reference(*args, dtraj)
  for i, (g, w) in enumerate(zip(flat(got), flat(want))):
    _assert_k3(g, w, f"{shape}: against autograd, tensor {i}")


# The geometries that `supports` admits past the ship MLP's (fault F1).
WIDE_CASES = [(384, 10, None), (512, 10, None), (1024, 10, None),
              (256, 16, (16, 4))]


def _wide_case(device, n, width, deg, pe, seed=0):
  from samplenerfro_torch.models import mlp as mlp_modules
  from samplenerfro_torch.ops import mlp_kernel
  gen = torch.Generator().manual_seed(seed)
  mlp = mlp_modules.NerfMLP(3 + 6 * deg, 27, net_depth=8, net_width=width,
                            net_width_condition=width, skip_layer=4,
                            generator=gen)
  with torch.no_grad():
    for layer in mlp.layers:
      layer.bias.normal_(0.0, 0.1, generator=gen)
  rng = np.random.RandomState(seed)
  pts = torch.from_numpy(rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32))
  dirs = torch.from_numpy(rng.randn(n, 3).astype(np.float32))
  dirs = dirs / dirs.norm(dim=-1, keepdim=True)
  x, c = ((pts, dirs) if pe is not None else
          (math_ops.pe_cols(pts, deg), math_ops.pe_cols(dirs, 4)))
  spec = mlp_kernel.mlp_spec(mlp, pe)
  params = [p.detach().to(device) for p in mlp_kernel.mlp_params(mlp)]
  return spec, params, x.to(device).contiguous(), c.to(device).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width,deg,pe", WIDE_CASES)
def test_cuda_fused_mlp_wide_geometries(cuda_device, width, deg, pe, dtype):
  """K4 and K5 at widths 384, 512 and 1024 and at pallas_pe with
  max_deg_point 16, against their plain versions at the tolerances of the
  tests above; K5 twice, bit for bit."""
  from samplenerfro_torch.ops import mlp_kernel
  n = 4096
  spec, params, x, c = _wide_case(cuda_device, n, width, deg, pe)
  assert mlp_kernel.wide(spec)
  got = torch.cat(mlp_kernel.mlp_fwd(spec, params, x, c, dtype), -1)
  want = torch.cat(mlp_kernel.fused_nerf_mlp_reference(spec, params, x, c,
                                                       dtype), -1)
  err = (got - want).abs()
  if dtype == torch.float32:
    assert float(err.max()) <= K4_FP32_ATOL
  else:
    assert float(err.max()) <= K4_BF16_MAX
    assert float(err.mean()) <= K4_BF16_MEAN
  gen = torch.Generator().manual_seed(1)
  drgb = (0.1 * torch.randn((n, 3), generator=gen)).to(cuda_device)
  dsigma = (0.1 * torch.randn((n, 1), generator=gen)).to(cuda_device)
  args = (spec, params, x, c, drgb, dsigma, dtype)
  g5 = mlp_kernel.mlp_bwd(*args)
  assert all(torch.equal(a, b) for a, b in zip(g5,
                                                 mlp_kernel.mlp_bwd(*args)))
  # Where K4's sums and cuBLAS's round a pre-activation at 0 to opposite
  # sides, the plain version replays K4's activations (the K3 tests replay
  # P3's flips the same way).
  acts, plain_acts = {}, {}
  mlp_kernel.mlp_fwd(spec, params, x, c, dtype, acts=acts)
  want = mlp_kernel.fused_nerf_mlp_bwd_reference(*args, stored=plain_acts)
  if any(bool(((acts[k] > 0) != (plain_acts[k] > 0)).any()) for k in acts):
    want = mlp_kernel.fused_nerf_mlp_bwd_reference(*args, at=acts)
  _assert_mlp_grads(g5, want, 1e-4 if dtype == torch.float32 else 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("width,deg,pe", [(256, 10, None)] + WIDE_CASES[2:])
def test_cuda_k5_recomputes_k4_activations(cuda_device, width, deg, pe):
  """Fault F2: in bf16, the activations K5 stores are K4's, bit for bit,
  so the weight gradients belong to the forward that made the loss."""
  from samplenerfro_torch.ops import mlp_kernel
  n = 1000
  spec, params, x, c = _wide_case(cuda_device, n, width, deg, pe, seed=2)
  acts = {}
  mlp_kernel.mlp_fwd(spec, params, x, c, torch.bfloat16, acts=acts)
  gen = torch.Generator().manual_seed(3)
  drgb = torch.randn((n, 3), generator=gen).to(cuda_device)
  dsigma = torch.randn((n, 1), generator=gen).to(cuda_device)
  stash = {}
  mlp_kernel.mlp_bwd(spec, params, x, c, drgb, dsigma, torch.bfloat16,
                     super_rows=1024, stash=stash)
  stored = mlp_kernel.stored_values(spec, stash, n)
  for name, value in acts.items():
    assert torch.equal(stored[name], value), name


# The bf16 arm's tensor-core engines at the edges of their tiles: the
# warpgroup engine (128-row tiles of two 64-row warpgroups) at row counts
# around a warpgroup and a tile and at 39,601 rows (each K5 block's range
# short of a whole tile), widths 128 and 256 with and without the skip
# layer (depth 3, skip 4 has none), fed and pe; mma.sync at a wide
# geometry (width 512: 32-row tiles).
BF16_ENGINE_CASES = [
    (1, 256, 4, 2, (10, 4)), (63, 128, 3, 4, None), (64, 256, 4, 2, None),
    (65, 256, 3, 4, (10, 4)), (127, 128, 4, 2, None),
    (129, 128, 3, 4, (10, 4)), (39601, 256, 4, 2, None),
    (39601, 128, 3, 4, (10, 4)), (1000, 512, 4, 2, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,width,depth,skip,pe", BF16_ENGINE_CASES)
def test_cuda_fused_mlp_bf16_engines(cuda_device, n, width, depth, skip, pe):
  """bf16 K4 within its tolerances of its plain version; K5's stored
  activations K4's bit for bit (F2); K5 at the bf16 fraction of the tests
  above (2e-2 of each tensor's scale) of the plain backward at K4's
  activations; each kernel twice, bit for bit."""
  from samplenerfro_torch.ops import mlp_kernel
  bf16 = torch.bfloat16
  spec, params, x, c = _mlp_case(cuda_device, n, pe, depth=depth,
                                 width=width, skip=skip, seed=7)
  assert mlp_kernel.warpgroup(spec, bf16) == (width <= 256)
  acts = {}
  got = torch.cat(mlp_kernel.mlp_fwd(spec, params, x, c, bf16, acts=acts),
                  -1)
  again = torch.cat(mlp_kernel.mlp_fwd(spec, params, x, c, bf16), -1)
  assert torch.equal(got, again)
  err = (got - torch.cat(mlp_kernel.fused_nerf_mlp_reference(
      spec, params, x, c, bf16), -1)).abs()
  assert float(err.max()) <= K4_BF16_MAX
  assert float(err.mean()) <= K4_BF16_MEAN
  gen = torch.Generator().manual_seed(8)
  drgb = (1e-3 * torch.randn((n, 3), generator=gen)).to(cuda_device)
  dsigma = (1e-3 * torch.randn((n, 1), generator=gen)).to(cuda_device)
  args = (spec, params, x, c, drgb, dsigma, bf16)
  stash = {}
  grads = mlp_kernel.mlp_bwd(*args, stash=stash)
  stored = mlp_kernel.stored_values(spec, stash, n)
  for name, value in acts.items():
    assert torch.equal(stored[name], value), name
  assert all(torch.equal(a, b) for a, b in zip(grads,
                                                 mlp_kernel.mlp_bwd(*args)))
  want = mlp_kernel.fused_nerf_mlp_bwd_reference(*args, at=acts)
  _assert_mlp_grads(grads, want, 2e-2)


DISPATCH_KERNELS = ("march_lean_kernel", "march_so3_kernel", "k3_sweep",
                    "mlp_fwd_kernel", "mlp_bwd_kernel")


def _dispatch_run(device, stage, k, mlp_kernel_name, want, steps=9,
                  tries=3):
  """`steps` train steps from step 4 of a tiny seeded model, K a dispatch
  (train/step.make_train_step_multi) on loop.host_window's batches, then
  windows of 3 steps, each under torch.profiler on its own, until one
  launches `want` (K1, K2, K3, K4, K5; the profiler can drop a record)
  or `tries` were traced: (the first `steps` steps' Stats, parameters and
  Adam state and the wrappers' launches after them, the launches traced
  in each window, the dispatch)."""
  from torch.profiler import ProfilerActivity
  from torch.profiler import profile as tprofile
  from samplenerfro_torch.data import prefetch
  from samplenerfro_torch.debug.march_parity import kernel_launches
  from samplenerfro_torch.ops import eikonal_vjp
  from samplenerfro_torch.ops import march_kernel
  from samplenerfro_torch.ops import mlp_kernel
  from samplenerfro_torch.train import loop
  from samplenerfro_torch.train import step as step_lib
  width = 128 if mlp_kernel_name != "xla" else 32
  args, _, _ = config_lib.load_args(
      None, stage=stage, net_depth=2, net_width=width,
      net_width_condition=width, num_coarse_samples=8, num_path_samples=4,
      num_fine_samples=16, max_deg_point=4, use_online_sparsity=False,
      white_bkgd=False, bg_weight=0.025, bg_smooth_weight=1.0,
      bg_patch_size=4, anneal_delay_steps=1, anneal_max_steps=20,
      lr_delay_steps=2, mlp_kernel=mlp_kernel_name, mlp_dtype="bfloat16")
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(32, 1.5, 0.33)
  model = nerf.construct_nerf(args, ndim, nmin, nmax, values, device=device,
                              seed=0)
  optimizer, _, _ = step_lib.create_optimizer(model, args)
  run = step_lib.make_train_step_multi(
      model, optimizer, args, k,
      torch.Generator(device=device).manual_seed(3))
  jitter_gen = torch.Generator().manual_seed(4)

  def host(i):
    _, _, o, d, _ = _march_inputs(64, seed=i)
    env = d[:16].reshape(4, 4, 3).copy()
    return {"pixels": np.random.RandomState(i).rand(64, 3).astype(
                np.float32),
            "rays": Rays(o, d, d, np.full((64, 1), 1e-3, np.float32)),
            "env_rays": Rays(env, env, env,
                             np.full((4, 4, 1), 1e-3, np.float32))}

  first = 4  # on the grid of 3: windows 4-6, 7-9, 10-12, ...
  last = first + steps - 1
  dataset = iter([host(i) for i in range(steps + 3 * tries)])
  wrappers = (march_kernel.march_lean, march_kernel.march_full,
              eikonal_vjp.march_bwd, mlp_kernel.mlp_fwd, mlp_kernel.mlp_bwd)
  before = [w.launches for w in wrappers]
  stats, prof, traced = [], None, []
  for w0, w1 in loop.dispatch_windows(first, last + 3 * tries, k):
    batch = prefetch.to_device(
        loop.host_window(dataset, w0, w1, args, optimizer, jitter_gen),
        device)
    if w0 > last and (w0 - last - 1) % 3 == 0:
      torch.cuda.synchronize()
      prof = tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA])
      prof.__enter__()
    out = run(batch).per_step()
    if w1 <= last:
      stats += out
    if w1 == last:
      state = {f"p.{n}": p.detach().clone()
               for n, p in model.named_parameters()}
      for i, s in optimizer.state_dict()["state"].items():
        state.update({f"{i}.{n}": torch.as_tensor(t).clone()
                      for n, t in s.items()})
      launches = [w.launches - b for w, b in zip(wrappers, before)]
    if prof is not None and (w1 - last) % 3 == 0:
      torch.cuda.synchronize()
      prof.__exit__(None, None, None)
      traced.append(list(kernel_launches(prof.key_averages(),
                                         DISPATCH_KERNELS).values()))
      prof = None
      if traced[-1] == want:
        break
  return stats, state, launches, traced, run


@pytest.mark.cuda
@pytest.mark.parametrize("stage,mlp", [("radiance", "xla"), ("all", "xla"),
                                       ("radiance", "pallas")])
def test_cuda_graph_dispatch_matches_eager_steps(cuda_device, stage, mlp):
  """9 randomized steps: 3 a dispatch (an eager window, then a captured
  graph replayed twice) against one at a time, bit for bit: every Stats
  field of every step (the replays drew fresh numbers, in the eager
  order), every parameter and Adam moment and count. The wrappers count
  the steps run in Python (3 eager, 3 captured). A replay after them,
  traced by torch.profiler, launches each kernel as 3 eager steps traced
  the same way do, and no traced window launches more."""
  per_step = {"radiance": [1, 0, 0], "all": [0, 1, 1]}[stage]
  per_step += [2, 2] if mlp != "xla" else [0, 0]
  want = [3 * n for n in per_step]
  eager, e_state, e_launches, e_traced, _ = _dispatch_run(
      cuda_device, stage, 1, mlp, want)
  graph, g_state, g_launches, g_traced, run = _dispatch_run(
      cuda_device, stage, 3, mlp, want)
  assert run.replays == 2 + len(g_traced) and run.graph is not None
  assert graph == eager
  assert len({s.loss for s in graph}) == 9
  assert e_state.keys() == g_state.keys()
  for key in e_state:
    assert torch.equal(e_state[key], g_state[key]), key
  assert e_launches == [9 * n for n in per_step]
  assert g_launches == [6 * n for n in per_step]
  for traced in (e_traced, g_traced):
    assert traced[-1] == want
    assert all(t <= w for window in traced for t, w in zip(window, want))


def _ior_run(device, k, wdm, steps=9):
  """`steps` `ior` steps from step 4 of a tiny seeded model, k a dispatch,
  on Grid batches of a 32^3 blob: (their Stats, parameters and Adam state
  after them, the state before, the dispatch)."""
  from samplenerfro_torch.data import prefetch
  from samplenerfro_torch.train import loop
  from samplenerfro_torch.train import step as step_lib
  args, _, _ = config_lib.load_args(
      None, stage="ior", net_depth=2, net_width=32, net_width_condition=32,
      num_coarse_samples=8, num_path_samples=4, num_fine_samples=16,
      max_deg_point=4, use_online_sparsity=False, extra_batch_size=16,
      anneal_delay_steps=1, anneal_max_steps=20, lr_delay_steps=2,
      weight_decay_mult=wdm)
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(32, 1.5, 0.33)
  model = nerf.construct_nerf(args, ndim, nmin, nmax, values, device=device,
                              seed=0)
  optimizer, _, _ = step_lib.create_optimizer(model, args)
  grid = loop.model_grid(model, args, np.random.RandomState(5))

  def state():
    out = {f"p.{n}": p.detach().clone() for n, p in model.named_parameters()}
    for i, s in optimizer.state_dict()["state"].items():
      out.update({f"{i}.{n}": torch.as_tensor(t).clone()
                  for n, t in s.items()})
    return out

  start = state()
  run = step_lib.make_train_step_multi(
      model, optimizer, args, k,
      torch.Generator(device=device).manual_seed(3))
  stats = []
  for w0, w1 in loop.dispatch_windows(4, 3 + steps, k):
    batch = prefetch.to_device(
        loop.host_window(grid, w0, w1, args, optimizer, None), device)
    stats += run(batch).per_step()
  return stats, state(), start, run


@pytest.mark.cuda
@pytest.mark.parametrize("wdm", [0.0, 1e-2])
def test_ior_graph_matches_eager_steps(cuda_device, wdm):
  """9 `ior` steps, 3 a dispatch (an eager window, then a graph that draws
  the smoothness offsets from the registered generator, replayed twice),
  against one at a time, bit for bit; as shipped (weight_decay_mult 0)
  nothing moves, with weight decay only the so3 head does."""
  eager, e_state, start, _ = _ior_run(cuda_device, 1, wdm)
  graph, g_state, _, run = _ior_run(cuda_device, 3, wdm)
  assert run.replays == 2
  assert eager == graph
  for key, v in e_state.items():
    assert torch.equal(v, g_state[key]), key
  moved = {key for key, v in e_state.items()
           if key.startswith("p.") and not torch.equal(v, start[key])}
  if wdm == 0.0:
    assert not moved
  else:
    assert moved and all("so3_mlp" in key for key in moved)
  assert {s.loss_nrm for s in eager} == {0.0}


# The model options on the card: (stage, flags, gin) of each path.
OPTION_CASES = {
    "radiance_online_sparsity": ("radiance", {"use_online_sparsity": True},
                                 {}),
    "radiance_ipe_pallas": ("radiance", {"mlp_kernel": "pallas"},
                            {"NerfModel.use_ipe": True}),
    "radiance_sh": ("radiance", {"sh_deg": 2, "sh_direnc_deg": 4,
                                 "use_viewdirs": False,
                                 "bg_smooth_weight": 0.0}, {}),
    "all_ipe_online_sparsity": ("all", {"use_online_sparsity": True},
                                {"NerfModel.use_ipe": True}),
    "all_spherical_head": ("all", {}, {"VoxMLP.use_direct_output": False}),
}


def _option_run(device, stage, k, flags, gin, steps=6):
  """`steps` train steps from step 4 of a tiny seeded model with the
  option's flags and gin bindings, k a dispatch: (their Stats, parameters
  and Adam state after them, the launches of K1, K2, K3, K2 with the
  head off, K4 and K5 through their wrappers)."""
  from samplenerfro_torch.data import prefetch
  from samplenerfro_torch.ops import mlp_kernel
  from samplenerfro_torch.train import loop
  from samplenerfro_torch.train import step as step_lib
  overrides = dict(
      stage=stage, net_depth=2, net_width=128, net_width_condition=128,
      num_coarse_samples=8, num_path_samples=4, num_fine_samples=16,
      max_deg_point=4, use_online_sparsity=False, white_bkgd=False,
      bg_weight=0.025, bg_smooth_weight=1.0, bg_patch_size=4,
      anneal_delay_steps=1, anneal_max_steps=20, lr_delay_steps=2,
      mlp_dtype="bfloat16")
  overrides.update(flags)
  args, _, _ = config_lib.load_args(None, **overrides)
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(32, 1.5, 0.33)
  model = nerf.construct_nerf(args, ndim, nmin, nmax, values, gin,
                              device=device, seed=0)
  optimizer, _, _ = step_lib.create_optimizer(model, args)
  run = step_lib.make_train_step_multi(
      model, optimizer, args, k,
      torch.Generator(device=device).manual_seed(3))
  jitter_gen = torch.Generator().manual_seed(4)

  def host(i):
    _, _, o, d, _ = _march_inputs(64, seed=i)
    env = d[:16].reshape(4, 4, 3).copy()
    return {"pixels": np.random.RandomState(i).rand(64, 3).astype(
                np.float32),
            "rays": Rays(o, d, d, np.full((64, 1), 1e-3, np.float32)),
            "env_rays": Rays(env, env, env,
                             np.full((4, 4, 1), 1e-3, np.float32))}

  dataset = iter([host(i) for i in range(steps)])
  wrappers = (march_kernel.march_lean, march_kernel.march_full,
              eikonal_vjp.march_bwd, march_kernel.march_full_plain,
              mlp_kernel.mlp_fwd, mlp_kernel.mlp_bwd)
  before = [w.launches for w in wrappers]
  stats = []
  for w0, w1 in loop.dispatch_windows(4, 3 + steps, k):
    stats += run(prefetch.to_device(
        loop.host_window(dataset, w0, w1, args, optimizer, jitter_gen),
        device)).per_step()
  torch.cuda.synchronize()
  state = {f"p.{n}": p.detach().clone() for n, p in model.named_parameters()}
  for i, s in optimizer.state_dict()["state"].items():
    state.update({f"{i}.{n}": torch.as_tensor(t).clone()
                  for n, t in s.items()})
  return stats, state, [w.launches - b for w, b in zip(wrappers, before)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(OPTION_CASES))
def test_cuda_option_path_graph_matches_eager_steps(cuda_device, case):
  """Each option's train step, 3 a dispatch (an eager window, then a CUDA
  graph) against one at a time, bit for bit; launched through the
  kernels the JAX package would use: online sparsity's radiance step K2
  with the head off and not K1, the spherical head's 'all' step neither
  K2 nor K3 (its plain march), IPE with --mlp_kernel=pallas K4 and K5 at
  60 features."""
  stage, flags, gin = OPTION_CASES[case]
  eager, e_state, e_launches = _option_run(cuda_device, stage, 1, flags, gin)
  graph, g_state, g_launches = _option_run(cuda_device, stage, 3, flags, gin)
  assert graph == eager
  assert all(np.isfinite(s.loss) for s in graph)
  assert e_state.keys() == g_state.keys()
  for key in e_state:
    assert torch.equal(e_state[key], g_state[key]), key
  online = bool(flags.get("use_online_sparsity"))
  fused = flags.get("mlp_kernel") == "pallas"
  if stage == "radiance":
    per = [0, 0, 0, 1] if online else [1, 0, 0, 0]
  else:
    shipped_head = "VoxMLP.use_direct_output" not in gin
    per = [0, 1, 1, 0] if shipped_head else [0, 0, 0, 0]
  per += [2, 2] if fused else [0, 0]
  assert e_launches == [6 * n for n in per]
  assert g_launches == [6 * n for n in per]  # 3 eager, 3 captured


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["radiance", "all"])
def test_cuda_gated_online_sparsity_moves_no_bit(cuda_device, stage):
  """Online sparsity, gated at 0 by the annealing rate as shipped, leaves
  6 steps (3 a dispatch) bit for bit the steps without it; in radiance
  its march is K2 with the head off, whose gathered subsample is K1's."""
  _, off, _ = _option_run(cuda_device, stage, 3, {}, {})
  _, on, _ = _option_run(cuda_device, stage, 3,
                         {"use_online_sparsity": True,
                          "sparsity_weight": 0.1}, {})
  assert off.keys() == on.keys()
  for key in off:
    assert torch.equal(off[key], on[key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("feat,cond", [(60, 27), (63, 16)])
def test_cuda_fused_mlp_at_option_widths(cuda_device, feat, cond, dtype):
  """K4 and K5 at the input widths the options give them: IPE's 60
  features, the SH direction encoding's 16 condition values; against
  their plain versions at the tolerances above, K5 twice, bit for bit."""
  from samplenerfro_torch.models import mlp as mlp_modules
  from samplenerfro_torch.ops import mlp_kernel
  n = 4096
  gen = torch.Generator().manual_seed(5)
  mlp = mlp_modules.NerfMLP(feat, cond, net_depth=8, net_width=256,
                            net_width_condition=128, skip_layer=4,
                            generator=gen)
  assert mlp_kernel.supports(feat, cond, 8, 256, 4, 1, 128, 3, 1)
  spec = mlp_kernel.mlp_spec(mlp)
  params = [p.detach().to(cuda_device) for p in mlp_kernel.mlp_params(mlp)]
  x = torch.sin(3 * torch.randn((n, feat), generator=gen)).to(cuda_device)
  c = torch.sin(3 * torch.randn((n, cond), generator=gen)).to(cuda_device)
  got = torch.cat(mlp_kernel.mlp_fwd(spec, params, x, c, dtype), -1)
  want = torch.cat(mlp_kernel.fused_nerf_mlp_reference(spec, params, x, c,
                                                       dtype), -1)
  err = (got - want).abs()
  if dtype == torch.float32:
    assert float(err.max()) <= K4_FP32_ATOL
  else:
    assert float(err.max()) <= K4_BF16_MAX
    assert float(err.mean()) <= K4_BF16_MEAN
  drgb = (0.1 * torch.randn((n, 3), generator=gen)).to(cuda_device)
  dsigma = (0.1 * torch.randn((n, 1), generator=gen)).to(cuda_device)
  args = (spec, params, x, c, drgb, dsigma, dtype)
  g5 = mlp_kernel.mlp_bwd(*args)
  assert all(torch.equal(a, b) for a, b in zip(g5,
                                                 mlp_kernel.mlp_bwd(*args)))
  acts, plain_acts = {}, {}
  mlp_kernel.mlp_fwd(spec, params, x, c, dtype, acts=acts)
  want = mlp_kernel.fused_nerf_mlp_bwd_reference(*args, stored=plain_acts)
  if any(bool(((acts[k] > 0) != (plain_acts[k] > 0)).any()) for k in acts):
    want = mlp_kernel.fused_nerf_mlp_bwd_reference(*args, at=acts)
  _assert_mlp_grads(g5, want, 1e-4 if dtype == torch.float32 else 2e-2)


@pytest.mark.cuda
def test_cuda_flax_fixture_resumes_and_dispatches_bit_for_bit(cuda_device,
                                                             tmp_path):
  """The JAX-written fixture decodes on the card's machine (libzstd, no
  flax), and its orbax state resumed for two windows of 10 radiance steps
  (an eager window, then a CUDA graph) is bit for bit 20 steps one at a
  time from the same restored state: every Stats field, parameter, Adam
  moment and count."""
  from samplenerfro_torch.debug import flax_fixture
  assert flax_fixture.check()["leaves"] > 100
  runs = {}
  for k in (1, 10):
    stage_dir = flax_fixture.stage_copy(str(tmp_path / f"k{k}"))
    model, optimizer, step, stats, counts, launches = flax_fixture.resume(
        stage_dir, cuda_device, k, windows=20 // k)
    assert step == flax_fixture.STEP and set(counts) == {step}
    assert [int(c) for c in optimizer.counts] == [step + 20] * len(counts)
    state = {f"p.{n}": p.detach().clone()
             for n, p in model.named_parameters()}
    for i, st in optimizer.state_dict()["state"].items():
      state.update({f"{i}.{n}": torch.as_tensor(t).clone()
                    for n, t in st.items()})
    runs[k] = (stats, state, launches)
  assert runs[10][0] == runs[1][0] and len(runs[1][0]) == 20
  assert all(np.isfinite(s.loss) for s in runs[1][0])
  assert runs[1][1].keys() == runs[10][1].keys()
  for key, want in runs[1][1].items():
    assert torch.equal(runs[10][1][key], want), key
  assert runs[1][2] == 20 and runs[10][2] == 20  # eager + captured


# The shipped configs' reduced-precision arms (ops/precision.py), each
# kernel against its plain version of the same arm. K1 and K2 with the head
# off round at the same points in the same order as their plain versions:
# ATOL. K2 with its bf16 head is held teacher-forced (one plain step from
# each of the kernel's states: debug/precision_arms.teacher_forced) at
# SO3_ATOL, and free-running at SO3_ATOL where the interpolation is fp32;
# K3's bf16 arm per tensor at 2e-3 x max|want| with P3's bf16 flips
# replayed (precision_arms.k3_bf16_case).


@pytest.mark.cuda
@pytest.mark.parametrize("interp", ["default", "high"])
@pytest.mark.parametrize("nrays", [100, 1024])
def test_cuda_interp_arms_match_plain_versions(cuda_device, interp, nrays):
  from samplenerfro_torch.debug import precision_arms
  spec, data, o, d, jitter = _march_inputs(nrays)
  data, o, d = [torch.from_numpy(a).to(cuda_device) for a in (data, o, d)]
  jitter = torch.from_numpy(jitter)
  before = (march_kernel.march_lean.arms[interp],
            march_kernel.march_full_plain.arms[interp])
  err, got, _ = precision_arms.k1_arm(spec, data, o, d, NEAR, H, S, jitter,
                                      interp)
  err2, traj, _ = precision_arms.head_off_arm(spec, data, o, d, NEAR, H, S,
                                              interp)
  assert (march_kernel.march_lean.arms[interp],
          march_kernel.march_full_plain.arms[interp]) == (before[0] + 1,
                                                          before[1] + 1)
  assert err <= ATOL and err2 <= ATOL
  exact = march_kernel.march_full_plain(spec, data, o, d, NEAR, H, S)
  assert float((exact[..., 7:] - traj[..., 7:]).abs().max()) > ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("interp", ["highest", "default"])
def test_cuda_so3_march_bf16_head_matches_plain_version(cuda_device, interp):
  from samplenerfro_torch.debug import precision_arms
  spec, data, o, d, so3 = _allstage_inputs(cuda_device, 256)
  before = march_kernel.march_full.arms[(interp, "bfloat16")]
  forced, free, traj, _, _ = precision_arms.k2_arm(
      spec, data, o, d, NEAR, H, S, so3, ALPHA, interp, "bfloat16")
  assert march_kernel.march_full.arms[(interp, "bfloat16")] == before + 1
  assert max(forced.values()) <= SO3_ATOL, forced
  if interp == "highest":
    assert max(free) <= SO3_ATOL, free
  fp32 = march_kernel.march_full(spec, data, o, d, NEAR, H, S, so3, ALPHA,
                                 10, interp)
  assert not torch.equal(fp32, traj)


# K2's bf16 head is a kernel of its own (csrc/march_so3.cu, namespace bfh):
# its hidden layers are K3's (csrc/so3_bf16.cuh), so its pre-activations
# are P3's bf16 arm's bit for bit; a ray's rows of the head's tile are its
# own, so its trajectory does not depend on the other rays of its batch,
# nor on the rays a group or the groups a CTA.


def _bf16_march(spec, data, o, d, so3, max_deg=10, interp="default",
                shape=None):
  """K2's bf16 head through march_full, or in the geometry `shape`."""
  if shape is None:
    return march_kernel.march_full(spec, data, o, d, NEAR, H, S, so3, ALPHA,
                                   max_deg, interp, "bfloat16")
  return march_kernel._launch_so3(  # pylint: disable=protected-access
      spec, data, o, d, NEAR, H, S, so3, ALPHA, max_deg, interp, "bfloat16",
      shape=shape)


@pytest.mark.cuda
@pytest.mark.parametrize("nrays", [1, 31, 33, 1000])
def test_cuda_so3_bf16_head_ragged_batches(cuda_device, nrays):
  """Batches that end inside a group of 16 or 32 rays and past one: the
  first nrays rays of a 1000-ray batch march as in it, bit for bit, in
  every geometry the kernel is built for, and teacher-forced within
  SO3_ATOL."""
  from samplenerfro_torch.debug import precision_arms
  spec, data, o, d, so3 = _allstage_inputs(cuda_device, 1000)
  whole = _bf16_march(spec, data, o, d, so3)
  for shape in march_kernel.SO3_BF16_SHAPES:
    got = _bf16_march(spec, data, o[:nrays].contiguous(),
                      d[:nrays].contiguous(), so3, shape=shape)
    assert got.shape == (nrays, S, 11)
    assert torch.equal(got, whole[:nrays]), shape
  forced = precision_arms.teacher_forced(spec, data, got, H, so3, ALPHA, 10,
                                         "default", "bfloat16")
  assert max(forced.values()) <= SO3_ATOL, forced


@pytest.mark.cuda
@pytest.mark.parametrize("width,max_deg", [(128, 10), (64, 4)])
def test_cuda_so3_bf16_head_preacts_are_p3s(cuda_device, width, max_deg):
  """At every active ray-step the kernel's pre-activations of hidden layers
  1-3 (its trial build, march_full_preacts) are P3 bf16's bit for bit, at
  the shipped head and a narrow one (zero units and PE rows in the
  resident weights); the trial build marches as the kernel does."""
  from samplenerfro_torch.debug import precision_arms
  spec, data, o, d, _ = _allstage_inputs(cuda_device, 256)
  so3 = _so3_params(cuda_device, max_deg=max_deg, width=width)
  traj = _bf16_march(spec, data, o, d, so3, max_deg)
  pre, same = precision_arms.k2_preacts_case(spec, data, o, d, NEAR, H, S,
                                             so3, ALPHA, "default", max_deg,
                                             traj=traj)
  assert same
  active = int((traj[..., 8:11].norm(dim=-1) > 1e-3).sum())
  assert pre == {"active": active, "flips": [0, 0, 0],
                 "differ": [0, 0, 0]} and active > 1000
  forced = precision_arms.teacher_forced(spec, data, traj, H, so3, ALPHA,
                                         max_deg, "default", "bfloat16")
  assert max(forced.values()) <= SO3_ATOL, forced


@pytest.mark.cuda
def test_cuda_so3_bf16_head_no_active_step(cuda_device):
  """Rays that never meet the blob: no ray-step runs the head (the trial
  build writes no pre-activation), and the march is its plain version's
  within SO3_ATOL."""
  spec, data, o, d, so3 = _allstage_inputs(cuda_device, 64)
  o = o + torch.tensor([0.0, 0.0, -40.0], device=cuda_device)
  d = -d
  traj = _bf16_march(spec, data, o, d, so3)
  assert int((traj[..., 8:11].norm(dim=-1) > 1e-3).sum()) == 0
  _, pre = march_kernel.march_full_preacts(spec, data, o, d, NEAR, H, S, so3,
                                           ALPHA)
  assert all(bool(torch.isnan(p).all()) for p in pre)
  want = march_kernel.march_full_reference(spec, data, o, d, NEAR, H, S, so3,
                                           ALPHA, 10, "default", "bfloat16")
  torch.testing.assert_close(traj, want, atol=SO3_ATOL, rtol=0)


@pytest.mark.cuda
def test_cuda_so3_bf16_head_is_deterministic(cuda_device):
  """Two runs at the ship batch's shape, 1024 rays of 768 steps on the
  ship blob, agree bit for bit."""
  spec, data, o, d, so3 = _allstage_inputs(cuda_device, 1024)
  fwd = (spec, data, o, d, NEAR, H / 24, 24 * S, so3, ALPHA, 10, "default",
         "bfloat16")
  first = march_kernel.march_full(*fwd)
  assert torch.equal(first, march_kernel.march_full(*fwd))
  assert bool(torch.isfinite(first).all())


@pytest.mark.cuda
@pytest.mark.parametrize("nrays,edge", [
    (256, None), (100, None), (100, "none"), (100, "all"), (256, "over"),
    (256, "under"), (256, "few"), (100, "narrow"), ("ship", None)])
def test_cuda_march_bwd_bf16_matches_plain_version(cuda_device, nrays, edge):
  """K3's bf16 arm against its plain version with P3's flips replayed, at
  K3_BF16_FORM per tensor and bit for bit across two runs: on the march's
  trajectory, at the edges of its balanced partition (no active ray-step,
  every one, one over and one under a multiple of the tile's rows, fewer
  tiles than blocks), with a narrower head (64 units, 6 degrees: zero rows
  and units in the resident weights) and at the ship 'all' batch."""
  from samplenerfro_torch.debug import precision_arms
  if nrays == "ship":
    cfg, data, o, d, so3, traj, dtraj = _shape_inputs(cuda_device, "ship")
    cfg = cfg._replace(interp="default", bwd_dtype="bfloat16")
  else:
    spec, data, o, d, so3 = _allstage_inputs(cuda_device, nrays)
    deg = 10
    if edge == "narrow":
      deg, edge = 6, None
      so3 = _so3_params(cuda_device, max_deg=deg, width=64)
    cfg = eikonal_vjp.MarchConfig(spec, NEAR, H, S, deg, "highest",
                                  "bfloat16")
    traj = march_kernel.march_full_reference(spec, data, o, d, NEAR, H, S,
                                             so3, ALPHA, deg,
                                             bwd_dtype="bfloat16")
    dtraj = torch.randn(traj.shape, generator=torch.Generator().manual_seed(
        5)).to(cuda_device)
  blocks = (eikonal_vjp.BLOCKS_PER_SM["bfloat16"]
            * torch.cuda.get_device_properties(cuda_device)
            .multi_processor_count)
  if edge is not None:
    traj = precision_arms.k3_edge_trajectory(traj, edge, blocks)
  active = int((traj[..., 8:11].norm(dim=-1) > 1e-3).sum())
  rows = eikonal_vjp.K3_BF16_ROWS
  assert {"none": active == 0, "all": active == traj.shape[0] * traj.shape[1],
          "over": active % rows == 1, "under": active % rows == rows - 1,
          "few": 0 < -(-active // rows) < blocks,
          None: active > 0}[edge], active
  before = eikonal_vjp.march_bwd.arms["bfloat16"]
  errs, flips, same, got, _ = precision_arms.k3_bf16_case(
      cfg, data, o, d, so3, ALPHA, traj, dtraj)
  assert eikonal_vjp.march_bwd.arms["bfloat16"] == before + 2
  assert same
  assert all(share <= 1.0 for _, share in errs.values()), (errs, flips)
  if edge == "none":
    assert all(float(g.abs().max()) == 0 for g in got[3])
  else:
    assert float(got[3][-2].abs().sum()) > 0
