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
@pytest.mark.parametrize("nrays", [256, 100])
def test_cuda_kernel_matches_plain_version(cuda_device, nrays):
  spec, *arrays = _march_inputs(nrays)
  data, o, d, jitter = [torch.from_numpy(a).to(cuda_device) for a in arrays]
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
def test_cuda_wrapper_rejects_bad_inputs(cuda_device):
  spec, *arrays = _march_inputs(8, n=8)
  data, o, d, jitter = [torch.from_numpy(a).to(cuda_device) for a in arrays]
  before = march_kernel.march_lean.launches
  for bad in (dict(o=o.double()), dict(d=d.t().contiguous().t()),
              dict(data=data[:-1]), dict(data=data.cpu())):
    args = dict(data=data, o=o, d=d)
    args.update(bad)
    with pytest.raises(ValueError):
      march_kernel.march_lean(spec, args["data"], args["o"], args["d"], NEAR, H,
                              S, jitter)
  assert march_kernel.march_lean.launches == before


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
      ret = model(Rays(*[r.to(dev) for r in rays]), jitter.to(dev))
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
  ulp, and a ReLU mask near 0 may flip)."""
  from samplenerfro_torch.ops import mlp_kernel
  spec, params, x, c = _mlp_case(cuda_device, n, pe, seed=3)
  gen = torch.Generator().manual_seed(4)
  drgb = torch.randn((n, 3), generator=gen).to(cuda_device)
  dsigma = torch.randn((n, 1), generator=gen).to(cuda_device)
  before = mlp_kernel.mlp_bwd.launches
  got = mlp_kernel.mlp_bwd(spec, params, x, c, drgb, dsigma, dtype)
  torch.cuda.synchronize()
  assert mlp_kernel.mlp_bwd.launches == before + 1
  want = mlp_kernel.fused_nerf_mlp_bwd_reference(spec, params, x, c, drgb,
                                                 dsigma, dtype)
  _assert_mlp_grads(got, want, 1e-4 if dtype == torch.float32 else 2e-2)
  again = mlp_kernel.mlp_bwd(spec, params, x, c, drgb, dsigma, dtype)
  assert all(torch.equal(a, b) for a, b in zip(got, again))


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
