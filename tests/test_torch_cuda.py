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
from samplenerfro_torch.models import nerf
from samplenerfro_torch.ops import grid as grid_ops
from samplenerfro_torch.ops import march_kernel
from samplenerfro_torch.utils import config as config_lib
from samplenerfro_torch.utils import grid_io

# fp32 with FMA contraction off on both sides (see ops/cuda_build.py): over
# 32 steps the two agree to a few ulp; 1e-5 is the CPU tests' tolerance.
ATOL = 1e-5
S, NUM_PATH, NEAR, FAR = 32, 4, 2.0, 6.0
H = (FAR - NEAR) / (S - 1)


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
