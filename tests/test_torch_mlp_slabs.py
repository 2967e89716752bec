"""The fused MLP's bf16 warpgroup engine, its host side, on the CPU.

K4 and K5 (csrc/mlp_fwd.cu, csrc/mlp_bwd.cu) run their bf16 layers, and
K5 its cotangents, as wgmma products on weight slabs that the copy engine
feeds from a pack built on the host (ops/mlp_kernel.slab_pack). The
kernels themselves run only on a card (tests/test_torch_cuda.py -k
bf16_engines); here the pack's layout, its counts, the shared-memory
budget of every geometry the kernels take and the refusals are held
against expectations built in numpy.
"""

import numpy as np
import pytest
import torch

from samplenerfro_torch.models import mlp as mlp_modules
from samplenerfro_torch.ops import mlp_kernel
from samplenerfro_torch.tools import validate_quality

SLAB_K, SLAB_N = 64, 128
MAX_SMEM = 232448


def _mlp(width=128, depth=4, skip=2, feat=63, cond=27, cond_width=128,
         seed=0):
  mlp = mlp_modules.NerfMLP(feat, cond, net_depth=depth, net_width=width,
                            skip_layer=skip, net_width_condition=cond_width,
                            generator=torch.Generator().manual_seed(seed))
  return mlp_kernel.mlp_spec(mlp), mlp_kernel.mlp_params(mlp)


def _numpy_slabs(weights, depth, width):
  """The slab pack built element by element: the forward's layers (trunk,
  bottleneck, condition layer), then the cotangents' (condition layer,
  bottleneck, trunk from the last to the second, the first `width` inputs
  as outputs); per panel of SLAB_N outputs and SLAB_K-slab of inputs,
  element (c, k) at c * SLAB_K + ((k // 8) ^ (c % 8)) * 8 + k % 8."""
  w = [np.asarray(t.detach().to(torch.bfloat16).float()) for t in weights]
  mats = [w[i] for i in range(depth)] + [w[depth + 1], w[depth + 2]]
  mats += [w[depth + 2][:, :width].T, w[depth + 1].T]
  mats += [w[i][:, :width].T for i in range(depth - 1, 0, -1)]
  out = []
  for m in mats:
    n, k = m.shape
    for c0 in range(0, n, SLAB_N):
      for k0 in range(0, k, SLAB_K):
        slab = np.zeros(SLAB_N * SLAB_K, np.float32)
        for c in range(SLAB_N):
          for kk in range(SLAB_K):
            if k0 + kk < k:
              slab[c * SLAB_K + ((kk // 8) ^ (c % 8)) * 8 + kk % 8] = \
                  m[c0 + c, k0 + kk]
        out.append(slab)
  return np.concatenate(out), len(mats)


@pytest.mark.parametrize("width,depth,skip,feat,cond", [
    (128, 4, 2, 63, 27), (256, 3, 4, 63, 27), (128, 4, 2, 3, 3)])
def test_slab_pack_is_the_kernels_layout(width, depth, skip, feat, cond):
  """Each slab K-major in the 128-byte swizzle, zero past the product's
  inputs, in the order K4 and K5 take them; the counts those of the
  kernels' Spec."""
  spec, params = _mlp(width, depth, skip, feat, cond)
  assert mlp_kernel.supports(feat, cond, depth, width, skip, 1, 128, 3, 1)
  weights = params[0::2]
  want, _ = _numpy_slabs(weights, depth, width)
  got = mlp_kernel.slab_pack(spec, params)
  assert got.dtype == torch.bfloat16
  np.testing.assert_array_equal(got.float().numpy(), want)
  fwd, cot = mlp_kernel.slab_counts(spec)
  dims = [(w.shape[1], w.shape[0]) for w in weights]
  want_fwd = sum(-(-k // SLAB_K) * (n // SLAB_N) for k, n in
                 [dims[i] for i in range(depth)] + [dims[depth + 1],
                                                    dims[depth + 2]])
  want_cot = (-(-spec.cond_width // SLAB_K) * (width // SLAB_N)
              + depth * (width // SLAB_K) * (width // SLAB_N))
  assert (fwd, cot) == (want_fwd, want_cot)
  assert got.numel() == (fwd + cot) * SLAB_K * SLAB_N


def test_pack_params_holds_the_slabs_where_the_engine_runs():
  """bf16 packs carry slab_pack's slabs; fp32 and wide geometries none."""
  spec, params = _mlp()
  bf16 = mlp_kernel.pack_params(params, torch.bfloat16)
  assert torch.equal(bf16.slabs, mlp_kernel.slab_pack(spec, params))
  assert mlp_kernel.pack_params(params, torch.float32).slabs.numel() == 0
  wide_spec, wide_params = _mlp(width=384, cond_width=384)
  assert mlp_kernel.wide(wide_spec)
  assert mlp_kernel.pack_params(wide_params,
                                torch.bfloat16).slabs.numel() == 0
  assert mlp_kernel.warpgroup(spec, torch.bfloat16)
  assert not mlp_kernel.warpgroup(spec, torch.float32)
  assert not mlp_kernel.warpgroup(wide_spec, torch.bfloat16)


def _numpy_smem(width, cond_width, feat, cond, dtype, kernel, stages=None):
  """Shared memory of a K4 / K5 block: the tile's two activation buffers
  and inputs (rows padded by 16 bytes), the feed's ring of 16 KB slabs
  with its alignment and mbarriers or the cp.async ring, and K5's
  cotangent rows, column sums and the copy of the sigma head."""
  size = 2 if dtype == torch.bfloat16 else 4
  wide = (max(width, cond_width) > 256
          or -(-feat // 32) * 32 + -(-cond // 32) * 32 > 128)
  rows = (128 if size == 2 else 64) // (4 if wide else 1)
  pad, maxw = 16 // size, max(width, cond_width)
  fp, cp = -(-feat // 32) * 32, -(-cond // 32) * 32
  bufs = size * (2 * rows * (maxw + pad) + rows * (fp + pad + cp + pad))
  group = size == 2 and not wide
  extra = 0
  if kernel == "mlp_bwd":
    extra = (4 + size) * rows * 8 + 4 * (1024 if group else 512)
    extra += size * width if group else 0
  if not group:
    slab = 16 if size == 4 else 32
    return bufs + size * 3 * slab * (min(maxw, 256) + pad) + extra
  return 1024 + stages * SLAB_K * SLAB_N * 2 + 128 + bufs + extra


WIDTHS = [128, 256, 384, 512, 768, 1024]


@pytest.mark.parametrize("kernel", ["mlp_fwd", "mlp_bwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_geometry_fits_in_shared_memory(kernel, dtype):
  """Every width, feature and condition count the kernels take fits in a
  block's 232,448 bytes, the feed with at least 2 slabs, as many as fit up
  to 4; the ship geometry's feed holds 4 (K4) and 3 (K5)."""
  for width in WIDTHS:
    for cond_width in WIDTHS:
      for feat, cond in ((63, 27), (99, 27), (3, 3), (60, 16), (128, 128)):
        spec = mlp_kernel.MlpSpec(8, width, 4, feat, cond, cond_width, 3,
                                  1, None)
        got, stages = mlp_kernel.shared_bytes(spec, dtype, kernel)
        if mlp_kernel.warpgroup(spec, dtype):
          assert 2 <= stages <= 4
          fits = [s for s in (4, 3, 2) if _numpy_smem(
              width, cond_width, feat, cond, dtype, kernel, s) <= MAX_SMEM]
          assert stages == fits[0]
          assert got == _numpy_smem(width, cond_width, feat, cond, dtype,
                                    kernel, stages)
        else:
          assert stages == 0
          assert got == _numpy_smem(width, cond_width, feat, cond, dtype,
                                    kernel)
        assert got <= MAX_SMEM, (width, cond_width, feat, cond)
  ship = mlp_kernel.MlpSpec(8, 256, 4, 63, 27, 128, 3, 1, None)
  if dtype == torch.bfloat16:
    want = 4 if kernel == "mlp_fwd" else 3
    assert mlp_kernel.shared_bytes(ship, dtype, kernel)[1] == want


def test_limits_raise_by_name():
  """A wide geometry has no slab pack, shared_bytes names the kernels it
  knows, and a pack whose slabs do not fit the call is refused."""
  spec, params = _mlp(width=512, cond_width=128)
  with pytest.raises(ValueError, match="wide geometry"):
    mlp_kernel.slab_pack(spec, params)
  with pytest.raises(ValueError, match="mlp_fwd or mlp_bwd"):
    mlp_kernel.shared_bytes(spec, torch.bfloat16, "mlp_other")
  small, small_params = _mlp()
  pack = mlp_kernel.pack_params(small_params, torch.bfloat16)
  short = pack._replace(slabs=pack.slabs[:-SLAB_K * SLAB_N])
  with pytest.raises(ValueError, match="does not fit"):
    mlp_kernel._pack_for(small, small_params, torch.bfloat16, short)
  assert mlp_kernel._pack_for(small, small_params, torch.bfloat16,
                              pack) is pack


def test_validate_quality_mlp_kernel(tmp_path):
  """--mlp_kernel writes the run's overlay line and tags the run; xla, the
  default, keeps the tag of a run without it; --steps_per_dispatch goes
  to the overlay and not to the tag."""
  ns = validate_quality.parse_args(["--mlp_dtype=bfloat16",
                                    "--mlp_kernel=pallas", "--seed=1",
                                    "--steps_per_dispatch=10"])
  assert validate_quality.run_tag(ns) == "single_image_bfloat16_pallas_s1"
  validate_quality.write_config(ns, str(tmp_path / "c"))
  lines = (tmp_path / "c.yaml").read_text().splitlines()
  assert "mlp_kernel: pallas" in lines and "mlp_dtype: bfloat16" in lines
  assert "steps_per_dispatch: 10" in lines
  plain = validate_quality.parse_args(["--mlp_dtype=bfloat16"])
  assert validate_quality.run_tag(plain) == "single_image_bfloat16"
