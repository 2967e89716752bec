"""K2's launch geometry with the bf16 head
(ops/march_kernel.so3_bf16_launch_geometry; csrc/march_so3.cu, namespace
bfh): 16-ray CTAs or two 32-ray groups a CTA, every ray covered once, the
resident head within a block's shared memory, and a ValueError naming each
limit.

The kernel runs only on a card (tests/test_torch_cuda.py); this is the
host side that chooses and checks its launch.
"""

import pytest
import torch

from samplenerfro_torch.ops import march_kernel as t_mk

H100_SMS = 132
SHAPES = [(16, 1), (32, 2)]


def test_so3_bf16_shapes_are_the_kernels():
  assert list(t_mk.SO3_BF16_SHAPES) == SHAPES


# The ship batch (1024 rays) and render chunk (8192), ragged batches and
# the edges of one wave of 16- and 32-ray CTAs, on an H100's 132 SMs and
# on a smaller card.
@pytest.mark.parametrize("batch", [1, 15, 16, 17, 31, 33, 63, 64, 65, 1000,
                                   1024, 2112, 2113, 4224, 4225, 8192,
                                   8448, 8449])
@pytest.mark.parametrize("sms", [H100_SMS, 8])
@pytest.mark.parametrize("shape", [None] + SHAPES)
def test_so3_bf16_geometry_covers_every_ray_once(batch, sms, shape):
  g = t_mk.so3_bf16_launch_geometry(batch, 128, 10, sms, shape)
  per = g["rays_per_cta"]
  assert (g["rays_per_group"], g["groups"]) in SHAPES
  assert shape is None or (g["rays_per_group"], g["groups"]) == shape
  assert per == g["rays_per_group"] * g["groups"]
  # 8 lanes a ray; as many helper threads beside 16-ray groups.
  helpers = 2 if g["rays_per_group"] == 16 else 1
  assert g["threads"] == t_mk.LEAN_LANES * per * helpers
  assert t_mk.so3_bf16_helpers(g["rays_per_group"]) == (helpers == 2)
  covered = torch.zeros(batch, dtype=torch.int64)
  for cta in range(g["ctas"]):
    lo, hi = cta * per, min((cta + 1) * per, batch)
    assert hi > lo, f"CTA {cta} has no ray"
    covered[lo:hi] += 1
  assert bool((covered == 1).all())
  assert g["smem_bytes"] <= t_mk.SMEM_LIMIT == 232448


@pytest.mark.parametrize("batch,sms,shape", [
    (1024, H100_SMS, (16, 1)),  # the 'all' batch: 64 CTAs, all at once
    (2112, H100_SMS, (16, 1)),  # 132 CTAs of 16 rays: one wave
    (2113, H100_SMS, (32, 2)),  # past it: the fewest CTAs
    (4224, H100_SMS, (32, 2)),
    (8192, H100_SMS, (32, 2)),  # the render chunk: 128 CTAs of 64 rays
    (8449, H100_SMS, (32, 2)),  # past one wave of those
    (128, 8, (16, 1)), (129, 8, (32, 2)), (257, 8, (32, 2))])
def test_so3_bf16_geometry_picks_the_shape_from_the_batch(batch, sms,
                                                          shape):
  g = t_mk.so3_bf16_launch_geometry(batch, 128, 10, sms)
  assert (g["rays_per_group"], g["groups"]) == shape
  assert g["ctas"] == -(-batch // (shape[0] * shape[1]))


def test_so3_bf16_geometry_shared_bytes():
  # The hidden layers' 512 input-major rows of 128 bf16 padded by 8; per
  # ray, two PE rows (64 + 8) and two activation rows (128 + 8), bf16; the
  # biases [4][128], the output layer [4][128 + 4] and its bias [4], the
  # window [16] and two buffers of the helpers' positions, [rays][3] with
  # helpers and [1][3] without, fp32.
  weights = 2 * 512 * 136
  per_ray = 2 * (2 * 72 + 2 * 136)
  rest = 4 * (4 * 128 + 4 * 132 + 4 + 16)
  for rows, groups in SHAPES:
    g = t_mk.so3_bf16_launch_geometry(1024, 128, 10, H100_SMS,
                                      (rows, groups))
    q = 4 * 2 * 3 * (rows * groups if rows == 16 else 1)
    assert g["smem_bytes"] == (weights + rows * groups * per_ray + rest
                               + q)
  assert [t_mk.so3_bf16_smem_bytes(*sh) for sh in SHAPES] == [
      157200, 196776]
  # One CTA an SM: the resident head leaves no room for a second.
  assert 2 * t_mk.so3_bf16_smem_bytes(16, 1) > t_mk.SMEM_LIMIT


@pytest.mark.parametrize("width,max_deg", [(1, 1), (64, 4), (128, 10),
                                           (33, 7)])
def test_so3_bf16_geometry_takes_every_head_k2_takes(width, max_deg):
  g = t_mk.so3_bf16_launch_geometry(100, width, max_deg, H100_SMS)
  assert g["ctas"] == 7 and g["smem_bytes"] == t_mk.so3_bf16_smem_bytes(
      16, 1)


def test_so3_bf16_geometry_names_its_limits(monkeypatch):
  with pytest.raises(ValueError, match="batch must be at least 1"):
    t_mk.so3_bf16_launch_geometry(0, 128, 10, H100_SMS)
  for width in (0, 129):
    with pytest.raises(ValueError, match="width 1 to 128"):
      t_mk.so3_bf16_launch_geometry(1024, width, 10, H100_SMS)
  for deg in (0, 11):
    with pytest.raises(ValueError, match="max_deg <= 10"):
      t_mk.so3_bf16_launch_geometry(1024, 128, deg, H100_SMS)
  with pytest.raises(ValueError, match="at least 1 SM"):
    t_mk.so3_bf16_launch_geometry(1024, 128, 10, 0)
  for shape in ((8, 1), (16, 2), (32, 1), (64, 1)):
    with pytest.raises(ValueError, match=r"\(rays a group, groups a CTA\) "
                       r"in \(\(16, 1\), \(32, 2\)\)"):
      t_mk.so3_bf16_launch_geometry(1024, 128, 10, H100_SMS, shape)
  monkeypatch.setattr(t_mk, "SMEM_LIMIT", 180000)
  t_mk.so3_bf16_launch_geometry(1024, 128, 10, H100_SMS, (16, 1))
  with pytest.raises(ValueError, match="196776 bytes of shared memory a "
                     "CTA, over the 180000"):
    t_mk.so3_bf16_launch_geometry(1024, 128, 10, H100_SMS, (32, 2))


def test_march_full_preacts_needs_the_card():
  rays = torch.zeros((4, 3))
  with pytest.raises(ValueError, match="CUDA tensors only"):
    t_mk.march_full_preacts(None, None, rays, rays, 0.0, 0.1, 8, [], 0.5)
