"""The host side of K3's bf16 arm (ops/eikonal_vjp.py, csrc/march_bwd.cu's
namespace bfa): the tile ranges of its balanced partition over the blocks
of passes 1b and 3, its scratch shapes, the edges
debug/precision_arms.k3_edge_trajectory makes, and a wrapper that reads
nothing back from the device.

The partition itself runs on the card (k3_pieces counts, 1b and 3 scan
and compact); tests/test_torch_cuda.py holds it at these edges against
the plain version.
"""

import numpy as np
import pytest
import torch

from samplenerfro_torch.debug import precision_arms
from samplenerfro_torch.ops import eikonal_vjp
from samplenerfro_torch.ops import grid as grid_ops
from samplenerfro_torch.ops import march_kernel
from samplenerfro_torch.ops import mlp as mlp_ops
from samplenerfro_torch.utils import grid_io

ROWS = eikonal_vjp.K3_BF16_ROWS


@pytest.mark.parametrize("rows", [ROWS, eikonal_vjp.K3_BF16_PARAM_ROWS])
@pytest.mark.parametrize("active,blocks", [
    (0, 132), (1, 132), (63, 132), (64, 132), (65, 132), (ROWS * 132, 132),
    (ROWS * 132 + 1, 132), (329341, 132), (5000, 7), (ROWS * 5 - 1, 5)])
def test_tile_ranges_cover_every_tile_once_in_equal_shares(active, blocks,
                                                          rows):
  """1b's tiles of 64 and pass 3's of 128 over the same compacted list."""
  ranges = eikonal_vjp.k3_tile_ranges(active, blocks, rows)
  tiles = -(-active // rows)
  assert len(ranges) == blocks
  assert ranges[0][0] == 0 and ranges[-1][1] == tiles
  assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
  sizes = [t1 - t0 for t0, t1 in ranges]
  assert min(sizes) >= 0 and max(sizes) - min(sizes) <= (1 if tiles else 0)


@pytest.mark.parametrize("batch,steps", [(1024, 768), (1, 1), (100, 32),
                                         (8192, 1536), (1000, 7)])
def test_scratch_shapes_follow_batch_and_steps(batch, steps):
  counts, rows = eikonal_vjp.k3_index_shapes(batch, steps)
  total = batch * steps
  # One count per k3_pieces block of 256 ray-steps, one row a ray-step.
  assert counts == (-(-total // 256),) and rows == (total,)


@pytest.mark.parametrize("max_deg", [1, 4, 10])
def test_partial_rows_start_on_32_bytes_in_the_bf16_arm(max_deg):
  width, in_dim = eikonal_vjp.HIDDEN, 6 * max_deg
  p = sum(eikonal_vjp._pack_sizes(in_dim))
  assert p % 2 == 1  # the output bias's 3 make the pack odd
  stride = eikonal_vjp.partial_stride(p, True)
  assert stride % 8 == 0 and 0 <= stride - p < 8
  assert eikonal_vjp.partial_stride(p, False) == p
  # Every weight matrix of the pack starts on 32 bytes within a row.
  sizes = eikonal_vjp._pack_sizes(in_dim)
  starts = [sum(sizes[:i]) for i in (0, 2, 4, 6)]
  assert all(s % 8 == 0 for s in starts) and width % 8 == 0


@pytest.mark.parametrize("case", precision_arms.K3_EDGES)
def test_edge_trajectories(case):
  traj = torch.zeros(64, 40, 11)
  traj[..., 8] = torch.from_numpy(
      np.random.RandomState(1).rand(64, 40).astype(np.float32) - 0.5)
  before = traj[..., 8:11].norm(dim=-1) > 1e-3
  out = precision_arms.k3_edge_trajectory(traj, case, 132)
  after = out[..., 8:11].norm(dim=-1) > 1e-3
  n = int(after.sum())
  assert {"none": n == 0, "all": n == after.numel(),
          "over": n % ROWS == 1, "under": n % ROWS == ROWS - 1,
          "few": 0 < -(-n // ROWS) < 132}[case]
  if case not in ("none", "all"):
    # The first n active ray-steps in ray-major order are kept as they were.
    assert not bool((after & ~before).any())
    rank = before.reshape(-1).cumsum(0).reshape(before.shape)
    assert torch.equal(after, before & (rank <= n))
  assert torch.equal(out[..., :8], traj[..., :8])


def test_edge_trajectory_refuses_an_edge_it_cannot_make():
  traj = torch.zeros(2, 3, 11)
  traj[0, 0, 8] = 1.0
  with pytest.raises(ValueError):
    precision_arms.k3_edge_trajectory(traj, "under", 132)


def _bf16_inputs(nrays=12, n=24, steps=20, max_deg=4, width=32):
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(n, 1.5, 0.33)
  spec = grid_ops.GridSpec(ndim, nmin, nmax)
  data = torch.from_numpy(np.concatenate(
      [values, grid_ops.central_difference_grad_numpy(spec, values)],
      axis=-1).astype(np.float32))
  rng = np.random.RandomState(4)
  d = np.array([0.0, 0.0, 1.0]) + 0.2 * rng.randn(nrays, 3)
  d /= np.linalg.norm(d, axis=-1, keepdims=True)
  o = np.array([0.1, -0.05, -4.0]) + 0.3 * rng.randn(nrays, 3)
  o, d = (torch.from_numpy(a.astype(np.float32)) for a in (o, d))
  head = mlp_ops.So3MLP(6 * max_deg, net_width=width, output_init_std=1e-2,
                        generator=torch.Generator().manual_seed(0))
  so3 = [p.detach() for p in head.params()]
  cfg = eikonal_vjp.MarchConfig(spec, 2.0, 4.0 / (steps - 1), steps,
                                max_deg, "default", "bfloat16")
  traj = march_kernel.march_full_reference(spec, data, o, d, 2.0,
                                           cfg.step_size, steps, so3, 0.6,
                                           max_deg, "default", "bfloat16")
  dtraj = torch.from_numpy(rng.randn(*traj.shape).astype(np.float32))
  return cfg, data, o, d, so3, traj, dtraj


def test_march_bwd_reads_nothing_back(monkeypatch):
  """march_bwd in the bf16 arm with Tensor.item raising. On the CPU the
  wrapper runs the plain version (march_bwd_passes_reference), so this
  holds that path free of host reads; the CUDA wrapper, whose tile count
  is read on the card inside the K-step CUDA graph, is held by
  tests/test_torch_cuda.py under the sync debug mode's "error"."""
  cfg, data, o, d, so3, traj, dtraj = _bf16_inputs()
  want = eikonal_vjp.march_bwd(cfg, data, o, d, so3, 0.6, traj, dtraj)

  def item(self):
    raise AssertionError("march_bwd read a tensor back with .item()")

  monkeypatch.setattr(torch.Tensor, "item", item)
  got = eikonal_vjp.march_bwd(cfg, data, o, d, so3, torch.tensor(0.6), traj,
                              dtraj)
  flat = lambda r: [r[0], r[1], r[2]] + list(r[3])
  assert all(torch.equal(a, b) for a, b in zip(flat(got), flat(want)))
