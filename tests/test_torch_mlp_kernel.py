"""The fused NerfMLP's plain versions (K4/K5) against the JAX package's.

The same numpy-seeded inputs and the same weights (a flax NerfMLP's
params, biases redrawn from numpy so that every bias path is exercised,
carried by models/convert.params_from_flax) go through the JAX
`fused_nerf_mlp` in interpret mode (as tests/test_mlp_kernel.py runs it on
the CPU) and through the port's `fused_nerf_mlp_reference` (K4's plain
version) and `FusedNerfMLP` (whose backward on CPU tensors is K5's plain
version). Most cases use a small supported spec (depth 4, width 128, skip
2, condition width 128); one runs the ship's 8x256 trunk.

Tolerances:
- fp32 forward 1e-5 abs/rel: both sum fp32 products, in other orders.
- bf16 forward: both multiply bf16 operands exactly in fp32, so only the
  order of the fp32 sums differs, and that moves a pre-activation across a
  bf16 rounding boundary only where the two sums differ, which is rare: a
  bf16 product has 16 significant bits, so most partial sums are exact. In
  pe mode XLA's and torch's sin also differ by an ulp now and then, which
  can round an encoded feature to the other bf16 neighbour. Measured over
  four seeds of these shapes: max 1.3e-3 (one row, one activation a bf16
  ulp apart), mean 6.6e-6; both encodings agree alike. Held at max 4e-3
  and mean 3e-5, while the fp32 kernel stands at a mean of >= 1.3e-3 from
  the bf16 one, so a wrong rounding point shows.
- fp32 gradients atol = rtol = 5e-4, the JAX test's own tolerance
  (tests/test_mlp_kernel.py:74-78). bf16 gradients per tensor at 1e-3 of
  its scale: measured 2.4e-5, 4.4e-6 and 1.5e-7 of scale over three seeds
  (a flipped activation or ReLU mask moves one row's contribution).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from samplenerfro_torch.debug import mlp_rounding
from samplenerfro_torch.models import convert
from samplenerfro_torch.models import mlp as t_mlp
from samplenerfro_torch.ops import math as t_math
from samplenerfro_torch.ops import mlp_kernel
from samplenerfro_tpu.models import mlp as j_mlp
from samplenerfro_tpu.ops import math as j_math
from samplenerfro_tpu.ops.pallas import mlp_kernel as j_kernel

PTS_DEG, DIRS_DEG = 10, 4
FEAT, COND = 3 + 6 * PTS_DEG, 3 + 6 * DIRS_DEG
SMALL = dict(depth=4, width=128, skip=2)
SHIP = dict(depth=8, width=256, skip=4)
BF16_MAX, BF16_MEAN = 4e-3, 3e-5
BF16_GRAD_FRAC = 1e-3
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _setup(n, depth, width, skip, seed=0):
  """(flax params as numpy, port NerfMLP, raw points, raw directions,
  their JAX encodings) from numpy seeds."""
  rng = np.random.RandomState(seed)
  pts = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
  dirs = rng.randn(n, 3).astype(np.float32)
  dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
  x = np.asarray(j_math.pos_enc(jnp.asarray(pts), 0, PTS_DEG))
  c = np.asarray(j_math.pos_enc(jnp.asarray(dirs), 0, DIRS_DEG))
  flax_mlp = j_mlp.NerfMLP(net_depth=depth, net_width=width,
                           net_depth_condition=1, net_width_condition=128,
                           skip_layer=skip)
  params = flax_mlp.init(random.PRNGKey(seed), x[None], c[None])["params"]
  params = jax.tree_util.tree_map(np.asarray, params)
  params = {k: {"kernel": v["kernel"],
                "bias": (0.1 * rng.randn(*v["bias"].shape)).astype(
                    np.float32)} for k, v in params.items()}
  port = t_mlp.NerfMLP(FEAT, COND, net_depth=depth, net_width=width,
                       skip_layer=skip)
  sd = convert.params_from_flax({"coarse_mlp": params})
  port.load_state_dict({k[len("coarse_mlp."):]: v for k, v in sd.items()})
  return params, port, pts, dirs, x, c


def _jax_fused(params, x, c, dtype, pe, depth, width, skip):
  return j_kernel.fused_nerf_mlp(
      params, jnp.asarray(x), jnp.asarray(c), net_depth=depth,
      net_width=width, skip_layer=skip, dtype=dtype, block_m=32,
      interpret=True, pe=pe)


def _inputs(pe, pts, dirs, x, c):
  return (pts, dirs) if pe is not None else (x, c)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pe", [None, (PTS_DEG, DIRS_DEG)])
@pytest.mark.parametrize("n", [64, 70])
def test_plain_forward_matches_jax(dtype, pe, n):
  params, port, pts, dirs, x, c = _setup(n, **SMALL)
  xi, ci = _inputs(pe, pts, dirs, x, c)
  want = np.concatenate([np.asarray(a) for a in _jax_fused(
      params, xi, ci, dtype, pe, **SMALL)], axis=-1)
  spec = mlp_kernel.mlp_spec(port, pe)
  got = torch.cat(mlp_kernel.fused_nerf_mlp_reference(
      spec, mlp_kernel.mlp_params(port), torch.from_numpy(xi),
      torch.from_numpy(ci), DTYPES[dtype]), dim=-1).detach().numpy()
  assert got.shape == want.shape == (n, 4)
  if dtype == "float32":
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
  else:
    err = np.abs(got - want)
    assert err.max() <= BF16_MAX and err.mean() <= BF16_MEAN, (
        err.max(), err.mean())
    # The test sees the dtype: the fp32 kernel is farther off than that.
    fp32 = np.concatenate([np.asarray(a) for a in _jax_fused(
        params, xi, ci, "float32", pe, **SMALL)], axis=-1)
    assert np.abs(fp32 - want).mean() > 10 * BF16_MEAN


def test_ship_width_forward_matches_jax():
  params, port, pts, dirs, x, c = _setup(48, **SHIP, seed=1)
  pe = (PTS_DEG, DIRS_DEG)
  want = np.concatenate([np.asarray(a) for a in _jax_fused(
      params, pts, dirs, "float32", pe, **SHIP)], axis=-1)
  spec = mlp_kernel.mlp_spec(port, pe)
  got = torch.cat(mlp_kernel.fused_nerf_mlp_reference(
      spec, mlp_kernel.mlp_params(port), torch.from_numpy(pts),
      torch.from_numpy(dirs), torch.float32), dim=-1).detach().numpy()
  np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def _loss_targets(n, seed=3):
  rng = np.random.RandomState(seed)
  return (rng.randn(n, 3).astype(np.float32),
          rng.randn(n, 1).astype(np.float32))


@pytest.mark.parametrize("dtype,pe", [
    ("float32", None), ("float32", (PTS_DEG, DIRS_DEG)),
    ("bfloat16", None)])
def test_plain_gradients_match_jax(dtype, pe):
  n = 70
  params, port, pts, dirs, x, c = _setup(n, **SMALL, seed=2)
  xi, ci = _inputs(pe, pts, dirs, x, c)
  tgt, tgt_s = _loss_targets(n)

  def loss(p):
    rgb, sigma = _jax_fused(p, xi, ci, dtype, pe, **SMALL)
    return jnp.sum((rgb - tgt)**2) + jnp.sum((sigma - tgt_s)**2)

  j_loss, j_grads = jax.value_and_grad(loss)(params)
  want = {k: v.numpy() for k, v in convert.params_from_flax(
      {"coarse_mlp": jax.tree_util.tree_map(np.asarray, j_grads)}).items()}

  before = mlp_kernel.mlp_bwd.launches
  rgb, sigma = mlp_kernel.fused_nerf_mlp(
      port, torch.from_numpy(xi), torch.from_numpy(ci), dtype=DTYPES[dtype],
      pe=pe)
  t_loss = (((rgb - torch.from_numpy(tgt))**2).sum()
            + ((sigma - torch.from_numpy(tgt_s))**2).sum())
  t_loss.backward()
  # CPU tensors take the plain versions: no kernel launch.
  assert mlp_kernel.mlp_bwd.launches == before
  np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-5)
  for name, p in port.named_parameters():
    w = want[f"coarse_mlp.{name}"]
    if dtype == "float32":
      np.testing.assert_allclose(p.grad.numpy(), w, atol=5e-4, rtol=5e-4,
                                 err_msg=name)
    else:
      scale = max(float(np.abs(w).max()), 1e-6)
      assert float(np.abs(p.grad.numpy() - w).max()) <= (
          BF16_GRAD_FRAC * scale), name


@pytest.mark.parametrize("pe", [None, (PTS_DEG, DIRS_DEG)])
def test_plain_backward_is_autograd_of_plain_forward(pe):
  """K5's plain version against torch autograd of K4's, fp32."""
  n = 70
  _, port, pts, dirs, x, c = _setup(n, **SMALL, seed=4)
  xi, ci = map(torch.from_numpy, _inputs(pe, pts, dirs, x, c))
  spec = mlp_kernel.mlp_spec(port, pe)
  params = mlp_kernel.mlp_params(port)
  rng = np.random.RandomState(5)
  drgb = torch.from_numpy(rng.randn(n, 3).astype(np.float32))
  dsigma = torch.from_numpy(rng.randn(n, 1).astype(np.float32))
  rgb, sigma = mlp_kernel.fused_nerf_mlp_reference(spec, params, xi, ci,
                                                   torch.float32)
  want = torch.autograd.grad([rgb, sigma], params, [drgb, dsigma])
  got = mlp_kernel.fused_nerf_mlp_bwd_reference(spec, params, xi, ci, drgb,
                                                dsigma, torch.float32)
  for g, w in zip(got, want):
    torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


def test_pack_and_unpack_round_trip():
  _, port, *_ = _setup(8, **SMALL)
  spec = mlp_kernel.mlp_spec(port)
  params = mlp_kernel.mlp_params(port)
  wkn, wnk, bias, _ = mlp_kernel.pack_params(params, torch.bfloat16)
  assert wkn.dtype == wnk.dtype == torch.bfloat16
  assert bias.dtype == torch.float32
  assert wkn.numel() == sum(k * n for k, n in mlp_kernel.layer_dims(spec))
  wkn32, _, _, _ = mlp_kernel.pack_params(params, torch.float32)
  back = mlp_kernel.unpack_grads(spec, torch.cat([wkn32, bias]))
  for g, p in zip(back, params):
    assert torch.equal(g, p.detach())


def test_wnk_pack_is_padded_output_major():
  """The output-major pack: each layer [out, in] with its rows padded with
  zeros to a multiple of 16 inputs, in layer order, in the compute type."""
  _, port, *_ = _setup(8, **SMALL)
  spec = mlp_kernel.mlp_spec(port)
  params = mlp_kernel.mlp_params(port)
  for dtype in (torch.float32, torch.bfloat16):
    wnk = mlp_kernel.pack_params(params, dtype).wnk
    assert wnk.dtype == dtype
    off = 0
    for (k, n), w in zip(mlp_kernel.layer_dims(spec), params[0::2]):
      kp = mlp_kernel.wnk_row_len(k)
      assert kp % 16 == 0 and k <= kp < k + 16
      block = wnk[off:off + n * kp].reshape(n, kp)
      assert torch.equal(block[:, :k], w.detach().to(dtype))
      assert not block[:, k:].any()
      off += n * kp
    assert off == wnk.numel()


def test_saved_pack_gives_fresh_pack_gradients(monkeypatch):
  """FusedNerfMLP packs the weights once in forward and hands that pack to
  the backward; it equals a fresh pack, and the gradients equal those of a
  backward that packs for itself."""
  n = 70
  _, port, _, _, x, c = _setup(n, **SMALL, seed=7)
  params = mlp_kernel.mlp_params(port)
  spec = mlp_kernel.mlp_spec(port)
  xi, ci = torch.from_numpy(x), torch.from_numpy(c)
  packs, seen = [], []
  pack_params, mlp_bwd = mlp_kernel.pack_params, mlp_kernel.mlp_bwd

  def counting_pack(*args):
    packs.append(pack_params(*args))
    return packs[-1]

  def spying_bwd(*args, pack=None, **kwargs):
    seen.append(pack)
    return mlp_bwd(*args, pack=pack, **kwargs)

  monkeypatch.setattr(mlp_kernel, "pack_params", counting_pack)
  monkeypatch.setattr(mlp_kernel, "mlp_bwd", spying_bwd)
  for dtype in (torch.float32, torch.bfloat16):
    packs.clear()
    seen.clear()
    port.zero_grad()
    rgb, sigma = mlp_kernel.fused_nerf_mlp(port, xi, ci, dtype=dtype)
    (rgb.square().sum() + sigma.sum()).backward()
    assert len(packs) == 1 and len(seen) == 1 and seen[0] is packs[0]
    fresh = pack_params(params, dtype)
    assert all(torch.equal(a, b) for a, b in zip(seen[0], fresh))
    drgb = 2 * rgb.detach()
    dsigma = torch.ones_like(sigma)
    want = mlp_bwd(spec, params, xi, ci, drgb, dsigma, dtype, pack=fresh)
    for p, w in zip(params, want):
      assert torch.equal(p.grad, w)


def test_staged_plain_version_gives_its_weight_gradients():
  """debug/mlp_rounding's staged plain version, the chain of bf16 values
  it compares with K5's stored ones, gives the plain K5's weight
  gradients from the same inputs, stored as K5 stores them."""
  n = 70
  _, port, _, _, x, c = _setup(n, **SMALL, seed=9)
  spec = mlp_kernel.mlp_spec(port)
  params = mlp_kernel.mlp_params(port)
  drgb, dsigma = map(torch.from_numpy, _loss_targets(n, seed=10))
  bf16 = torch.bfloat16

  def stored(t, width):
    return torch.nn.functional.pad(t, (0, width - t.shape[1])).to(bf16)

  sections = {name: width for name, _, width in
              mlp_kernel.scratch_sections(spec)}
  inputs = {"x0": stored(torch.from_numpy(x), sections["x0"]),
            "cond": stored(torch.from_numpy(c), sections["cond"]),
            "d16": stored(torch.cat([drgb, dsigma], -1), sections["d16"])}
  with torch.no_grad():
    plain = mlp_rounding.plain_stages(spec, params, inputs)
    got = mlp_rounding.stage_dw(spec, plain, torch.float32)
  want = mlp_kernel.fused_nerf_mlp_bwd_reference(
      spec, params, torch.from_numpy(x), torch.from_numpy(c), drgb, dsigma,
      bf16)[0::2]
  for g, w in zip(got, want):
    torch.testing.assert_close(g, w.t(), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("case", [
    ((63, 27, 8, 256, 4, 1, 128, 3, 1), None),
    ((63, 27, 8, 256, 4, 2, 128, 3, 1), None),
    ((63, 27, 8, 200, 4, 1, 128, 3, 1), None),
    ((200, 27, 8, 256, 4, 1, 128, 3, 1), None),
    ((63, 27, 8, 256, 4, 1, 128, 3, 1), (10, 4)),
    ((63, 27, 8, 256, 4, 1, 128, 3, 1), (9, 4)),
    ((63, 27, 5, 256, 4, 1, 128, 3, 1), None),
    ((63, 27, 4, 128, 2, 1, 128, 3, 1), None),
    ((63, 27, 8, 256, 4, 1, 128, 7, 2), None),
])
def test_supports_matches_jax(case):
  args, pe = case
  assert mlp_kernel.supports(*args, pe=pe) == j_kernel.supports(*args, pe=pe)


def test_inputs_that_require_grad_raise():
  _, port, pts, dirs, *_ = _setup(8, **SMALL)
  x = torch.from_numpy(pts).requires_grad_()
  with pytest.raises(ValueError, match="require grad"):
    mlp_kernel.fused_nerf_mlp(port, x, torch.from_numpy(dirs),
                              dtype=torch.float32, pe=(PTS_DEG, DIRS_DEG))
  with pytest.raises(ValueError, match="pe degrees"):
    mlp_kernel.fused_nerf_mlp(port, torch.from_numpy(pts),
                              torch.from_numpy(dirs), dtype=torch.float32,
                              pe=(9, DIRS_DEG))


def test_pe_cols_is_the_kernel_layout():
  """pe_cols against a column-by-column build of the kernel's layout
  (csrc/mlp_common.cuh:pe_col) and against pos_enc, bit for bit; against
  the JAX kernel's _pe_cols to an ulp (XLA's and torch's sin differ)."""
  p = np.random.RandomState(6).uniform(-6, 6, (512, 3)).astype(np.float32)
  pt = torch.from_numpy(p)
  got = t_math.pe_cols(pt, PTS_DEG)
  cols = [pt[:, j] for j in range(3)]
  for shift in (0.0, 0.5 * np.pi):
    for k in range(3 * PTS_DEG):
      cols.append(torch.sin(pt[:, k % 3] * float(2**(k // 3)) + shift)
                  if shift else torch.sin(pt[:, k % 3] * float(2**(k // 3))))
  assert torch.equal(got, torch.stack(cols, dim=-1))
  assert torch.equal(got, t_math.pos_enc(pt, 0, PTS_DEG))
  want = np.asarray(j_kernel._pe_cols(jnp.asarray(p), PTS_DEG))
  np.testing.assert_allclose(got.numpy(), want, atol=1.2e-7, rtol=0)


def _spec_and_tensors(width, pts_deg, pe):
  """A supported 8-layer geometry at `width` (condition layer too) with
  zero weights of its shapes and 4 rows of inputs, on the CPU."""
  feat, cond = 3 + 6 * pts_deg, COND
  spec = mlp_kernel.MlpSpec(8, width, 4, feat, cond, width, 3, 1,
                            (pts_deg, DIRS_DEG) if pe else None)
  params = []
  for k, n in mlp_kernel.layer_dims(spec):
    params += [torch.zeros((n, k)), torch.zeros((n,))]
  x = torch.zeros((4, 3 if pe else feat))
  c = torch.zeros((4, 3 if pe else cond))
  return spec, params, x, c


@pytest.mark.parametrize("pe", [False, True])
@pytest.mark.parametrize("pts_deg", [10, 16])
@pytest.mark.parametrize("width", [128, 256, 384, 512, 768, 1024])
def test_kernels_take_every_supported_width(width, pts_deg, pe):
  """Every geometry `supports` admits on this grid passes the kernels'
  check (the CUDA kernels' own limits), and runs the tiles that fit."""
  spec, params, x, c = _spec_and_tensors(width, pts_deg, pe)
  assert mlp_kernel.supports(spec.feat, spec.cond, 8, width, 4, 1, width,
                             3, 1, pe=spec.pe)
  mlp_kernel._check(spec, x, c, params, "test")
  assert mlp_kernel.wide(spec) == (width > 256 or pts_deg == 16)
  rows = mlp_kernel.tile_rows(spec, torch.bfloat16)
  assert mlp_kernel.SUPER_ROWS % rows == 0
  assert rows == (32 if mlp_kernel.wide(spec) else 128)


@pytest.mark.parametrize("width", [1152, 2048])
def test_kernels_name_their_width_limit(width):
  spec, params, x, c = _spec_and_tensors(width, 10, False)
  assert mlp_kernel.supports(spec.feat, spec.cond, 8, width, 4, 1, width, 3,
                             1)
  with pytest.raises(ValueError, match="multiples of 128 up to 1024"):
    mlp_kernel._check(spec, x, c, params, "mlp_fwd")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_gradients_are_taken_at_the_forward_activations(dtype):
  """The fused step's backward (plain K5) takes its gradients at the
  activations its forward (plain K4) returned: the values mlp_bwd stores
  are mlp_fwd's, bit for bit, and its gradients are those of the same
  forward."""
  dt = DTYPES[dtype]
  _, port, pts, dirs, *_ = _setup(96, **SMALL)
  spec = mlp_kernel.mlp_spec(port, (PTS_DEG, DIRS_DEG))
  params = [p.detach() for p in mlp_kernel.mlp_params(port)]
  x, c = torch.from_numpy(pts), torch.from_numpy(dirs)
  acts = {}
  rgb, sigma = mlp_kernel.mlp_fwd(spec, params, x, c, dt, acts=acts)
  want_rgb, want_sigma = mlp_kernel.fused_nerf_mlp_reference(spec, params,
                                                             x, c, dt)
  assert torch.equal(rgb, want_rgb) and torch.equal(sigma, want_sigma)
  assert sorted(acts) == sorted(n for n, _, _ in
                                mlp_kernel.forward_activations(spec))
  rng = np.random.RandomState(4)
  drgb = torch.from_numpy(rng.randn(96, 3).astype(np.float32))
  dsigma = torch.from_numpy(rng.randn(96, 1).astype(np.float32))
  stash = {}
  grads = mlp_kernel.mlp_bwd(spec, params, x, c, drgb, dsigma, dt,
                             stash=stash)
  stored = mlp_kernel.stored_values(spec, stash, 96)
  for name, value in acts.items():
    assert value.dtype == dt and torch.equal(stored[name], value), name
  # Taken at the forward's own activations, the gradients do not move.
  at = mlp_kernel.fused_nerf_mlp_bwd_reference(spec, params, x, c, drgb,
                                               dsigma, dt, at=acts)
  assert all(torch.equal(a, b) for a, b in zip(at, grads))
  if dt == torch.float32:
    ps = [p.clone().requires_grad_() for p in params]
    out = mlp_kernel.fused_nerf_mlp_reference(spec, ps, x, c, dt)
    want = torch.autograd.grad(out, ps, (drgb, dsigma))
    for g, w in zip(grads, want):
      torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
