"""The 'all'-stage march of the port against the JAX package.

The same numpy inputs and so3 weights go through the port's plain versions
of K2 (ops/march_kernel.march_full_reference) and K3
(ops/eikonal_vjp.march_bwd_reference) and through the JAX package's fused
Pallas kernels (interpret mode on the CPU) and its scan marcher with
autodiff. The setup is tests/test_eikonal_vjp.py's: a 64^3 Gaussian IOR
blob and a coherent 128-ray pencil (two for the two-block case), whose
paths stay inside every JAX window, so nothing is clamped.

Tolerances: forward atol 1e-5 (fp32, the so3 products summed in another
order by the two backends; measured here <= 2e-6). Gradients: the JAX
package's own reverse-sweep tolerance, atol 2e-4 * max|ref|, rtol 2e-3 per
tensor (tests/test_eikonal_vjp.py:108-111).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from samplenerfro_torch.ops import eikonal as t_eik
from samplenerfro_torch.ops import eikonal_vjp as t_vjp
from samplenerfro_torch.ops import grid as t_grid
from samplenerfro_torch.ops import march_kernel as t_mk
from samplenerfro_torch.ops import math as t_math
from samplenerfro_torch.ops import mlp as t_mlp
from samplenerfro_tpu.ops import eikonal as j_eik
from samplenerfro_tpu.ops import eikonal_vjp as j_vjp
from samplenerfro_tpu.ops import grid as j_grid
from samplenerfro_tpu.ops import math as j_math
from samplenerfro_tpu.ops import mlp as j_mlp
from samplenerfro_tpu.ops.pallas import march_bwd_kernel
from samplenerfro_tpu.ops.pallas import march_kernel as j_mk

MAX_DEG = 6
SO3_KEY = (0, MAX_DEG, True, True, True, False)
N, NEAR, S, REFETCH, WINDOW, BLOCK = 64, 2.0, 16, 4, 16, 128
H = 4.0 / 31
FWD_ATOL = 1e-5


def _grid():
  spec = j_grid.GridSpec([N] * 3, [-1.5] * 3, [1.5] * 3)
  axes = np.linspace(-1.5, 1.5, N)
  xx, yy, zz = np.meshgrid(axes, axes, axes, indexing="ij")
  vals = (1.0 + 0.3 * np.exp(-(xx**2 + yy**2 + zz**2) / 0.25)).reshape(-1, 1)
  vals = vals.astype(np.float32)
  grad = t_grid.central_difference_grad_numpy(spec, vals)
  data = np.concatenate([vals, grad], axis=-1).astype(np.float32)
  return spec, data


def _rays(nblocks):
  d = np.array([[0.0008 * (i % 16), 0.0005 * (i // 16), 1.0]
                for i in range(BLOCK)], np.float32)
  d /= np.linalg.norm(d, axis=-1, keepdims=True)
  o = np.broadcast_to(np.array([0, 0, -4.0], np.float32), d.shape).copy()
  if nblocks == 2:
    o = np.concatenate([o, o + np.array([0.6, -0.35, 0.0], np.float32)])
    d = np.concatenate([d, d])
  return o, d


def _so3(width=32, std=1e-2):
  params = j_mlp.mlp_init(random.PRNGKey(7), 6 * MAX_DEG, net_depth=4,
                          net_width=width, skip_layer=2, num_out_channels=3,
                          output_init_std=std)
  params = jax.tree_util.tree_map(np.asarray, params)
  flat = []
  for name in ("Dense_0", "Dense_1", "Dense_2", "Dense_3", "Dense_out"):
    flat += [torch.from_numpy(params[name]["kernel"].T.copy()),
             torch.from_numpy(params[name]["bias"].copy())]
  return params, flat


def _cotangents(nrays, seed):
  rng = np.random.RandomState(seed)
  return [rng.randn(nrays, S, c).astype(np.float32) for c in (3, 3, 1, 1, 3)]


def _torch_traj(spec, data, o, d, flat, alpha):
  tspec = t_grid.GridSpec(spec.ndim, spec.nmin, spec.nmax)
  traj = t_mk.march_full(tspec, torch.from_numpy(data), torch.from_numpy(o),
                         torch.from_numpy(d), NEAR, H, S, flat, alpha,
                         MAX_DEG)
  return tspec, traj


def test_annealed_pos_enc_matches_jax():
  x = np.random.RandomState(0).uniform(-1.5, 1.5, (7, 5, 3)).astype(
      np.float32)
  for alpha in (0.0, 3.3, 6.0, 10.0):
    got = t_math.annealed_pos_enc(torch.from_numpy(x), 0, 10, alpha)
    want = j_math.annealed_pos_enc(jnp.asarray(x), 0, 10, alpha)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_learning_rate_decay_matches_jax():
  kw = dict(lr_init=5e-4, lr_final=5e-6, max_steps=200000,
            lr_delay_steps=2500, lr_delay_mult=0.01)
  for step in (0, 1, 2, 1250, 2500, 99999, 200000, 250000):
    for extra in ({}, {"lr_start_steps": 2500, "lr_delay_steps": 0}):
      args = {**kw, **extra}
      got = t_math.learning_rate_decay(step, **args)
      want = float(j_math.learning_rate_decay(jnp.int32(step), **args))
      np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=str(step))


def test_rodrigues_rotate_matches_jax():
  rng = np.random.RandomState(1)
  raw = (rng.randn(64, 3) * np.array([[1.0], [1e-4]] * 32)).astype(np.float32)
  g = rng.randn(64, 3).astype(np.float32)
  g[:4] *= 1e-5  # the safe-norm floor
  got = t_eik.rodrigues_rotate(torch.from_numpy(raw), torch.from_numpy(g))
  want = j_eik.rodrigues_rotate(jnp.asarray(raw), jnp.asarray(g))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_so3_mlp_matches_jax():
  params, flat = _so3(width=128, std=1e-5)
  x = np.random.RandomState(2).randn(50, 36).astype(np.float32)
  got = t_mlp.apply_params(flat, torch.from_numpy(x))
  want = j_mlp.mlp_apply(params, jnp.asarray(x))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7,
                             rtol=1e-5)
  m = t_mlp.So3MLP(60, generator=torch.Generator().manual_seed(0))
  assert list(m.layers) == ["Dense_0", "Dense_1", "Dense_2", "Dense_3",
                            "Dense_out"]
  assert m.layers["Dense_3"].in_features == 188
  assert float(m.layers["Dense_out"].weight.std()) < 1e-4


@pytest.mark.parametrize("nblocks", [1, 2])
def test_plain_k2_matches_pallas_and_scan(nblocks):
  spec, data = _grid()
  o, d = _rays(nblocks)
  params, flat = _so3()
  alpha = 0.6
  _, traj = _torch_traj(spec, data, o, d, flat, alpha)
  got = t_mk.split_trajectory(traj)

  data3d = jnp.asarray(data).reshape(N, N, N * 4)
  pos, dirs, dist, nv, g, oow = j_mk.march_tiled_pallas(
      spec, data3d, jnp.asarray(o), jnp.asarray(d), NEAR, H, S,
      block_size=BLOCK, window=WINDOW, refetch_every=REFETCH,
      so3_params=params, annealed_alpha=alpha, max_deg=MAX_DEG,
      normalize_dirs=False, interpret=True)
  assert int(oow) == 0, "the JAX march clamped"
  so3_apply = j_vjp.make_so3_apply(*SO3_KEY)
  scan = j_eik.march(spec, jnp.asarray(data), jnp.asarray(o), jnp.asarray(d),
                     NEAR, H, S, pred_grad_fn=lambda p, gg: so3_apply(
                         params, alpha, p, gg), use_pred_grad=True)
  names = ("pos", "dirs", "dist", "n", "g")
  for name, a, b in zip(names, got, (pos, dirs, dist, nv, g)):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=FWD_ATOL,
                               err_msg=f"pallas {name}")
  got_unit = t_math.safe_l2_normalize(got[1])
  for name, a, b in zip(names, (got[0], got_unit) + got[2:], scan):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=FWD_ATOL,
                               err_msg=f"scan {name}")
  # The head bends the paths (by ~5e-4 over these 16 steps): far more than
  # the tolerance, so the comparison above sees the so3 refinement.
  plain = t_eik.march(t_grid.GridSpec(spec.ndim, spec.nmin, spec.nmax),
                      torch.from_numpy(data), torch.from_numpy(o),
                      torch.from_numpy(d), NEAR, H, S)
  assert float((plain[0] - got[0]).abs().max()) > 20 * FWD_ATOL


def _assert_grads(got, want, what):
  want = np.asarray(want)
  scale = max(float(np.abs(want).max()), 1e-3)
  np.testing.assert_allclose(np.asarray(got), want, atol=2e-4 * scale,
                             rtol=2e-3, err_msg=what)


def test_plain_k3_matches_pallas_sweep():
  spec, data = _grid()
  o, d = _rays(2)
  params, flat = _so3()
  alpha = 0.6
  tspec, traj = _torch_traj(spec, data, o, d, flat, alpha)
  pos, dirs_raw, dist, nv, g = (x.numpy() for x in
                                t_mk.split_trajectory(traj))
  dpos, ddir, ddist, dn, dg = _cotangents(o.shape[0], 3)
  dtraj = torch.from_numpy(np.concatenate([dpos, ddir, ddist, dn, dg], -1))
  cfg = t_vjp.MarchConfig(tspec, NEAR, H, S, MAX_DEG)
  obar, dbar, abar, pgrads = t_vjp.march_bwd(
      cfg, torch.from_numpy(data), torch.from_numpy(o), torch.from_numpy(d),
      flat, alpha, traj, dtraj)

  segbar = t_vjp._segbar(torch.from_numpy(ddist[..., 0])).numpy()
  data3d = jnp.asarray(data).reshape(N, N, N * 4)
  j_ob, j_db, j_ab, j_th = march_bwd_kernel.march_bwd_pallas(
      spec, data3d, jnp.asarray(pos), jnp.asarray(dirs_raw), jnp.asarray(nv),
      jnp.asarray(g), jnp.asarray(dpos), jnp.asarray(ddir), jnp.asarray(dn),
      jnp.asarray(dg), jnp.asarray(segbar), params, jnp.float32(alpha), NEAR,
      H, BLOCK, WINDOW, REFETCH, MAX_DEG, interpret=True)
  _assert_grads(obar, j_ob, "origins")
  _assert_grads(dbar, j_db, "directions")
  _assert_grads(abar, j_ab, "alpha")
  names = ("Dense_0", "Dense_1", "Dense_2", "Dense_3", "Dense_out")
  for i, name in enumerate(names):
    _assert_grads(pgrads[2 * i].t(), j_th[name]["kernel"], f"{name} kernel")
    _assert_grads(pgrads[2 * i + 1], j_th[name]["bias"], f"{name} bias")


def test_plain_k3_matches_jax_autodiff():
  spec, data = _grid()
  o, d = _rays(1)
  params, flat = _so3()
  alpha = 0.45
  tspec, traj = _torch_traj(spec, data, o, d, flat, alpha)
  cots = _cotangents(o.shape[0], 5)
  wp, wd, wt, wn, wg = cots
  cfg = t_vjp.MarchConfig(tspec, NEAR, H, S, MAX_DEG)
  so3_apply = j_vjp.make_so3_apply(*SO3_KEY)
  # The JAX march emits unit directions: its cotangent on them becomes
  # the port's cotangent on the raw directions by the normalisation's vjp.
  dirs_raw = traj[..., 3:6].detach().requires_grad_()
  unit = t_math.safe_l2_normalize(dirs_raw)
  ddir_raw, = torch.autograd.grad(unit, dirs_raw, torch.from_numpy(wd))
  dtraj2 = torch.from_numpy(np.concatenate(cots, -1))
  dtraj2[..., 3:6] = ddir_raw
  got = t_vjp.march_bwd(cfg, torch.from_numpy(data), torch.from_numpy(o),
                        torch.from_numpy(d), flat, alpha, traj, dtraj2)

  def jloss(o_, d_, al_, th_):
    pos, dirs, dist, nv, g = j_eik.march(
        spec, jnp.asarray(data), o_, d_, NEAR, H, S,
        pred_grad_fn=lambda p, gg: so3_apply(th_, al_, p, gg),
        use_pred_grad=True)
    return (jnp.sum(pos * wp) + jnp.sum(dirs * wd) + jnp.sum(dist * wt[..., 0])
            + jnp.sum(nv * wn) + jnp.sum(g * wg))

  want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
      jnp.asarray(o), jnp.asarray(d), jnp.float32(alpha), params)
  _assert_grads(got[0], want[0], "origins")
  _assert_grads(got[1], want[1], "directions")
  _assert_grads(got[2], want[2], "alpha")
  names = ("Dense_0", "Dense_1", "Dense_2", "Dense_3", "Dense_out")
  for i, name in enumerate(names):
    _assert_grads(got[3][2 * i].t(), want[3][name]["kernel"], name)
    _assert_grads(got[3][2 * i + 1], want[3][name]["bias"], name)


def test_allstage_function_gradients_flow():
  spec, data = _grid()
  o, d = _rays(1)
  _, flat = _so3()
  flat = [p.requires_grad_() for p in flat]
  tspec = t_grid.GridSpec(spec.ndim, spec.nmin, spec.nmax)
  cfg = t_vjp.MarchConfig(tspec, NEAR, H, S, MAX_DEG)
  o_t = torch.from_numpy(o).requires_grad_()
  traj = t_vjp.march_allstage(cfg, torch.from_numpy(data), o_t,
                              torch.from_numpy(d), 0.6, flat)
  assert traj.shape == (BLOCK, S, 11)
  (traj[..., 0:3].sin().sum()).backward()
  assert o_t.grad is not None and bool(torch.isfinite(o_t.grad).all())
  assert all(p.grad is not None and float(p.grad.abs().sum()) > 0
             for p in flat)


# The three-pass plain version of K3 (eikonal_vjp.march_bwd_passes_reference)
# at the so3 head's ship width and PE degree, on a 32^3 blob. alpha * 10
# lies inside a window band (at 0.6 or 0.7 it sits on a band's edge,
# where the window's derivative is a rounding of 0).
P_N, P_MAX_DEG, P_ALPHA = 32, 10, 0.45
P_SO3_KEY = (0, P_MAX_DEG, True, True, True, False)


def _passes_setup(nrays, steps):
  spec = j_grid.GridSpec([P_N] * 3, [-1.5] * 3, [1.5] * 3)
  axes = np.linspace(-1.5, 1.5, P_N)
  xx, yy, zz = np.meshgrid(axes, axes, axes, indexing="ij")
  vals = (1.0 + 0.3 * np.exp(-(xx**2 + yy**2 + zz**2) / 0.25)).reshape(-1, 1)
  vals = vals.astype(np.float32)
  grad = t_grid.central_difference_grad_numpy(spec, vals)
  data = np.concatenate([vals, grad], axis=-1).astype(np.float32)
  d = np.array([[0.003 * (i % 4), 0.002 * (i // 4), 1.0]
                for i in range(nrays)], np.float32)
  d /= np.linalg.norm(d, axis=-1, keepdims=True)
  o = np.broadcast_to(np.array([0.1, -0.05, -4.0], np.float32),
                      d.shape).copy()
  o[nrays // 2:] += np.array([0.3, -0.2, 0.0], np.float32)
  params = j_mlp.mlp_init(random.PRNGKey(7), 6 * P_MAX_DEG, net_depth=4,
                          net_width=128, skip_layer=2, num_out_channels=3,
                          output_init_std=1e-2)
  params = jax.tree_util.tree_map(np.asarray, params)
  flat = []
  for name in ("Dense_0", "Dense_1", "Dense_2", "Dense_3", "Dense_out"):
    flat += [torch.from_numpy(params[name]["kernel"].T.copy()),
             torch.from_numpy(params[name]["bias"].copy())]
  tspec = t_grid.GridSpec(spec.ndim, spec.nmin, spec.nmax)
  cfg = t_vjp.MarchConfig(tspec, NEAR, H, steps, P_MAX_DEG)
  traj = t_mk.march_full_reference(tspec, torch.from_numpy(data),
                                   torch.from_numpy(o), torch.from_numpy(d),
                                   NEAR, H, steps, flat, P_ALPHA, P_MAX_DEG)
  rng = np.random.RandomState(nrays + steps)
  cots = [rng.randn(nrays, steps, c).astype(np.float32)
          for c in (3, 3, 1, 1, 3)]
  return spec, data, o, d, params, flat, cfg, traj, cots


def _assert_k3(got, want, what):
  """The K3 tolerance per tensor: |got - want| <= 2e-4 max|want| + 2e-3
  |want|."""
  got, want = np.asarray(got), np.asarray(want)
  scale = float(np.abs(want).max())
  assert np.all(np.isfinite(got)), what
  assert np.all(np.abs(got - want) <= 2e-4 * scale + 2e-3 * np.abs(want)), (
      what, float(np.abs(got - want).max()), scale)


@pytest.mark.parametrize("nrays,steps", [(8, 24), (16, 48)])
def test_passes_reference_matches_autograd(nrays, steps):
  _, data, o, d, _, flat, cfg, traj, cots = _passes_setup(nrays, steps)
  active = float((traj[..., 8:11].norm(dim=-1) > 1e-3).float().mean())
  assert 0.2 < active < 1.0  # both kinds of step are swept
  dtraj = torch.from_numpy(np.concatenate(cots, -1))
  args = (cfg, torch.from_numpy(data), torch.from_numpy(o),
          torch.from_numpy(d), flat, P_ALPHA)
  got = t_vjp.march_bwd_passes_reference(*args, traj, dtraj)
  want = t_vjp.march_bwd_reference(*args, dtraj)
  names = ["origins", "directions", "alpha"] + [f"so3 {i}" for i in
                                                range(10)]
  flat_of = lambda r: [r[0], r[1], r[2]] + list(r[3])
  for name, a, b in zip(names, flat_of(got), flat_of(want)):
    _assert_k3(a, b, name)


@pytest.mark.parametrize("nrays,steps", [(8, 24), (16, 48)])
def test_passes_reference_matches_jax_passes(nrays, steps):
  spec, data, o, d, params, flat, cfg, traj, cots = _passes_setup(nrays,
                                                                  steps)
  wp, wd, wt, wn, wg = cots
  # The JAX march emits unit directions: their cotangent becomes the raw
  # directions' by the normalisation's vjp.
  dirs_raw = traj[..., 3:6].detach().requires_grad_()
  unit = t_math.safe_l2_normalize(dirs_raw)
  ddir_raw, = torch.autograd.grad(unit, dirs_raw, torch.from_numpy(wd))
  dtraj = torch.from_numpy(np.concatenate(cots, -1))
  dtraj[..., 3:6] = ddir_raw
  got = t_vjp.march_bwd_passes_reference(
      cfg, torch.from_numpy(data), torch.from_numpy(o), torch.from_numpy(d),
      flat, P_ALPHA, traj, dtraj)

  march = j_vjp.make_march_allstage(spec, NEAR, H, steps, nrays // 2, 16, 4,
                                    P_SO3_KEY, "tiled", bwd_impl="passes")
  data3d = jnp.asarray(data).reshape(P_N, P_N, P_N * 4)
  out = march(data3d, jnp.asarray(o), jnp.asarray(d), jnp.float32(P_ALPHA),
              params)
  assert int(out[5]) == 0, "the JAX march clamped"

  def jloss(o_, d_, al_, th_):
    pos, dirs, dist, nv, g, _ = march(data3d, o_, d_, al_, th_)
    return (jnp.sum(pos * wp) + jnp.sum(dirs * wd) + jnp.sum(dist * wt[..., 0])
            + jnp.sum(nv * wn) + jnp.sum(g * wg))

  want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
      jnp.asarray(o), jnp.asarray(d), jnp.float32(P_ALPHA), params)
  _assert_k3(got[0], want[0], "origins")
  _assert_k3(got[1], want[1], "directions")
  _assert_k3(got[2], want[2], "alpha")
  for i, name in enumerate(("Dense_0", "Dense_1", "Dense_2", "Dense_3",
                            "Dense_out")):
    _assert_k3(got[3][2 * i].t(), want[3][name]["kernel"], f"{name} kernel")
    _assert_k3(got[3][2 * i + 1], want[3][name]["bias"], f"{name} bias")


def _kernel_pass3_sums(wfwd, wbwd, pos, g, ub, window, max_deg):
  """What K3's pass 3 sums (csrc/march_bwd.cu:param_tile), in its layout:
  the padded forward pack's order, the first layer's rows and the fourth
  layer's skip rows against the PE's sines before the window. Its
  backward products read the backward pack."""
  hid, in_dim = t_vjp.HIDDEN, 6 * max_deg
  sizes = [in_dim * hid, hid, hid * hid, hid, hid * hid, hid,
           (hid + in_dim) * hid, hid, hid * 3, 3]
  w0t, b0, w1t, b1, w2t, b2, w3t, b3, wot, bo = torch.split(wfwd, sizes)
  w0t, w1t, w2t = w0t.view(in_dim, hid), w1t.view(hid, hid), w2t.view(
      hid, hid)
  w3t, wot = w3t.view(hid + in_dim, hid), wot.view(hid, 3)
  w1, w2, w3h = wbwd.view(3, hid, hid)
  scales = torch.tensor([2.0**i for i in range(max_deg)])
  xb = pos[:, None, :] * scales[:, None]
  val = torch.sin(torch.cat([xb, xb + 0.5 * np.pi], -1)).reshape(
      pos.shape[0], -1)
  x = (val.view(-1, max_deg, 6) * window[:, None]).reshape(val.shape)
  h0 = torch.relu(x @ w0t + b0)
  h1 = torch.relu(h0 @ w1t + b1)
  h2 = torch.relu(h1 @ w2t + b2)
  h3 = torch.relu(torch.cat([h2, x], -1) @ w3t + b3)
  raw = (h3 @ wot + bo).detach().requires_grad_()
  rawbar, = torch.autograd.grad(t_eik.rodrigues_rotate(raw, g), raw, ub)
  dz3 = (rawbar @ wot.t()) * (h3 > 0)
  dz2 = (dz3 @ w3h) * (h2 > 0)
  dz1 = (dz2 @ w2) * (h1 > 0)
  dz0 = (dz1 @ w1) * (h0 > 0)
  parts = [val.t() @ dz0, dz0.sum(0), h0.t() @ dz1, dz1.sum(0),
           h1.t() @ dz2, dz2.sum(0), torch.cat([h2, val], -1).t() @ dz3,
           dz3.sum(0), h3.t() @ rawbar, rawbar.sum(0)]
  return torch.cat([p.reshape(-1) for p in parts])


@pytest.mark.parametrize("width", [32, 128])
def test_k3_packs_and_sums_give_the_head_gradients(width):
  """K3's weight packs (hidden units padded to 128), the sums its pass 3
  takes, and the wrapper's unpacking (the window applied to the first
  layer's and the skip rows, the window's cotangent from them) give the
  so3 head's weight and alpha gradients."""
  max_deg = P_MAX_DEG
  head = t_mlp.So3MLP(6 * max_deg, net_width=width, output_init_std=1e-2,
                      generator=torch.Generator().manual_seed(3))
  so3 = [p.detach() for p in head.params()]
  rng = np.random.RandomState(5)
  pos = torch.from_numpy(rng.uniform(-1, 1, (96, 3)).astype(np.float32))
  g = torch.from_numpy(rng.randn(96, 3).astype(np.float32))
  ub = torch.from_numpy(rng.randn(96, 3).astype(np.float32))
  alpha = torch.tensor(P_ALPHA)
  window = t_mk.so3_window(alpha, max_deg)
  wfwd, wbwd = t_vjp.so3_packs(so3)
  sums = _kernel_pass3_sums(wfwd, wbwd, pos, g, ub, window, max_deg)
  wbar, got = t_vjp._unpack_grads(so3, sums, window, max_deg, wfwd)
  a = alpha.clone().requires_grad_()
  got_alpha, = torch.autograd.grad(t_mk.so3_window(a, max_deg), a, wbar)

  ps = [p.clone().requires_grad_() for p in so3]
  a = alpha.clone().requires_grad_()
  x = t_math.annealed_pos_enc(pos, 0, max_deg, a * max_deg)
  u = t_eik.rodrigues_rotate(t_mlp.apply_params(ps, x), g)
  want = torch.autograd.grad(u, [a, *ps], ub)
  _assert_k3(got_alpha, want[0], "alpha")
  for i, (gr, w) in enumerate(zip(got, want[1:])):
    assert gr.shape == w.shape, i
    _assert_k3(gr, w, f"so3 param {i}")


# K2's launch geometry (ops/march_kernel.so3_launch_geometry): the ship
# batch (1024 x 768), the self-check's (256 x 192), glass's (1024 x 1536)
# and ragged batches; the head widths and PE degrees K2 takes.
@pytest.mark.parametrize("batch", [1024, 256, 1, 7, 257, 1000])
@pytest.mark.parametrize("width", [32, 64, 128])
@pytest.mark.parametrize("max_deg", [1, 4, 10])
def test_so3_geometry_covers_rays_and_weights_once(batch, width, max_deg):
  g = t_mk.so3_launch_geometry(batch, width, max_deg)
  per, c = g["rays_per_cluster"], g["cluster"]
  assert g["ctas"] == c * g["clusters"] and g["threads"] == 8 * per
  covered = np.zeros(batch, np.int64)
  for k in range(g["clusters"]):
    rays = np.arange(k * per, min((k + 1) * per, batch))
    assert rays.size > 0, f"cluster {k} has no ray"
    covered[rays] += 1
  assert (covered == 1).all()
  assert g["smem_bytes"] <= t_mk.SMEM_LIMIT == 232448
  # Each rank keeps the input-major columns [lo, hi) of the padded head's
  # layers 1-3: every element of their weights and biases belongs to
  # exactly one rank. Layer 0 and the output layer are kept whole by every
  # rank.
  in_dim = 6 * max_deg
  shapes = [(width, width), (width,), (width, width), (width,),
            (width, width + in_dim), (width,)]
  owners = [np.zeros(s, np.int64) for s in shapes]
  for lo, hi in g["columns"]:
    assert 0 <= lo < hi <= t_mk.SO3_PAD_WIDTH
    for o in owners:
      o[lo:hi] += 1  # nn.Linear layout: a row a column of the head
  assert all((o == 1).all() for o in owners)
  assert sum(hi - lo for lo, hi in g["columns"]) == t_mk.SO3_PAD_WIDTH
  assert g["whole"] == ["Dense_0", "Dense_out"]


def test_so3_geometry_names_its_limits():
  with pytest.raises(ValueError, match="at least 1"):
    t_mk.so3_launch_geometry(0, 128, 10)
  with pytest.raises(ValueError, match="128"):
    t_mk.so3_launch_geometry(1024, 129, 10)
  for deg in (0, 11):
    with pytest.raises(ValueError, match="max_deg <= 10"):
      t_mk.so3_launch_geometry(1024, 128, deg)
