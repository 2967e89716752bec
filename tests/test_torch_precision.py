"""The shipped configs' reduced-precision arms of the port (ops/precision.py).

march_interp / march_interp_all (the forward interpolation at "default",
one bf16 pass, and "high", bf16x3) and march_bwd_dtype = bfloat16 (K2's
so3 head and K3's reverse sweep at bf16 operands), held on the CPU:

(a) each plain reduced arm against a float64 evaluation of its own
    rounding points: the fp32 run records every bf16 rounding, and the
    float64 twin takes those values at the same points, after checking
    that each is a bf16 rounding of its own value (within half a bf16 ulp,
    2^-8 relative, and fp32 round-off of the tensor's scale). The two then
    differ only by the fp32 sums: held at 1e-6 of the largest output
    (interpolation), 1e-5 (the head; the sweep, per tensor, over its
    768-term recurrence and its sums over thousands of ray-steps);
(b) the port's bf16 gradients against the JAX package's
    make_march_allstage(bwd_impl="passes", bwd_dtype="bfloat16") and
    against its fp32 sweep, in the JAX test's own bf16 form
    (tests/test_eikonal_vjp.py:174-212): the flat so3 parameter gradient
    within 2e-2 relative L2, the origins' gradient at cosine >= 0.999;
(c) the forward interpolation arms against the JAX package's fp32 march
    within the JAX self-check's bf16 envelope, 0.05 of scale
    (samplenerfro_tpu/train/selfcheck.py:155-184);
(d) the port's effective_march_interp against the JAX package's for every
    stage and flag combination;
(e) the default flags (highest, float32) bit for bit the fp32 paths the
    port ran before the arms: the lerps, the fp32 head, K3's autograd plain
    version, the model a config without the flags builds.
And matmul_precision sets torch's float32 matmul precision, "highest"
leaving the forward bit for bit.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import random

from samplenerfro_torch.models import nerf as t_nerf
from samplenerfro_torch.ops import eikonal_vjp as t_vjp
from samplenerfro_torch.ops import grid as t_grid
from samplenerfro_torch.ops import march_kernel as t_mk
from samplenerfro_torch.ops import math as t_math
from samplenerfro_torch.ops import mlp as t_mlp
from samplenerfro_torch.ops import precision
from samplenerfro_torch.train import selfcheck as t_selfcheck
from samplenerfro_torch.utils import config as t_config
from samplenerfro_torch.utils import probes
from samplenerfro_tpu.models import nerf as j_nerf
from samplenerfro_tpu.ops import eikonal as j_eik
from samplenerfro_tpu.ops import eikonal_vjp as j_vjp
from samplenerfro_tpu.ops import grid as j_grid
from samplenerfro_tpu.ops import mlp as j_mlp

# tests/test_eikonal_vjp.py's setup, at which its bf16 form is stated.
N, NEAR, S, MAX_DEG, WIDTH = 64, 2.0, 32, 6, 32
H = 4.0 / (S - 1)
SO3_KEY = (0, MAX_DEG, True, True, True, False)
LAYERS = ("Dense_0", "Dense_1", "Dense_2", "Dense_3", "Dense_out")
BF16_HALF_ULP = 2.0**-8   # half a bf16 ulp, relative
# (a): how far the twin's value at a rounding point may stand from the fp32
# run's, of the tensor's largest: fp32 round-off upstream (a position's 24
# bits in a fraction, a sum's), which a bf16 lo part sees 2^9 larger.
INPUT_SLACK = 2.0**-12
INTERP_TOL = 1e-6         # (a): of the largest output
SUM_TOL = 1e-5            # (a): the head and the sweep, per tensor
GRAD_REL_L2 = 2e-2        # (b)
ORIGINS_COSINE = 0.999    # (b)
ENVELOPE = 0.05           # (c)


class Rounding:
  """precision.bf16 that records what it returns; after replay(), each
  call returns the recorded value at that point instead, in the caller's
  dtype, once it has checked that the value is a bf16 rounding of the
  caller's own (within half a bf16 ulp and fp32 round-off)."""

  def __init__(self):
    self.values, self.i, self.replaying = [], 0, False

  def replay(self):
    self.replaying, self.i = True, 0
    return self

  def __call__(self, x):
    if not self.replaying:
      y = precision.bf16(x)
      self.values.append(y.detach())
      return y
    y = self.values[self.i].to(x.dtype)
    self.i += 1
    slack = (BF16_HALF_ULP * x.abs()
             + INPUT_SLACK * float(x.abs().max()) + 1e-30)
    assert bool(((y - x).abs() <= slack).all()), f"rounding point {self.i}"
    return y


def _grid(n=N):
  spec = j_grid.GridSpec([n] * 3, [-1.5] * 3, [1.5] * 3)
  axes = np.linspace(-1.5, 1.5, n)
  xx, yy, zz = np.meshgrid(axes, axes, axes, indexing="ij")
  vals = (1.0 + 0.3 * np.exp(-(xx**2 + yy**2 + zz**2) / 0.25)).reshape(-1, 1)
  vals = vals.astype(np.float32)
  grad = t_grid.central_difference_grad_numpy(spec, vals)
  data = np.concatenate([vals, grad], axis=-1).astype(np.float32)
  return spec, t_grid.GridSpec(spec.ndim, spec.nmin, spec.nmax), data


def _rays(nrays=16):
  """tests/test_eikonal_vjp.py's rays: two blocks of 8 (its block 16 is
  the first 16)."""
  d = np.array([[0.002 * (i % 4), 0.001 * (i // 4), 1.0]
                for i in range(nrays)], np.float32)
  d /= np.linalg.norm(d, axis=-1, keepdims=True)
  o = np.broadcast_to(np.array([0, 0, -4.0], np.float32), d.shape).copy()
  return o, d


def _so3(width=WIDTH, max_deg=MAX_DEG):
  params = j_mlp.mlp_init(random.PRNGKey(7), 6 * max_deg, net_depth=4,
                          net_width=width, skip_layer=2, num_out_channels=3,
                          output_init_std=1e-2)
  params = jax.tree_util.tree_map(np.asarray, params)
  flat = []
  for name in LAYERS:
    flat += [torch.from_numpy(params[name]["kernel"].T.copy()),
             torch.from_numpy(params[name]["bias"].copy())]
  return params, flat


def _points(n, seed=0):
  return torch.from_numpy(np.random.RandomState(seed).uniform(
      -1.45, 1.45, (n, 3)).astype(np.float32))


# ------------------------------------------------------------------ (a)

@pytest.mark.parametrize("interp", ["default", "high"])
def test_interp_arm_against_a_float64_twin(interp):
  _, spec, data = _grid(16)
  data = torch.from_numpy(data)
  pts = _points(2000)
  corners, fracs = t_grid.cell_corners(spec, data, pts)
  rnd = Rounding()
  got = t_grid.contracted(corners, *fracs, interp, rnd=rnd)
  assert torch.equal(got, t_grid.trilinear(spec, data, pts, interp))
  want = t_grid.contracted([c.double() for c in corners],
                           *[f.double() for f in fracs], interp,
                           rnd=rnd.replay())
  assert rnd.i == len(rnd.values) > 0
  scale = float(want.abs().max())
  assert float((got.double() - want).abs().max()) <= INTERP_TOL * scale
  # The arm rounds: against the fp32 lerps it is off by bf16, not fp32.
  exact = t_grid.trilinear(spec, data.double(), pts.double())
  assert 1e-6 * scale < float((want - exact).abs().max()) < 0.02 * scale


def test_bf16_head_against_a_float64_twin():
  _, flat = _so3(128, 10)
  x = t_math.annealed_pos_enc(_points(500), 0, 10, torch.tensor(6.0))
  rnd = Rounding()
  got = t_mlp.apply_params(flat, x, rnd=rnd)
  want = t_mlp.apply_params([p.double() for p in flat], x.double(),
                            rnd=rnd.replay())
  assert rnd.i == len(rnd.values) == 10   # x, 5 weights, 4 activations
  scale = float(want.abs().max())
  assert float((got.double() - want).abs().max()) <= SUM_TOL * scale
  fp32 = t_mlp.apply_params(flat, x)
  assert float((fp32 - got).abs().max()) > 1e-4 * scale


def _k3_inputs(nrays=16, steps=24, bwd_dtype="bfloat16"):
  jspec, spec, data = _grid()
  o, d = _rays(nrays)
  _, flat = _so3()
  cfg = t_vjp.MarchConfig(spec, NEAR, 4.0 / (steps - 1), steps, MAX_DEG,
                          "highest", bwd_dtype)
  data, o, d = (torch.from_numpy(a) for a in (data, o, d))
  traj = t_mk.march_full_reference(spec, data, o, d, NEAR, cfg.step_size,
                                   steps, flat, 0.5, MAX_DEG,
                                   bwd_dtype=bwd_dtype)
  dtraj = torch.from_numpy(np.random.RandomState(3).randn(
      *traj.shape).astype(np.float32))
  return cfg, data, o, d, flat, traj, dtraj


def _flat(r):
  return [r[0], r[1], r[2].reshape(1)] + list(r[3])


def test_k3_bf16_sweep_against_a_float64_twin():
  cfg, data, o, d, flat, traj, dtraj = _k3_inputs(nrays=16, steps=24)
  rnd = Rounding()
  got = t_vjp.march_bwd_passes_reference(cfg, data, o, d, flat, 0.5, traj,
                                         dtraj, rnd=rnd)
  want = t_vjp.march_bwd_passes_reference(
      cfg, data.double(), o.double(), d.double(),
      [p.double() for p in flat], 0.5, traj.double(), dtraj.double(),
      rnd=rnd.replay())
  assert rnd.i == len(rnd.values)
  for i, (g, w) in enumerate(zip(_flat(got), _flat(want))):
    scale = float(w.abs().max())
    assert float((g.double() - w).abs().max()) <= SUM_TOL * scale, i


# ------------------------------------------------------------------ (b)

def _port_grads(bwd_dtype, nrays=16):
  _, spec, data = _grid()
  o, d = _rays(nrays)
  _, flat = _so3()
  cfg = t_vjp.MarchConfig(spec, NEAR, H, S, MAX_DEG, "highest", bwd_dtype)
  ot = torch.from_numpy(o).requires_grad_()
  ps = [p.clone().requires_grad_() for p in flat]
  traj = t_vjp.march_allstage(cfg, torch.from_numpy(data), ot,
                              torch.from_numpy(d), 0.5, ps)
  pos, dirs, dist, nv, g = t_mk.split_trajectory(traj)
  loss = (torch.sin(pos).sum() + t_math.safe_l2_normalize(dirs).sum()
          + dist.sum() + nv.sum() + g.sum())
  grads = torch.autograd.grad(loss, [ot, *ps])
  return grads[0].numpy(), np.concatenate(
      [grads[1 + 2 * i + k].numpy().T.ravel() if k == 0 else
       grads[1 + 2 * i + k].numpy().ravel()
       for i in range(5) for k in (0, 1)])


@pytest.fixture(scope="module")
def jax_grads():
  jspec, _, data = _grid()
  o, d = _rays()
  params, _ = _so3()
  data3d = jnp.asarray(data).reshape(N, N, N * 4)
  out = {}
  for dt in ("float32", "bfloat16"):
    march = j_vjp.make_march_allstage(jspec, NEAR, H, S, 16, 16, 4, SO3_KEY,
                                      "tiled", bwd_dtype=dt,
                                      bwd_impl="passes")

    def loss(o_, th_, march=march):
      pos, dirs, dist, nv, g, _ = march(data3d, o_, jnp.asarray(d),
                                        jnp.float32(0.5), th_)
      return (jnp.sum(jnp.sin(pos)) + jnp.sum(dirs) + jnp.sum(dist)
              + jnp.sum(nv) + jnp.sum(g))

    go, gth = jax.grad(loss, argnums=(0, 1))(jnp.asarray(o), params)
    # The JAX tree's leaves in the port's order: each Dense kernel, bias.
    out[dt] = np.asarray(go), np.concatenate(
        [np.asarray(gth[n][k], np.float64).ravel() for n in LAYERS
         for k in ("kernel", "bias")])
  return out


def _bf16_form(port, ref):
  (po, pth), (ro, rth) = port, ref
  rel = np.linalg.norm(pth - rth) / max(np.linalg.norm(rth), 1e-9)
  a, b = po.ravel().astype(np.float64), ro.ravel().astype(np.float64)
  cos = a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30)
  return rel, cos


@pytest.mark.parametrize("against", ["bfloat16", "float32"])
def test_bf16_gradients_against_jax_passes(jax_grads, against):
  rel, cos = _bf16_form(_port_grads("bfloat16"), jax_grads[against])
  assert rel <= GRAD_REL_L2 and cos >= ORIGINS_COSINE, (rel, cos)


def test_fp32_gradients_against_jax_fp32_passes(jax_grads):
  """The same form holds the port's fp32 arm far inside it."""
  rel, cos = _bf16_form(_port_grads("float32"), jax_grads["float32"])
  assert rel <= 1e-4 and cos >= 1 - 1e-6, (rel, cos)


# ------------------------------------------------------------------ (c)

@pytest.mark.parametrize("interp", ["default", "high"])
@pytest.mark.parametrize("head", [False, True])
def test_interp_arm_against_jax_fp32_march(interp, head):
  jspec, spec, data = _grid()
  o, d = _rays(16)
  params, flat = _so3(128, 10)
  steps = 48
  h = 4.0 / (steps - 1)
  if head:
    pred = lambda p, g: j_vjp.make_so3_apply(0, 10, True, True, True, False)(
        params, jnp.float32(0.6), p, g)
    want = j_eik.march(jspec, jnp.asarray(data), jnp.asarray(o),
                       jnp.asarray(d), NEAR, h, steps, pred_grad_fn=pred,
                       use_pred_grad=True)
    traj = t_mk.march_full(spec, torch.from_numpy(data), torch.from_numpy(o),
                           torch.from_numpy(d), NEAR, h, steps, flat, 0.6,
                           10, interp, "bfloat16")
  else:
    want = j_eik.march(jspec, jnp.asarray(data), jnp.asarray(o),
                       jnp.asarray(d), NEAR, h, steps)
    traj = t_mk.march_full_plain(spec, torch.from_numpy(data),
                                 torch.from_numpy(o), torch.from_numpy(d),
                                 NEAR, h, steps, interp)
  pos, dirs_raw, dist, nv, g = t_mk.split_trajectory(traj)
  got = (pos, t_math.safe_l2_normalize(dirs_raw), dist, nv, g)
  for name, a, b in zip(("pos", "dirs", "dist", "n", "g"), got, want):
    b = np.asarray(b)
    scale = max(float(np.abs(b).max()), 1e-3)
    dev = float(np.abs(a.numpy() - b).max())
    assert dev <= ENVELOPE * scale, (name, dev, scale)


def test_k1_default_arm_against_jax_fp32_march():
  jspec, spec, data = _grid()
  o, d = _rays(16)
  steps = 64
  h = 4.0 / (steps - 1)
  jitter = torch.arange(0, steps, steps // 8)
  got = t_mk.march_lean(spec, torch.from_numpy(data), torch.from_numpy(o),
                        torch.from_numpy(d), NEAR, h, steps, jitter,
                        "default")
  want = j_eik.march(jspec, jnp.asarray(data), jnp.asarray(o),
                     jnp.asarray(d), NEAR, h, steps)
  for a, b in zip(got[:3], want[:3]):
    b = np.asarray(b)
    assert float(np.abs(a.numpy() - b).max()) <= ENVELOPE * max(
        float(np.abs(b).max()), 1e-3)
  for a, b in zip(got[3:], got[:3]):
    assert torch.equal(a, b[:, jitter])


# ------------------------------------------------------------------ (d)

@pytest.mark.parametrize("stage", ["radiance", "radiance_v", "all",
                                   "all_quality", "ior", None])
def test_effective_march_interp_matches_jax(stage):
  for interp in precision.INTERPS:
    for interp_all in ("inherit",) + precision.INTERPS:
      args = types.SimpleNamespace(stage=stage, march_interp=interp,
                                   march_interp_all=interp_all)
      assert (t_nerf.effective_march_interp(args)
              == j_nerf.effective_march_interp(args))


# ------------------------------------------------------------------ (e)

def _lerps(spec, data, pts):
  """ops/grid.trilinear as the port computed it before the arms."""
  nmin, ndelta = spec.axis_tensors(pts.device)
  c = (pts - nmin) / ndelta
  c0f = torch.floor(c)
  frac = c - c0f
  xd, yd, zd = frac[..., 0:1], frac[..., 1:2], frac[..., 2:3]
  hi = torch.tensor([n - 1 for n in spec.ndim])
  i0 = torch.minimum(torch.clamp(c0f.to(torch.int64), min=0), hi)
  i1 = torch.minimum(torch.clamp(c0f.to(torch.int64) + 1, min=0), hi)
  ny, nz = spec.ndim[1], spec.ndim[2]
  g = lambda x, y, z: data[ny * nz * x + nz * y + z]
  (x0, y0, z0), (x1, y1, z1) = i0.unbind(-1), i1.unbind(-1)
  c00 = g(x0, y0, z0) * (1 - xd) + g(x1, y0, z0) * xd
  c01 = g(x0, y0, z1) * (1 - xd) + g(x1, y0, z1) * xd
  c10 = g(x0, y1, z0) * (1 - xd) + g(x1, y1, z0) * xd
  c11 = g(x0, y1, z1) * (1 - xd) + g(x1, y1, z1) * xd
  return (c00 * (1 - yd) + c10 * yd) * (1 - zd) + (
      c01 * (1 - yd) + c11 * yd) * zd


def test_default_flags_are_the_fp32_paths_bit_for_bit():
  _, spec, data = _grid(16)
  data = torch.from_numpy(data)
  pts = _points(500)
  assert torch.equal(t_grid.trilinear(spec, data, pts), _lerps(spec, data,
                                                                pts))
  _, flat = _so3(128, 10)
  x = torch.randn(64, 60, generator=torch.Generator().manual_seed(0))
  h = x
  for i in range(4):
    h = torch.relu(F.linear(h, flat[2 * i], flat[2 * i + 1]))
    if i == 2:
      h = torch.cat([h, x], -1)
  assert torch.equal(t_mlp.apply_params(flat, x),
                     F.linear(h, flat[8], flat[9]))
  cfg, data64, o, d, flat, traj, dtraj = _k3_inputs(8, 16, "float32")
  assert cfg == t_vjp.MarchConfig(*cfg[:5])
  assert torch.equal(traj, t_mk.march_full(cfg.spec, data64, o, d, NEAR,
                                           cfg.step_size, 16, flat, 0.5,
                                           MAX_DEG))
  got = t_vjp.march_bwd(cfg, data64, o, d, flat, 0.5, traj, dtraj)
  want = t_vjp.march_bwd_reference(cfg, data64, o, d, flat, 0.5, dtraj)
  assert all(torch.equal(a, b) for a, b in zip(_flat(got), _flat(want)))


def test_a_config_without_the_flags_builds_the_fp32_arms():
  args, _, _ = t_config.load_args(None, stage="all")
  model = t_nerf.construct_nerf(args, [8] * 3, [-1.5] * 3, [1.5] * 3,
                                np.ones((512, 1), np.float32), device="cpu")
  ps = model.path_sampler
  assert (ps.interp, ps.bwd_dtype) == ("highest", "float32")
  assert ps.march_cfg == t_vjp.MarchConfig(*ps.march_cfg[:5])


@pytest.mark.parametrize("stage,interp", [("radiance", "default"),
                                          ("all", "highest")])
def test_shipped_flags_reach_the_path_sampler(stage, interp):
  base = "configs/tpu/ship_skydome-bkgd_no-partial-reflect_cycles"
  args, _, _ = t_config.load_args(base, stage=stage,
                                  march_interp_all=("highest" if stage ==
                                                    "all" else "inherit"))
  assert (args.march_interp, args.march_bwd_dtype) == ("default", "bfloat16")
  model = t_nerf.construct_nerf(args, [8] * 3, [-1.5] * 3, [1.5] * 3,
                                np.ones((512, 1), np.float32), device="cpu")
  ps = model.path_sampler
  assert (ps.interp, ps.bwd_dtype) == (interp, "bfloat16")
  assert (ps.march_cfg.interp, ps.march_cfg.bwd_dtype) == (interp,
                                                           "bfloat16")


def test_one_assignment_of_the_arm_reaches_every_march():
  args, _, _ = t_config.load_args(None, stage="all")
  model = t_nerf.construct_nerf(args, [8] * 3, [-1.5] * 3, [1.5] * 3,
                                np.ones((512, 1), np.float32), device="cpu")
  ps = model.path_sampler
  ps.interp, ps.bwd_dtype = "default", "bfloat16"
  assert (ps.march_cfg.interp, ps.march_cfg.bwd_dtype) == ("default",
                                                           "bfloat16")
  assert (ps.interp, ps.bwd_dtype) == ("default", "bfloat16")
  with pytest.raises(ValueError):
    ps.interp = "bf16"
  with pytest.raises(ValueError):
    ps.bwd_dtype = "float16"
  assert ps.march_cfg.interp == "default"


def test_the_precision_flags_are_no_longer_ignored():
  for flag in ("march_interp", "march_interp_all", "march_bwd_dtype",
               "matmul_precision"):
    assert flag not in t_config.IGNORED_FLAGS


@pytest.mark.parametrize("flag,value", [("march_interp", "bf16"),
                                        ("march_interp_all", "low"),
                                        ("march_bwd_dtype", "float16")])
def test_unknown_precision_raises(flag, value):
  args, _, _ = t_config.load_args(None, **{flag: value})
  with pytest.raises(ValueError, match=flag if flag == "march_bwd_dtype"
                     else "interpolation precision"):
    t_nerf.construct_nerf(args, [8] * 3, [-1.5] * 3, [1.5] * 3,
                          np.ones((512, 1), np.float32), device="cpu")


def test_unknown_precision_raises_in_the_wrappers():
  _, spec, data = _grid(8)
  data = torch.from_numpy(data)
  o, d = (torch.from_numpy(a) for a in _rays(2))
  with pytest.raises(ValueError, match="interpolation precision"):
    t_mk.march_full_plain(spec, data, o, d, NEAR, 0.1, 4, interp="bf16")
  with pytest.raises(ValueError, match="march_bwd_dtype"):
    t_mk.march_full(spec, data, o, d, NEAR, 0.1, 4, _so3()[1], 0.5,
                    MAX_DEG, bwd_dtype="half")
  with pytest.raises(ValueError, match="march_bwd_dtype"):
    probes.so3_preacts(torch.zeros(2, 3), _so3(128, 10)[1], 0.5,
                       dtype="half")


def test_selfcheck_runs_the_bf16_interpolation_arm():
  envelopes = {}
  deviations, not_run = t_selfcheck.check_march(
      device="cpu", grid_n=32, num_samples=64, block_size=128, nblocks=2,
      grad_samples=8, envelopes=envelopes)
  names = [k for k in deviations if k.startswith("fwd_pallas_bf16_")]
  assert names == [f"fwd_pallas_bf16_{n}" for n in ("pos", "dirs", "dist",
                                                    "n", "g")]
  # The arm rounds (its path is not the fp32 one) and stays in envelope.
  assert 0 < deviations["fwd_pallas_bf16_n"]
  assert all(deviations[k] <= envelopes[k] for k in names)
  assert [m.split(":")[0] for m in not_run] == ["fwd_tiled_bf16"]


# ------------------------------------------------------- matmul_precision

@pytest.mark.parametrize("flag,torch_name", [("highest", "highest"),
                                             ("high", "high"),
                                             ("default", "medium"),
                                             ("bfloat16_3x", "high")])
def test_matmul_precision_sets_torch(flag, torch_name):
  before = torch.get_float32_matmul_precision()
  try:
    t_config.apply_matmul_precision(flag)
    assert torch.get_float32_matmul_precision() == torch_name
  finally:
    torch.set_float32_matmul_precision(before)


def test_matmul_precision_highest_keeps_the_forward_bit_for_bit():
  x = torch.randn(256, 60, generator=torch.Generator().manual_seed(1))
  _, flat = _so3(128, 10)
  before = torch.get_float32_matmul_precision()
  want = t_mlp.apply_params(flat, x)
  try:
    t_config.apply_matmul_precision("highest")
    assert torch.equal(t_mlp.apply_params(flat, x), want)
  finally:
    torch.set_float32_matmul_precision(before)
  with pytest.raises(ValueError, match="matmul_precision"):
    t_config.apply_matmul_precision("fastest")
