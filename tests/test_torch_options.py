"""The model options no shipped config turns on, against the JAX package.

The same seeded numpy inputs and weights (models/convert.py) go through
samplenerfro_tpu and the port on the CPU: ops/mip.py and ops/sh.py
function by function; the two-level render with each of IPE
(`NerfModel.use_ipe`), SH colour (`sh_deg 2`), SH direction encoding
(`sh_direnc_deg 4`) and the proxy-bbox mask (`NerfModel.use_mask_bbox`),
as tests/test_torch_model.py renders the shipped model (the JAX model's
scan march, 256 rays, its jitter); loss_fn's Stats and the ungated online
sparsity term in radiance (with and without use_fine_sparsity) and in
'all'; utils/rl_utils.py on one seed; the weights' new shapes through
models/convert.py; validate_quality's `--ipe` gin line; the raises both
packages share; and the CLI's default flags (use_online_sparsity on).

Tolerances: the functions at 1e-6 (the same fp32 formulas; sines of
arguments past 100 pi are range-reduced alike and differ by an ulp,
measured <= 6e-8 absolute); renders at atol = rtol = 1e-4, the bound
tests/test_torch_model.py justifies (measured worst: 0.74 of it with the
bbox mask, 0.64 with SH colour or SH direction encoding, 0.005 with
IPE); Stats and the online term at rtol 1e-5 (measured <= 3.5e-7
relative); rl_utils bit for bit (the same numpy draws) but the
trigonometry at 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from samplenerfro_torch.data import prefetch
from samplenerfro_torch.data.rays import Rays as TRays
from samplenerfro_torch.models import convert
from samplenerfro_torch.models import nerf as t_nerf
from samplenerfro_torch.ops import mip as t_mip
from samplenerfro_torch.ops import sh as t_sh
from samplenerfro_torch.tools import validate_quality as t_vq
from samplenerfro_torch.train import loop as t_loop
from samplenerfro_torch.train import step as t_step
from samplenerfro_torch.utils import config as t_config
from samplenerfro_torch.utils import grid_io
from samplenerfro_torch.utils import rl_utils as t_rl
from samplenerfro_tpu.data.rays import Rays as JRays
from samplenerfro_tpu.models import construct_nerf
from samplenerfro_tpu.ops import mip as j_mip
from samplenerfro_tpu.ops import sh as j_sh
from samplenerfro_tpu.train import step as j_step
from samplenerfro_tpu.utils import rl_utils as j_rl
from tests import helpers
from tests.test_torch_model import _jax_jitter
from tests.test_torch_model import _rays
from tests.test_torch_train import _batch
from tests.test_torch_train import _jax_batch
from tests.test_torch_train import _jitter
from tests.test_torch_train import STATS

FN_ATOL = 1e-6
ATOL = RTOL = 1e-4


def _close(got, want, atol=FN_ATOL, rtol=0.0, what=""):
  np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                             rtol=rtol, err_msg=what)


def _sections(seed=0, b=5, s=7):
  """Directions, section bounds and cone radii of b curved rays."""
  rng = np.random.RandomState(seed)
  d = rng.randn(b, s, 3).astype(np.float32)
  t = 2.0 + np.cumsum(rng.uniform(0.05, 0.3, (b, s + 1)), -1)
  radii = rng.uniform(1e-3, 5e-3, (b, 1)).astype(np.float32)
  pos = rng.randn(b, s, 3).astype(np.float32)
  return d, t.astype(np.float32), radii, pos


def _mip_case(name):
  d, t, radii, pos = _sections()
  t0, t1 = t[:, :-1], t[:, 1:]
  if name == "expected_sin":
    x = np.random.RandomState(1).uniform(-1500, 1500, (64, 6))
    v = np.random.RandomState(2).uniform(0, 4, (64, 6))
    return "expected_sin", (x.astype(np.float32), v.astype(np.float32))
  if name.startswith("lift_gaussian"):
    diag = name.endswith("diag")
    t_var = np.abs(np.random.RandomState(3).randn(*t0.shape))
    r_var = np.abs(np.random.RandomState(4).randn(*t0.shape))
    # The full form takes one direction shared by every section.
    return "lift_gaussian", (d if diag else d[0, 0], t0,
                             t_var.astype(np.float32),
                             r_var.astype(np.float32), diag, 2.0)
  if name.startswith("conical"):
    return "conical_frustum_to_gaussian", (d, t0, t1, radii, True, 2.0,
                                           name.endswith("stable"))
  if name == "cylinder":
    return "cylinder_to_gaussian", (d, t0, t1, radii, True, 2.0)
  if name.startswith("cast_rays"):
    shape = name.split("_")[-1]
    return "cast_rays", (t, pos, d, radii, shape, 2.0, True)
  diag = name.endswith("diag")
  means, covs = j_mip.cast_rays(jnp.asarray(t), jnp.asarray(pos),
                                jnp.asarray(d if diag else d[0, 0]),
                                jnp.asarray(radii), "cone", 2.0, diag)
  return "integrated_pos_enc", ((np.asarray(means), np.asarray(covs)), 0,
                                10, diag)


def _to(pkg, x):
  if isinstance(x, np.ndarray):
    return jnp.asarray(x) if pkg == "jax" else torch.from_numpy(x)
  if isinstance(x, tuple):
    return tuple(_to(pkg, v) for v in x)
  return x


def _flat(out):
  if isinstance(out, (tuple, list)):
    return [v for o in out for v in _flat(o)]
  return [np.asarray(out)]


@pytest.mark.parametrize("case", [
    "expected_sin", "lift_gaussian_diag", "lift_gaussian_full",
    "conical_stable", "conical_unstable", "cylinder", "cast_rays_cone",
    "cast_rays_cylinder", "ipe_diag", "ipe_full", "full_on_a_path"])
def test_mip_matches_jax(case):
  if case == "full_on_a_path":
    # The full covariance of a [B, S, 3] path fails to broadcast in both.
    d, t, radii, _ = _sections()
    args = (d, t[:, :-1], t[:, 1:], radii, False, 2.0)
    with pytest.raises(ValueError):
      j_mip.conical_frustum_to_gaussian(*_to("jax", args))
    with pytest.raises(RuntimeError):
      t_mip.conical_frustum_to_gaussian(*_to("torch", args))
    return
  name, args = _mip_case(case)
  want = _flat(getattr(j_mip, name)(*_to("jax", args)))
  got = _flat(getattr(t_mip, name)(*_to("torch", args)))
  assert len(got) == len(want)
  for g, w in zip(got, want):
    assert g.shape == w.shape
    # Relative to the size of the values: cast_rays' means sum sections.
    _close(g, w, atol=FN_ATOL * max(1.0, float(np.abs(w).max())),
           what=case)


def _unit_dirs(n=300, seed=0):
  d = np.random.RandomState(seed).randn(n, 3).astype(np.float32)
  return d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("case", ["basis", "eval_sh", "dir_enc", "easing",
                                  "annealed"])
def test_sh_matches_jax(case):
  d = _unit_dirs()
  jd, td = jnp.asarray(d), torch.from_numpy(d)
  pairs = []
  if case == "basis":
    pairs = [(j_sh.sh_basis(n, jd), t_sh.sh_basis(n, td))
             for n in range(1, 9)]
  elif case == "eval_sh":
    for deg in range(5):
      sh = np.random.RandomState(deg).randn(300, 3, (deg + 1)**2)
      sh = sh.astype(np.float32)
      pairs.append((j_sh.eval_sh(deg, jnp.asarray(sh), jd),
                    t_sh.eval_sh(deg, torch.from_numpy(sh), td)))
  elif case == "dir_enc":
    pairs = [(j_sh.dir_enc(jd, n), t_sh.dir_enc(td, n)) for n in range(1, 9)]
  elif case == "easing":
    bands = np.arange(8, dtype=np.float32)
    pairs = [(j_sh.cosine_easing_factor(jnp.asarray(bands), a),
              t_sh.cosine_easing_factor(torch.from_numpy(bands), a))
             for a in (0.0, 0.3, 2.5, 7.9, 9.0)]
  else:
    pairs = [(j_sh.annealed_dir_enc(jd, n, a),
              t_sh.annealed_dir_enc(td, n, a))
             for n in (1, 4, 8) for a in (0.0, 1.7, 8.0)]
  for want, got in pairs:
    assert tuple(got.shape) == tuple(want.shape)
    _close(got.numpy(), want, what=case)
  # Outside their supported degrees both refuse.
  with pytest.raises(AssertionError):
    j_sh.eval_sh(5, jnp.zeros((1, 3, 36)), jd[:1])
  with pytest.raises(ValueError, match="degrees 0 to 4"):
    t_sh.eval_sh(5, torch.zeros((1, 3, 36)), td[:1])
  with pytest.raises(AssertionError):
    j_sh.dir_enc(jd, 9)
  with pytest.raises(ValueError, match="1 to 8 bands"):
    t_sh.dir_enc(td, 9)


def _render_args(**kw):
  base = dict(randomized=False, march_mode="scan", march_emit="lean",
              tile_size=16, march_window=16, march_refetch=8, net_depth=6,
              net_width=32, num_coarse_samples=8, num_path_samples=4,
              num_fine_samples=16, stage="radiance")
  base.update(kw)
  return helpers.tiny_args(**base)


def _pair(args, gin, grid_n=64):
  """The JAX model and its variables, and the port with its weights."""
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(grid_n, 1.5, 0.33)
  o, d, radii = _rays()
  jrays = JRays(*map(jnp.asarray, (o, d, d, radii)))
  model, variables = construct_nerf(random.PRNGKey(0), {"rays": jrays}, args,
                                    ndim, nmin, nmax, values, gin)
  port = t_nerf.construct_nerf(args, ndim, nmin, nmax, values, gin,
                               device="cpu")
  params = jax.tree_util.tree_map(np.asarray, variables["params"])
  convert.load_into(port, convert.params_from_flax(params))
  return model, variables, port, (o, d, radii)


RENDER_OPTIONS = {
    "ipe": ({}, {"NerfModel.use_ipe": True}),
    "sh_deg": ({"sh_deg": 2, "use_viewdirs": False}, {}),
    "sh_direnc_deg": ({"sh_direnc_deg": 4}, {}),
    "mask_bbox": ({}, {"NerfModel.use_mask_bbox": True}),
}


@pytest.mark.parametrize("option", sorted(RENDER_OPTIONS))
def test_render_with_option_matches_jax(option):
  over, gin = RENDER_OPTIONS[option]
  args = _render_args(**over)
  model, variables, port, (o, d, radii) = _pair(args, gin)
  rng_0, rng_1 = random.PRNGKey(1), random.PRNGKey(2)
  jrays = JRays(*map(jnp.asarray, (o, d, d, radii)))
  ret, want_sp = jax.jit(lambda v: model.apply(v, rng_0, rng_1, jrays,
                                                False))(variables)
  jitter = torch.from_numpy(np.array(_jax_jitter(rng_0, args)))
  trays = TRays(*map(torch.from_numpy, (o, d, d, radii)))
  with torch.no_grad():
    got, loss_sp = port(trays, jitter, randomized=False)
  assert loss_sp == want_sp == 0.0
  if option == "mask_bbox":
    # Some coarse samples lie outside the grid's box, so the mask counts.
    sub = port.path_sampler(trays.origins, trays.viewdirs, jitter)[5][0]
    assert 0 < float(port._mask_bbox(sub).mean()) < 1
  names = ("comp_rgb", "distance", "acc", "trans", "trans_rgb_bkgd")
  for level, (g_level, w_level) in enumerate(zip(got, ret)):
    for name, g, w in zip(names, g_level, w_level):
      np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                 rtol=RTOL, err_msg=f"level {level} {name}")


SPARSITY = {
    "radiance": ("radiance", False),
    "radiance-fine": ("radiance", True),
    "all": ("all", False),
}


@pytest.mark.parametrize("case", sorted(SPARSITY))
def test_online_sparsity_stats_match_jax(case):
  """loss_fn's total and Stats with online sparsity (sparsity_weight 0.1,
  gated by the JAX step's annealing rate 0.0) and the model's ungated
  term, each against the JAX package's."""
  stage, fine = SPARSITY[case]
  args = _render_args(stage=stage, use_online_sparsity=True,
                      use_fine_sparsity=fine, sparsity_weight=0.1,
                      max_deg_point=4, bg_patch_size=4, grad_max_norm=0.0)
  model, variables, port, _ = _pair(args, {})
  b = _batch()
  rng = random.PRNGKey(3)
  _, key_0, key_1, key_nrm = random.split(rng, 4)
  loss = jax.jit(j_step.make_loss_fn(model, args))
  total, j_stats = loss(variables["params"], {"grid": variables["grid"]},
                        key_0, key_1, key_nrm, _jax_batch(b))
  host = {"pixels": b["pixels"], "rays": TRays(*b["rays"]),
          "env_rays": TRays(*b["env"])}
  batch = prefetch.to_device(t_loop.step_batch(
      host, b["annealed_alpha"], None, _jitter(rng, args), args), "cpu")
  with torch.no_grad():
    got_total, stats = t_step.loss_fn(port, batch, args)
    _, online = port(batch["rays"], batch["jitter"], randomized=False,
                     annealed_alpha=batch["annealed_alpha"])
  np.testing.assert_allclose(float(got_total), float(total), rtol=1e-5)
  stats = stats.as_floats()
  for name in STATS:
    np.testing.assert_allclose(getattr(stats, name),
                               float(getattr(j_stats, name)), rtol=1e-5,
                               atol=1e-7, err_msg=name)
  assert stats.loss_sp == 0.0  # gated, as shipped
  _, want = jax.jit(lambda v: model.apply(
      v, key_0, key_1, _jax_batch(b)["rays"], False,
      b["annealed_alpha"]))(variables)
  assert float(want) < 0
  np.testing.assert_allclose(float(online), float(want), rtol=1e-5)


@pytest.mark.parametrize("stage", ["radiance", "all"])
def test_gated_online_sparsity_moves_no_bit(stage):
  """Train steps with online sparsity (sparsity_weight 0.1, gated at 0 by
  the annealing rate; the radiance march then runs K2 with the head off)
  leave every parameter, gradient and Stats field bit for bit where the
  same steps without it (sparsity_weight 0) leave them."""
  out = []
  for online in (False, True):
    args = _render_args(stage=stage, use_online_sparsity=online,
                        use_fine_sparsity=online,
                        sparsity_weight=0.1 if online else 0.0,
                        max_deg_point=4, bg_patch_size=4, net_depth=2)
    values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(16, 1.5, 0.33)
    port = t_nerf.construct_nerf(args, ndim, nmin, nmax, values,
                                 device="cpu", seed=5)
    assert port.path_sampler.emit_grad == online
    optimizer, _, _ = t_step.create_optimizer(port, args)
    b = _batch()
    host = {"pixels": b["pixels"][:64],
            "rays": TRays(*(r[:64] for r in b["rays"])),
            "env_rays": TRays(*b["env"])}
    jitter = t_nerf.make_jitter(8, 4, torch.Generator().manual_seed(0))
    stats = []
    for k in range(2):
      batch = prefetch.to_device(t_loop.step_batch(
          host, 0.5, t_step.learning_rates(optimizer, k + 5), jitter, args),
          "cpu")
      stats.append(t_step.train_step(port, optimizer, batch, args)
                   .as_floats())
    out.append((stats, {k: v.detach().clone()
                        for k, v in port.named_parameters()},
                {k: v.grad.clone() for k, v in port.named_parameters()
                 if v.grad is not None}))
  (s0, p0, g0), (s1, p1, g1) = out
  assert s0 == s1
  assert p0.keys() == p1.keys() and g0.keys() == g1.keys()
  assert all(torch.equal(p0[k], p1[k]) for k in p0)
  assert all(torch.equal(g0[k], g1[k]) for k in g0)


def test_replay_buffer_and_actions_match_jax():
  rng = np.random.RandomState(7)
  n = 37
  exp = (rng.randn(n, 3), rng.rand(n, 1), rng.rand(n, 1), rng.randn(n, 3),
         rng.randn(n))
  bufs = []
  for mod in (j_rl, t_rl):
    buf = mod.ReplayBuffer(64, 16, total_episode=10)
    buf.episode = 3
    buf.add(exp, 20)
    bufs.append(buf)
  for wrap in (False, True):
    if wrap:  # past the ring's end
      for buf in bufs:
        buf.add(exp, n)
        buf.add(exp, n)
    np.random.seed(11)
    want = bufs[0].sample()
    got = bufs[1].sample(np.random.RandomState(11))
    assert bufs[1].is_exceed_buffer_size == bufs[0].is_exceed_buffer_size
    for g, w in zip(got, want):
      assert g.dtype == torch.float32
      np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(bufs[1].peek(), bufs[0].peek()):
      np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    td = rng.randn(16, 1)
    for buf in bufs:
      buf.update(td)
    np.testing.assert_array_equal(bufs[1].priority_buffer,
                                  bufs[0].priority_buffer)

  r = rng.rand(50, 2).astype(np.float32)
  for exp_ in (0.0, 1.0):
    _close(t_rl.square_to_hemisphere(torch.from_numpy(r[:, :1]),
                                     torch.from_numpy(r[:, 1:]), exp_),
           j_rl.square_to_hemisphere(jnp.asarray(r[:, :1]),
                                     jnp.asarray(r[:, 1:]), exp_))
  for size, shrink in ((4, 0.0), (6, 0.2)):
    want = j_rl.compute_action_space(size, shrink)
    got = t_rl.compute_action_space(size, shrink)
    assert tuple(got.shape) == want.shape == (size * size, 3)
    _close(got, want)
  actions = np.asarray(j_rl.compute_action_space(3))
  to = rng.randn(4, 5, 3).astype(np.float32)
  for dataset in ("blender", "opencv"):
    want = j_rl.local_axis(jnp.asarray(actions), jnp.asarray(to), dataset)
    got = t_rl.local_axis(torch.from_numpy(actions), torch.from_numpy(to),
                          dataset)
    assert tuple(got.shape) == want.shape == (4, 5, 9, 3)
    _close(got, want)
  with pytest.raises(ValueError):
    j_rl.local_axis(jnp.asarray(actions), jnp.asarray(to), "llff")
  with pytest.raises(ValueError):
    t_rl.local_axis(torch.from_numpy(actions), torch.from_numpy(to), "llff")


def test_new_shapes_cross_the_converter():
  """The weights of SH colour (27 output channels at sh_deg 2), IPE (60
  inputs), SH direction encoding (16 condition inputs) and the
  non-annealed so3 head (63 inputs, Dense_3 191) carry from flax to the
  port and back."""
  args = _render_args(sh_deg=2, use_viewdirs=False, num_fine_samples=4,
                      sh_direnc_deg=4)
  gin = {"NerfModel.use_ipe": True, "VoxMLP.annealed": False}
  _, variables, port, _ = _pair(args, gin, grid_n=8)
  params = jax.tree_util.tree_map(np.asarray, variables["params"])
  back = convert.params_to_flax(port)
  flat_j, flat_t = convert.flatten(params), convert.flatten(back)
  assert flat_j.keys() == flat_t.keys()
  for key, want in flat_j.items():
    np.testing.assert_array_equal(flat_t[key], want, err_msg=key)
  shapes = {k: v.shape for k, v in flat_t.items()}
  assert shapes["coarse_mlp/Dense_0/kernel"] == (60, 32)
  assert shapes["coarse_mlp/Dense_7/kernel"] == (32, 27)  # no condition
  assert shapes["bkgd_mlp/Dense_0/kernel"] == (16, 128)
  assert shapes["bkgd_mlp/Dense_4/kernel"] == (128, 27)
  assert shapes["path_sampler/so3_mlp/Dense_0/kernel"] == (63, 128)
  assert shapes["path_sampler/so3_mlp/Dense_3/kernel"] == (191, 128)


def test_validate_quality_ipe_and_seed(tmp_path):
  """--ipe writes the JAX script's gin line (scripts/validate_quality.py:
  162-163) and tags the run `_ipe`; --seed tags it `_s<seed>`, and seed
  0 keeps the tag of a run without it."""
  ns = t_vq.parse_args(["--ipe", "--seed=2", "--batching=tile"])
  assert t_vq.run_tag(ns) == "tile_ipe_s2"
  assert t_vq.run_tag(t_vq.parse_args([])) == "single_image"
  t_vq.write_config(ns, str(tmp_path / "c"))
  gin = (tmp_path / "c.gin").read_text()
  assert gin == t_vq.GIN + "NerfModel.use_ipe = True\n"
  bindings = t_config.parse_gin([str(tmp_path / "c.gin")], [])
  assert bindings["NerfModel.use_ipe"] is True
  t_vq.write_config(t_vq.parse_args([]), str(tmp_path / "d"))
  assert (tmp_path / "d.gin").read_text() == t_vq.GIN


def test_shared_raises():
  """Where the JAX model raises, the port raises: the envmap's pos_enc
  against the SH direction encoding's width, the classic point encoding
  of the boundary-point loss and the point probe against IPE's width
  (flax fails on the shape), SH colour with use_viewdirs, and the
  boundary cut with the proxy-bbox mask."""
  pts = np.zeros((4, 1, 3), np.float32)
  dirs = _unit_dirs(4)
  args = _render_args(sh_direnc_deg=4)
  model, variables, port, _ = _pair(args, {}, grid_n=8)
  with pytest.raises(Exception, match="shape"):
    model.apply(variables, jnp.asarray(dirs), method=model.forward_envmap)
  with pytest.raises(ValueError, match="sh_direnc_deg"):
    port.forward_envmap(torch.from_numpy(dirs))
  args = _render_args()
  model, variables, port, _ = _pair(args, {"NerfModel.use_ipe": True},
                                    grid_n=8)
  with pytest.raises(Exception, match="shape"):
    model.apply(variables, jnp.asarray(pts), 0.0, 0.0,
                method=model.compute_sparsity_loss)
  with pytest.raises(ValueError, match="use_ipe"):
    port.compute_sparsity_loss(torch.from_numpy(pts), 0.0, 0.0)
  with pytest.raises(Exception, match="shape"):
    model.apply(variables, jnp.asarray(pts[:, 0]), jnp.asarray(dirs),
                method=model.sample_points)
  with pytest.raises(ValueError, match="use_ipe"):
    port.sample_points(torch.from_numpy(pts[:, 0]), torch.from_numpy(dirs))
  # forward_envmap runs under IPE in both (its pos_enc is the MLP's).
  want = model.apply(variables, jnp.asarray(dirs),
                     method=model.forward_envmap)
  with torch.no_grad():
    _close(port.forward_envmap(torch.from_numpy(dirs)), want, atol=1e-5)

  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(8, 1.5, 0.33)
  o, d, radii = _rays()
  jrays = JRays(*map(jnp.asarray, (o[:4], d[:4], d[:4], radii[:4])))
  for over, gin in (({"sh_deg": 2}, {}),
                    ({"config": "configs/tpu/glass"},
                     {"NerfModel.use_mask_bbox": True,
                      "NerfModel.bd_cut_dist": 0.1})):
    args = _render_args(**over)
    with pytest.raises(AssertionError):
      construct_nerf(random.PRNGKey(0), {"rays": jrays}, args, ndim, nmin,
                     nmax, values, gin)
    with pytest.raises(ValueError):
      t_nerf.construct_nerf(args, ndim, nmin, nmax, values, gin,
                            device="cpu")


def test_fused_gates_read_the_real_widths():
  """The fused MLP's gates (models/nerf.py:277-306) on the MLPs' real
  input widths: IPE's 60 features feed K4 (not its in-kernel encoding),
  SH direction encoding's 16 condition values too, SH colour never."""
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(8, 1.5, 0.33)
  build = lambda gin=None, **kw: t_nerf.construct_nerf(
      _render_args(mlp_kernel="pallas_pe", net_width=128,
                   net_width_condition=128, **kw),
      ndim, nmin, nmax, values, gin, device="cpu")
  ipe = build({"NerfModel.use_ipe": True})
  assert ipe.mlp_dims[:2] == (60, 27)
  assert ipe._use_fused_mlp() and ipe._fused_pe() is None
  enc = build(sh_direnc_deg=4)
  assert enc.mlp_dims[:2] == (63, 16)
  assert enc._use_fused_mlp() and enc._fused_pe() is None
  assert not build(sh_deg=2, use_viewdirs=False)._use_fused_mlp()
  shipped = build()
  assert shipped._use_fused_mlp() and shipped._fused_pe() == (10, 4)


def test_cli_defaults_train_with_online_sparsity(tmp_path):
  """The flags' default use_online_sparsity (True, as in the JAX flags)
  trains: the entry point on the tiny scene with no YAML setting it."""
  from tests import fixtures
  data = fixtures.make_scene(str(tmp_path / "data"))
  cfg = fixtures.write_tiny_config(str(tmp_path / "cfg"))
  yaml_path = cfg + ".yaml"
  text = open(yaml_path).read().replace("use_online_sparsity: false\n", "")
  open(yaml_path, "w").write(text)
  args, _, _ = t_config.load_args(cfg, [cfg + ".gin"], [])
  assert args.use_online_sparsity is True
  model = t_loop.main([f"--data_dir={data}", f"--train_dir={tmp_path / 'l'}",
                       f"--config={cfg}", f"--gin_file={cfg}.gin",
                       "--stage=radiance", "--device=cpu", "--max_steps=2",
                       "--print_every=1"])
  assert model.use_online_sparsity and model.path_sampler.emit_grad
  assert (tmp_path / "l" / "radiance" / "checkpoint_2").exists()
