"""The so3 head's VoxMLP variants, against the JAX package.

The port runs the 'all' stage's march in K2/K3 for the shipped head
(annealed PE, Rodrigues residual) and, for any other head, as the JAX
package does (it has no kernel there: samplenerfro_tpu/ops/
eikonal_vjp.py:157-159), the plain march under autograd: a branch chosen
when the path sampler is built (PathSampler.march_all). Held here, on the
same numpy inputs and weights (models/convert.py): the 'all' stage's
two-level render and the gradient of every parameter, so3 head included,
for the spherical residual (use_direct_output False), the normalized
direct head (use_residual False, normalized True) and the non-annealed
head (legacy pos_enc, 63 inputs), and for the shipped head under IPE
with online sparsity's term in the loss (the IPE mean is a cumulative
sum over the sample directions, so its cotangents reach K3's plain
version through the directions and positions), against the JAX model's
scan march and autodiff; each head's refined gradient and smoothness
(the `ior` stage's term) with the JAX key's own draws handed over; which
march each head takes; and the raises of the heads JAX has no branch
for.

Tolerances: renders at atol = rtol = 1e-4 (tests/test_torch_model.py's
bound); gradients per tensor at K3's form |got - want| <= 2e-4 max|want| +
2e-3 |want| (tests/test_eikonal_vjp.py:108-111: autograd and JAX sum the
reverse sweep in other orders); the refined gradients at 1e-6 of their
largest value and the smoothness at 1e-6 of the size of its terms
(tests/test_torch_ior.py's bounds). The non-annealed head's own
gradients are the exception in float32: its legacy PE runs unannealed to
2^9 rad per unit, so the paths' fp32 ulps move them by a few per cent of
their scale. There each fp32 leaf is held within LEGACY_FP32 = 5% of
max|JAX| (measured worst 2.1%, Dense_2.weight), and every leaf of a
float64 twin of the port is held at K3's form against JAX autodiff run
with 64-bit types on (jax.enable_x64; measured worst 0.0094 of the
tolerance). Measured worst otherwise: renders within 0.004 of their
tolerance; every other gradient within 0.005 of K3's form (the shipped
head under IPE too).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from samplenerfro_torch.data.rays import Rays as TRays
from samplenerfro_torch.models import convert
from samplenerfro_torch.models import nerf as t_nerf
from samplenerfro_torch.models import path_sampler as t_ps
from samplenerfro_torch.ops import eikonal_vjp as t_vjp
from samplenerfro_torch.ops import march_kernel as t_mk
from samplenerfro_torch.utils import grid_io
from samplenerfro_tpu.data.rays import Rays as JRays
from samplenerfro_tpu.models import construct_nerf
from tests import helpers
from tests.test_torch_model import _jax_jitter
from tests.test_torch_model import _rays

ATOL = RTOL = 1e-4
K3_ATOL_SCALE, K3_RTOL = 2e-4, 2e-3
LEGACY_FP32 = 0.05

HEADS = {
    "spherical": {"VoxMLP.use_direct_output": False},
    "normalized_direct": {"VoxMLP.use_residual": False,
                          "VoxMLP.normalized": True},
    "non_annealed": {"VoxMLP.annealed": False},
}


def _args(stage="all", **kw):
  base = dict(randomized=False, march_mode="scan", march_emit="lean",
              tile_size=16, march_window=16, march_refetch=8, net_depth=4,
              net_width=32, num_coarse_samples=8, num_path_samples=4,
              num_fine_samples=16, stage=stage, max_deg_point=4)
  base.update(kw)
  return helpers.tiny_args(**base)


def _pair(gin, stage="all", grid_n=64, nrays=64, **kw):
  """The JAX model and its variables (the so3 output layer scaled so that
  a residual head bends the paths), and the port with the same weights;
  the first `nrays` of tests/test_torch_model.py's rays."""
  args = _args(stage, **kw)
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(grid_n, 1.5, 0.33)
  o, d, radii = (x[:nrays] for x in _rays())
  jrays = JRays(*map(jnp.asarray, (o, d, d, radii)))
  model, variables = construct_nerf(random.PRNGKey(0), {"rays": jrays}, args,
                                    ndim, nmin, nmax, values, gin)
  params = jax.tree_util.tree_map(np.asarray, variables["params"])
  out = params["path_sampler"]["so3_mlp"]["Dense_out"]
  if gin.get("VoxMLP.use_residual", True):
    out["kernel"] = out["kernel"] * np.float32(1e3)
  variables = {**variables, "params": params}
  port = t_nerf.construct_nerf(args, ndim, nmin, nmax, values, gin,
                               device="cpu")
  convert.load_into(port, convert.params_from_flax(params))
  return args, model, variables, port, (o, d, radii)


# (gin, flags): each head of HEADS, and the shipped head (K2/K3's plain
# versions here) under IPE, whose cumulative mean reaches the directions
# and positions, with online sparsity's term in the loss.
AUTODIFF = {**{head: (gin, {}) for head, gin in HEADS.items()},
            "shipped_ipe": ({"NerfModel.use_ipe": True},
                            {"use_online_sparsity": True})}
SP_WEIGHT = 0.1


@pytest.mark.parametrize("head", sorted(AUTODIFF))
def test_all_stage_head_matches_jax_autodiff(head):
  gin, flags = AUTODIFF[head]
  args, model, variables, port, (o, d, radii) = _pair(gin, **flags)
  want_march = "kernels" if head == "shipped_ipe" else "plain"
  assert port.path_sampler.march_all == want_march
  rng_0, rng_1 = random.PRNGKey(1), random.PRNGKey(2)
  jrays = JRays(*map(jnp.asarray, (o, d, d, radii)))
  w = [np.random.RandomState(i).randn(len(o), 3).astype(np.float32)
       for i in range(2)]

  def jax_loss(params):
    ret, sp = model.apply({**variables, "params": params}, rng_0, rng_1,
                          jrays, False, 0.5)
    return (sum(jnp.sum(level[0] * wi) for level, wi in zip(ret, w))
            + SP_WEIGHT * sp, (ret, sp))

  (_, (ret, want_sp)), jgrads = jax.jit(
      jax.value_and_grad(jax_loss, has_aux=True))(variables["params"])
  jitter = torch.from_numpy(np.array(_jax_jitter(rng_0, args)))
  trays = TRays(*map(torch.from_numpy, (o, d, d, radii)))
  got, sp = port(trays, jitter, randomized=False, annealed_alpha=0.5)
  (sum(torch.sum(level[0] * torch.from_numpy(wi))
       for level, wi in zip(got, w)) + SP_WEIGHT * sp).backward()
  if flags.get("use_online_sparsity"):
    assert float(want_sp) < 0
  np.testing.assert_allclose(float(torch.as_tensor(sp).detach()),
                             float(want_sp), rtol=1e-5)

  names = ("comp_rgb", "distance", "acc", "trans", "trans_rgb_bkgd")
  for level, (g_level, w_level) in enumerate(zip(got, ret)):
    for name, g, wv in zip(names, g_level, w_level):
      np.testing.assert_allclose(g.detach().numpy(), np.asarray(wv),
                                 atol=ATOL, rtol=RTOL,
                                 err_msg=f"{head} level {level} {name}")
  want = convert.params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                         jgrads))
  legacy = head == "non_annealed"
  so3 = 0.0
  for key, wv in want.items():
    g = port.get_parameter(key).grad.numpy()
    wv = wv.numpy()
    if legacy and key.startswith("path_sampler."):
      # Without annealing the legacy PE runs to 2^9 rad per unit, and the
      # head's fp32 gradients move with the paths' fp32 ulps times 2^9:
      # held here at a fraction of their scale, and in float64 below.
      worst = np.abs(g - wv).max() / np.abs(wv).max()
      assert worst <= LEGACY_FP32, f"{head} grad {key}: {worst}"
    else:
      tol = K3_ATOL_SCALE * np.abs(wv).max() + K3_RTOL * np.abs(wv)
      assert np.all(np.abs(g - wv) <= tol), f"{head} grad {key}"
    if key.startswith("path_sampler."):
      so3 = max(so3, float(np.abs(wv).max()))
  assert so3 > 0, "the head must bend the paths"
  if legacy:
    want, jitter = _x64_grads(model, variables, args, (o, d, radii), w,
                              rng_0, rng_1)
    got = _float64_grads(port, trays, torch.from_numpy(jitter), w)
    for key, wv in want.items():
      tol = K3_ATOL_SCALE * np.abs(wv).max() + K3_RTOL * np.abs(wv)
      assert np.all(np.abs(got[key] - wv) <= tol), f"{head} f64 grad {key}"


def _x64_grads(model, variables, args, rays, w, rng_0, rng_1):
  """JAX autodiff of the test's loss with 64-bit types on: the gradients
  under the port's names (models/convert.py's layout, in float64), and
  the jitter the model drew."""
  o, d, radii = rays
  with jax.enable_x64(True):
    params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64),
                                    variables["params"])
    jrays = JRays(*(jnp.asarray(x, jnp.float64) for x in (o, d, d, radii)))

    def loss(p):
      ret, _ = model.apply({**variables, "params": p}, rng_0, rng_1, jrays,
                           False, jnp.float64(0.5))
      return sum(jnp.sum(level[0] * wi) for level, wi in zip(ret, w))

    tree = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss))(params))
    jitter = np.array(_jax_jitter(rng_0, args))
  out = {}
  for mod, layers in tree.items():
    if mod == "path_sampler":
      mod, layers = "path_sampler.so3_mlp", layers["so3_mlp"]
    for name, p in layers.items():
      layer = name if mod.startswith("path") else int(name[len("Dense_"):])
      out[f"{mod}.layers.{layer}.weight"] = p["kernel"].T
      out[f"{mod}.layers.{layer}.bias"] = p["bias"]
  return out, jitter


def _float64_grads(port, trays, jitter, w):
  """The gradients of the test's loss in a float64 twin of the port."""
  twin = copy.deepcopy(port).to(torch.float64)
  rays = TRays(*[r.to(torch.float64) for r in trays])
  got, _ = twin(rays, jitter, randomized=False,
                annealed_alpha=torch.tensor(0.5, dtype=torch.float64),
                mlp_dtype=torch.float64)
  sum(torch.sum(level[0] * torch.from_numpy(wi).double())
      for level, wi in zip(got, w)).backward()
  return {k: p.grad.numpy() for k, p in twin.named_parameters()}


@pytest.mark.parametrize("head", sorted(HEADS) + ["shipped"])
def test_refined_gradient_and_smoothness_match_jax(head):
  """The `ior` stage's term: each head's refined gradient at points and
  the smoothness over offsets drawn by the JAX key."""
  gin = HEADS.get(head, {})
  _, model, variables, port, _ = _pair(gin, stage="ior", grid_n=16)
  rng = np.random.RandomState(4)
  pts = rng.uniform(-0.5, 0.5, (64, 1, 3)).astype(np.float32)
  grads = (0.05 * rng.randn(64, 1, 3)).astype(np.float32)
  key = random.PRNGKey(9)
  noise = np.array(jax.random.normal(key, pts.shape))
  ps = model.bind(variables).path_sampler
  want = np.asarray(ps.wrapper_grad_mlp(jnp.asarray(pts), jnp.asarray(grads),
                                        0.5))
  _, want_smooth = model.apply(variables, jnp.asarray(pts),
                               jnp.asarray(grads), 0.5, key,
                               method=model.wrapper_compute_normal_loss_and_smooth)
  with torch.no_grad():
    got = port.path_sampler.wrapper_grad_mlp(torch.from_numpy(pts),
                                             torch.from_numpy(grads), 0.5)
    _, smooth = port.wrapper_compute_normal_loss_and_smooth(
        torch.from_numpy(pts), torch.from_numpy(grads), 0.5,
        torch.from_numpy(noise))
  np.testing.assert_allclose(got.numpy(), want,
                             atol=1e-6 * np.abs(want).max(), rtol=0)
  terms = float(np.abs(want).max())
  np.testing.assert_allclose(float(smooth), float(want_smooth),
                             atol=1e-6 * terms, rtol=0)


@pytest.mark.parametrize("head", sorted(HEADS) + ["shipped"])
def test_march_follows_the_head(head, monkeypatch):
  """The shipped head marches through march_allstage (K2/K3 on the card)
  and never takes the plain branch; every other head takes the plain
  march and never calls march_allstage. On the CPU march_allstage runs
  the kernels' plain versions, so its calls are counted here; the card
  test counts K2/K3 launches (tests/test_torch_cuda.py)."""
  gin = HEADS.get(head, {})
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(16, 1.5, 0.33)
  port = t_nerf.construct_nerf(_args(num_fine_samples=0), ndim, nmin, nmax,
                               values, gin, device="cpu")
  shipped = head == "shipped"
  assert port.path_sampler.march_all == ("kernels" if shipped else "plain")
  assert (port.path_sampler.head == t_mk.SHIPPED_HEAD) == shipped
  calls = {"kernels": 0, "plain": 0}
  allstage, plain = t_vjp.march_allstage, t_ps.eik_ops.march

  def counted(name, fn):
    def run(*a, **kw):
      calls[name] += 1
      return fn(*a, **kw)
    return run

  monkeypatch.setattr(t_vjp, "march_allstage", counted("kernels", allstage))
  monkeypatch.setattr(t_ps.eik_ops, "march", counted("plain", plain))
  o, d, radii = (x[:8] for x in _rays())
  rays = TRays(*map(torch.from_numpy, (o, d, d, radii)))
  jitter = t_nerf.make_jitter(8, 4, torch.Generator().manual_seed(0))
  port(rays, jitter, annealed_alpha=0.5)
  # march_allstage's plain versions march through ops/eikonal too.
  want = ({"kernels": 1, "plain": 1} if shipped
          else {"kernels": 0, "plain": 1})
  assert calls == want


RAISES = {
    # (stage, gin): JAX raises at init, where the port raises while it
    # constructs; None: both construct, and the head raises when applied.
    "interp_method": ("radiance", {"VoxMLP.interp_method": "nearest"}),
    "residual_normalized_all": ("all", {"VoxMLP.normalized": True}),
    "no_branch_all": ("all", {"VoxMLP.use_residual": False}),
    "residual_normalized_ior": ("ior", {"VoxMLP.normalized": True}),
}


@pytest.mark.parametrize("case", sorted(RAISES))
def test_heads_raise_where_jax_raises(case):
  stage, gin = RAISES[case]
  args = _args(stage)
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(8, 1.5, 0.33)
  o, d, radii = (x[:4] for x in _rays())
  jrays = JRays(*map(jnp.asarray, (o, d, d, radii)))
  build_jax = lambda: construct_nerf(random.PRNGKey(0), {"rays": jrays},
                                     args, ndim, nmin, nmax, values, gin)
  build_port = lambda: t_nerf.construct_nerf(args, ndim, nmin, nmax, values,
                                             gin, device="cpu")
  if stage != "ior":
    with pytest.raises(NotImplementedError):
      build_jax()
    with pytest.raises(NotImplementedError):
      build_port()
    return
  model, variables = build_jax()
  port = build_port()
  pts = np.zeros((4, 1, 3), np.float32)
  grads = np.full((4, 1, 3), 0.1, np.float32)
  with pytest.raises(NotImplementedError):
    model.apply(variables, jnp.asarray(pts), jnp.asarray(grads), 0.5,
                random.PRNGKey(0),
                method=model.wrapper_compute_normal_loss_and_smooth)
  with pytest.raises(NotImplementedError):
    port.wrapper_compute_normal_loss_and_smooth(
        torch.from_numpy(pts), torch.from_numpy(grads), 0.5,
        torch.zeros((4, 1, 3)))


def test_head_widths():
  """The so3 MLP's input width follows its PE: 60 annealed, 63 for the
  legacy pos_enc; a residual head's output layer starts at std 1e-5, the
  normalized direct head's Glorot-uniform."""
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(8, 1.5, 0.33)
  for gin, width in (({}, 60), ({"VoxMLP.annealed": False}, 63)):
    port = t_nerf.construct_nerf(_args("radiance"), ndim, nmin, nmax, values,
                                 gin, device="cpu")
    layers = port.path_sampler.so3_mlp.layers
    assert layers["Dense_0"].weight.shape == (128, width)
    assert layers["Dense_3"].weight.shape == (128, 128 + width)
    assert float(layers["Dense_out"].weight.detach().abs().max()) < 1e-4
  port = t_nerf.construct_nerf(_args("radiance"), ndim, nmin, nmax, values,
                               HEADS["normalized_direct"], device="cpu")
  assert float(port.path_sampler.so3_mlp.layers["Dense_out"].weight.detach()
               .abs().max()) > 1e-2
