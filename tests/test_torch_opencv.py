"""The port's real-scene slice against the JAX package: OpenCV rays, the
OpenCV loader and its batches, the test views' central crop, SSIM, the
boundary cut, a train step on an OpenCV batch with the cut, eval's
per-stage checkpoint surgery, and `train` then `eval` on a tiny OpenCV
scene on the CPU.

Tolerances: rays, pixels, batch indices and crops exact (the same numpy
expressions on the same draws); SSIM 1e-5 abs (separable fp32 convolutions
summed in another order: ~2e-6 measured); the model at
tests/test_torch_model.py's atol = rtol = 1e-4 and the train step at
tests/test_torch_train.py's (Stats rtol 1e-5, each gradient 1e-4 of its
tensor's scale), for the reasons those files give.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.training.train_state import TrainState
from jax import random

from samplenerfro_torch import eval as t_eval
from samplenerfro_torch.data import datasets as t_datasets
from samplenerfro_torch.data import prefetch
from samplenerfro_torch.data import rays as t_rays
from samplenerfro_torch.debug import real_scene
from samplenerfro_torch.models import convert
from samplenerfro_torch.models import nerf as t_nerf
from samplenerfro_torch.train import checkpoints as t_ckpt
from samplenerfro_torch.train import loop as t_loop
from samplenerfro_torch.train import step as t_step
from samplenerfro_torch.utils import config as t_config
from samplenerfro_torch.utils import grid_io
from samplenerfro_torch.utils import metrics as t_metrics
from samplenerfro_torch.utils import render as t_render
from samplenerfro_tpu.data import datasets as j_datasets
from samplenerfro_tpu.data import rays as j_rays
from samplenerfro_tpu.data.rays import Rays as JRays
from samplenerfro_tpu.models import construct_nerf
from samplenerfro_tpu.train import step as j_step
from samplenerfro_tpu.utils import metrics as j_metrics
from tests import fixtures, helpers
from tests.test_torch_model import _jax_jitter
from tests.test_torch_train import STATS, _assert_close_tree, _jitter

ATOL = RTOL = 1e-4
SSIM_ATOL = 1e-5
CUT = {"NerfModel.bd_cut_dist": 6.0}


class _NoThread(j_datasets.OpenCV):
  """The JAX loader without its prefetch thread, so only the test draws."""

  def start(self):
    pass


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
  root = tmp_path_factory.mktemp("cv_scene")
  return fixtures.make_opencv_scene(str(root / "scene"), num_train=3,
                                    num_test=2, res=24)


@pytest.fixture(scope="module")
def odd_scene(tmp_path_factory):
  root = tmp_path_factory.mktemp("cv_odd")
  return fixtures.make_opencv_scene(str(root / "scene"), num_train=2,
                                    num_test=1, res=17)


def _loader_args(data_dir, **kw):
  base = dict(data_dir=data_dir, dataset="opencv", factor=0,
              use_pixel_centers=True, white_bkgd=False, batch_size=32,
              bg_patch_size=6, tile_size=4, tile_stride=1, tile_images=False)
  base.update(kw)
  return helpers.tiny_args(**base)


@pytest.mark.parametrize("centers", [True, False])
def test_opencv_rays_match(centers):
  cam_mat = [[50.0, 0.0, 3.3], [0.0, 48.0, 1.7], [0.0, 0.0, 1.0]]
  c2w = np.stack([np.eye(4), fixtures.opencv_pose([1.0, 3.0, 2.0],
                                                  [0.0, 1.0, 0.0])])
  got = t_rays.generate_opencv_rays(7, 5, cam_mat, c2w, centers)
  want = j_rays.generate_opencv_rays(7, 5, cam_mat, c2w, centers)
  for g, w in zip(got, want):
    assert g.dtype == w.dtype
    np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("split,eval_train", [("test", False),
                                              ("val", True)])
def test_opencv_split_matches_jax(scene, split, eval_train):
  args = _loader_args(scene, eval_train=eval_train)
  ds = _NoThread(split, args)
  rays, images, cam_mat = t_datasets.load_opencv(scene, split, True, False,
                                                 1, eval_train)
  assert cam_mat == ds.cam_mat
  np.testing.assert_array_equal(images, ds.images)
  for g, w in zip(rays, ds.rays):
    np.testing.assert_array_equal(g, w)
  assert images.shape[0] == (3 if eval_train else 2)


def test_load_split_dispatches_and_refuses_factor(scene):
  args = _loader_args(scene)
  rays, images = t_datasets.load_split(args, "val")
  want = t_datasets.load_opencv(scene, "val", True, False)
  np.testing.assert_array_equal(images, want[1])
  for g, w in zip(rays, want[0]):
    np.testing.assert_array_equal(g, w)
  with pytest.raises(ValueError, match="factor"):
    t_datasets.load_split(_loader_args(scene, factor=2), "test")
  # LLFF and NSVF read their own files, which an OpenCV capture lacks; a
  # name that is no scene format is refused before any read.
  with pytest.raises(ValueError, match="Image folder"):
    t_datasets.load_split(_loader_args(scene, dataset="llff"), "test")
  with pytest.raises(FileNotFoundError, match="intrinsics.txt"):
    t_datasets.load_split(_loader_args(scene, dataset="nsvf"), "test")
  with pytest.raises(ValueError, match="'grid'"):
    t_datasets.load_split(_loader_args(scene, dataset="grid"), "test")


@pytest.mark.parametrize("batching,extra", [
    ("single_image", {}), ("single_image", {"precrop_iters": 2}),
    ("all_images", {"bg_patch_size": 0}), ("tile", {}),
    ("tile", {"tile_stride": 2, "tile_images": True})])
def test_opencv_batches_match_next_train(scene, batching, extra):
  args = _loader_args(scene, batching=batching, **extra)
  j_ds = _NoThread("train", args)
  t_ds = t_datasets.TrainBatches(args, np.random.RandomState(5))
  np.random.seed(5)
  for _ in range(3):
    want, got = j_ds._next_train(), next(t_ds)
    np.testing.assert_array_equal(got["pixels"], want["pixels"])
    for g, w in zip(got["rays"], want["rays"]):
      np.testing.assert_array_equal(g, w)
    if want["env_rays"] is None:
      assert got["env_rays"] is None
    else:
      for g, w in zip(got["env_rays"], want["env_rays"]):
        np.testing.assert_array_equal(g, w)
  assert t_ds.train_it == j_ds.train_it == 3


@pytest.mark.parametrize("which,precrop,shape", [
    ("even", 0, (24, 24)), ("odd", 0, (16, 16)), ("odd", 3, (8, 8))])
def test_eval_view_matches_next_test(scene, odd_scene, which, precrop, shape):
  """The central crop, as _next_test takes it: an odd-sized view loses its
  last row and column; with precrop_iters > 0 the precrop window."""
  data_dir = scene if which == "even" else odd_scene
  args = _loader_args(data_dir, precrop_iters=precrop, precrop_frac=0.5)
  j_ds = _NoThread("test", args)
  rays, images, _ = t_datasets.load_opencv(data_dir, "test", True, False)
  for idx in range(images.shape[0]):
    want = j_ds._next_test()
    view, pixels = t_datasets.eval_view(args, rays, images, idx)
    assert pixels.shape[:2] == shape
    np.testing.assert_array_equal(pixels, want["pixels"])
    for g, w in zip(view, want["rays"]):
      np.testing.assert_array_equal(g, w)


def test_central_crop_of_odd_and_blender_views():
  sl = t_datasets.central_crop(7, 10, 0, 0.5)
  assert np.arange(70).reshape(7, 10)[sl].shape == (6, 10)
  sl = t_datasets.central_crop(7, 10, 5, 0.5)
  assert np.arange(70).reshape(7, 10)[sl].shape == (2, 4)
  # Blender views are scored whole.
  args = helpers.tiny_args(dataset="blender", precrop_iters=5)
  rays = t_rays.Rays(*[np.zeros((1, 7, 9, 3), np.float32)] * 4)
  view, pixels = t_datasets.eval_view(args, rays,
                                      np.zeros((1, 7, 9, 3), np.float32), 0)
  assert pixels.shape == (7, 9, 3) and view.origins.shape == (7, 9, 3)


@pytest.mark.parametrize("shape", [(24, 31, 3), (2, 20, 16, 3)])
@pytest.mark.parametrize("return_map", [False, True])
def test_ssim_matches_jax(shape, return_map):
  rng = np.random.RandomState(len(shape))
  a = rng.rand(*shape).astype(np.float32)
  b = np.clip(a + 0.2 * rng.randn(*shape), 0, 1).astype(np.float32)
  want = np.asarray(j_metrics.compute_ssim(jnp.asarray(a), jnp.asarray(b),
                                           1.0, return_map=return_map))
  got = t_metrics.compute_ssim(a, b, 1.0, return_map=return_map).numpy()
  assert got.shape == want.shape
  np.testing.assert_allclose(got, want, atol=SSIM_ATOL, rtol=0)
  assert float(t_metrics.compute_ssim(a, a, 1.0).max()) == pytest.approx(1.0)


def _cut_rays(n=256):
  """Rays from z = -4 through the boxes: some pass below the ball's
  (y < 0.036) and never enter it."""
  side = int(np.sqrt(n))
  d = np.array([[-0.1 + 0.2 * (i % side) / side,
                 -0.15 + 0.3 * (i // side) / side, 1.0]
                for i in range(n)], np.float32)
  d /= np.linalg.norm(d, axis=-1, keepdims=True)
  o = np.broadcast_to(np.array([0.1, 0.3, -4.0], np.float32), d.shape).copy()
  return o, d, np.full((n, 1), 1e-3, np.float32)


def _cut_args(stage, name, **kw):
  base = dict(randomized=False, march_mode="scan", net_depth=6, net_width=32,
              num_coarse_samples=8, num_path_samples=4, num_fine_samples=16,
              stage=stage, config=f"configs/tpu/{name}")
  base.update(kw)
  return helpers.tiny_args(**base)


@pytest.mark.parametrize("stage", ["radiance", "all"])
@pytest.mark.parametrize("name", ["pen", "ball", "glass"])
def test_bd_cut_matches_jax(stage, name):
  args = _cut_args(stage, name)
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(64, 1.5, 0.33)
  o, d, radii = _cut_rays()
  jrays = JRays(*map(jnp.asarray, (o, d, d, radii)))
  model, variables = construct_nerf(random.PRNGKey(0), {"rays": jrays}, args,
                                    ndim, nmin, nmax, values,
                                    gin_overrides=CUT)
  rng_0, rng_1 = random.PRNGKey(1), random.PRNGKey(2)
  ret, _ = model.apply(variables, rng_0, rng_1, jrays, False, 0.5)

  params = convert.params_from_flax(
      jax.tree_util.tree_map(np.asarray, variables["params"]))
  port = t_nerf.construct_nerf(args, ndim, nmin, nmax, values, CUT,
                               device="cpu")
  uncut = t_nerf.construct_nerf(args, ndim, nmin, nmax, values, device="cpu")
  convert.load_into(port, params)
  convert.load_into(uncut, params)
  jitter = torch.from_numpy(np.array(_jax_jitter(rng_0, args)))
  trays = t_rays.Rays(*map(torch.from_numpy, (o, d, d, radii)))
  with torch.no_grad():
    got, _ = port(trays, jitter, annealed_alpha=0.5)
    plain, _ = uncut(trays, jitter, annealed_alpha=0.5)
  names = ("comp_rgb", "distance", "acc", "trans", "trans_rgb_bkgd")
  for level in (0, 1):
    for i, what in enumerate(names):
      np.testing.assert_allclose(got[level][i].numpy(),
                                 np.asarray(ret[level][i]), atol=ATOL,
                                 rtol=RTOL, err_msg=f"level {level} {what}")
  # The cut acts at the fine level only, and there on trans and
  # trans_rgb_bkgd alone.
  for i in range(5):
    assert torch.equal(got[0][i], plain[0][i])
  assert torch.equal(got[1][0], plain[1][0])
  assert float((got[1][3] - plain[1][3]).abs().max()) > 1e-2
  assert float((got[1][4] - plain[1][4]).abs().max()) > 1e-2


def test_bd_cut_box_by_config_name():
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(8, 1.5, 0.33)
  boxes = {name: t_nerf.construct_nerf(
      _cut_args("radiance", name), ndim, nmin, nmax, values, CUT,
      device="cpu").cut_box for name in ("pen", "ball", "glass", "opencv")}
  assert boxes["pen"][0] == [-1.5] * 3
  assert boxes["pen"][1] == pytest.approx([1.5, 0.9, 1.5])
  assert boxes["ball"] == ([-1, 0.03597, -1], [1, 2.03597, 1])
  assert boxes["glass"][1][1] == pytest.approx(0.8)
  # A substring of the whole path, in the JAX model's order: "opencv"
  # holds "pen".
  assert boxes["opencv"] == boxes["pen"]
  for name in ("ship", None):
    args = _cut_args("radiance", "x")
    args.config = name
    with pytest.raises(NotImplementedError, match="boundary cut"):
      t_nerf.construct_nerf(args, ndim, nmin, nmax, values, CUT, device="cpu")
  # Without fine samples the cut is never applied (nor looked up).
  args = _cut_args("radiance", "ship", num_fine_samples=0)
  assert t_nerf.construct_nerf(args, ndim, nmin, nmax, values, CUT,
                               device="cpu").cut_box is None


def test_bd_cut_with_fused_mlp():
  """--mlp_kernel=pallas and the cut compose: on the CPU the fused path
  runs its plain version and the cut re-renders its rgb and sigma."""
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(16, 1.5, 0.33)
  kw = dict(net_width=128, net_width_condition=128, net_depth=2)
  fused = t_nerf.construct_nerf(
      _cut_args("radiance", "glass", mlp_kernel="pallas", **kw), ndim, nmin,
      nmax, values, CUT, device="cpu", seed=3)
  linear = t_nerf.construct_nerf(_cut_args("radiance", "glass", **kw), ndim,
                                 nmin, nmax, values, CUT, device="cpu",
                                 seed=3)
  assert fused._use_fused_mlp() and fused.cut_box == linear.cut_box
  o, d, radii = _cut_rays(64)
  rays = t_rays.Rays(*map(torch.from_numpy, (o, d, d, radii)))
  jitter = torch.arange(0, 32, 4) + 1
  with torch.no_grad():
    got, want = fused(rays, jitter)[0][1], linear(rays, jitter)[0][1]
  for g, w in zip(got, want):
    np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def low_scene(tmp_path_factory):
  """Cameras looking at a point 1.6 off the ball's box in z: some rays
  never enter the box (trans 1 under the cut), some enter late."""
  root = tmp_path_factory.mktemp("cv_low")
  return fixtures.make_opencv_scene(str(root / "scene"), num_train=3,
                                    num_test=1, res=24,
                                    center=(0.0, 1.0, 1.6))


@pytest.mark.parametrize("stage", ["radiance", "all"])
def test_train_step_with_cut_matches_jax(low_scene, stage):
  """One train step on a batch of the OpenCV loader, the ball's cut on:
  the loss, loss_bg and every Stats field, and each parameter's gradient."""
  args = _loader_args(
      low_scene, stage=stage, config="cfg/ballcv", randomized=False,
      march_mode="scan", net_depth=4, net_width=32, num_coarse_samples=8,
      num_path_samples=4, num_fine_samples=16, grad_max_norm=0.0,
      bg_patch_size=4, max_deg_point=4, near=1.0, far=4.0, bg_weight=0.5)
  host = next(t_datasets.TrainBatches(args, np.random.RandomState(2)))
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(48, 2.0, 0.33)
  jbatch = {"rays": JRays(*map(jnp.asarray, host["rays"])),
            "env_rays": JRays(*map(jnp.asarray, host["env_rays"])),
            "pixels": jnp.asarray(host["pixels"]),
            "annealed_alpha": jnp.float32(0.5),
            "coarse_alpha_target": jnp.float32(0.0),
            "fine_alpha_target": jnp.float32(0.0)}
  model, variables = construct_nerf(random.PRNGKey(0), jbatch, args, ndim,
                                    nmin, nmax, values, gin_overrides=CUT)
  tx, _, _ = j_step.create_optimizer(args)
  state = TrainState.create(apply_fn=model.apply,
                            params=variables["params"], tx=tx)
  tstep = j_step.make_train_step(model, args, {"grid": variables["grid"]},
                                 donate=False)
  rng = random.PRNGKey(3)
  state1, j_stats, _ = tstep(rng, state, jbatch)

  port = t_nerf.construct_nerf(args, ndim, nmin, nmax, values, CUT,
                               device="cpu")
  convert.load_into(port, convert.params_from_flax(
      jax.tree_util.tree_map(np.asarray, variables["params"])))
  optimizer, _, _ = t_step.create_optimizer(port, args)
  tbatch = prefetch.to_device(t_loop.step_batch(
      host, 0.5, t_step.learning_rates(optimizer, 0), _jitter(rng, args),
      args), "cpu")
  stats = t_step.train_step(port, optimizer, tbatch, args).as_floats()
  assert float(j_stats.loss_bg) > 0
  for name in STATS:
    np.testing.assert_allclose(getattr(stats, name),
                               float(getattr(j_stats, name)), rtol=1e-5,
                               atol=1e-7, err_msg=name)
  mu = state1.opt_state.inner_states["adam_lr_scheduler"].inner_state[0].mu
  mu = {k: v for k, v in mu.items() if isinstance(v, dict)}
  want = {k: v.numpy() / np.float32(0.1) for k, v in convert.params_from_flax(
      jax.tree_util.tree_map(np.asarray, mu)).items()}
  got = {k: p.grad.numpy() for k, p in port.named_parameters()
         if p.grad is not None}
  _assert_close_tree(got, want,
                     lambda w: 1e-4 * max(float(np.abs(w).max()), 1e-12),
                     "grad")


def _tiny_cfg(tmp_path, **gin):
  cfg = fixtures.write_tiny_config(str(tmp_path / "cfg"))
  if gin:
    with open(cfg + ".gin", "a") as f:
      for k, v in gin.items():
        f.write(f"{k} = {v}\n")
  return cfg


def _saved(model, train_dir, name, step):
  t_ckpt.save_checkpoint(os.path.join(train_dir, name), model,
                         torch.optim.Adam(model.parameters()), step)


@pytest.mark.parametrize("stage,fine", [("radiance", 16), ("all", 16),
                                        ("all_x", 0)])
def test_load_stage_weights_surgery(tmp_path, stage, fine):
  """radiance* takes the radiance MLPs from Config.radiance_weight_name's
  newest checkpoint, all* those and the path sampler from
  Config.all_weight_name's; nothing else moves."""
  args = _cut_args(stage, "ship", num_fine_samples=fine)
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(8, 1.5, 0.33)
  build = lambda seed: t_nerf.construct_nerf(args, ndim, nmin, nmax, values,
                                             device="cpu", seed=seed)
  trained, other = build(1), build(2)
  train_dir = str(tmp_path / "logs")
  name = "rad_w" if stage == "radiance" else "all_w"
  _saved(build(4), train_dir, name, 2)
  _saved(trained, train_dir, name, 7)
  cfg = t_config.Config(radiance_weight_name="rad_w", all_weight_name="all_w")
  fresh = {k: v.clone() for k, v in other.state_dict().items()}
  assert t_ckpt.load_stage_weights(other, train_dir, cfg, stage) == 7
  moved = ("bkgd_mlp", "coarse_mlp", "fine_mlp") + (
      ("path_sampler",) if stage.startswith("all") else ())
  want = trained.state_dict()
  for k, v in other.state_dict().items():
    if k == "path_sampler.grid":
      assert torch.equal(v, fresh[k])
    elif k.split(".")[0] in moved:
      assert torch.equal(v, want[k]), k
    else:
      assert torch.equal(v, fresh[k]), k
  assert any(k.startswith("path_sampler.so3") for k in want)
  assert (other.fine_mlp is None) == (fine == 0)


def test_load_stage_weights_refusals(tmp_path):
  args = _cut_args("radiance", "ship")
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(8, 1.5, 0.33)
  model = t_nerf.construct_nerf(args, ndim, nmin, nmax, values, device="cpu")
  train_dir = str(tmp_path / "logs")
  unset = t_config.Config(radiance_weight_name=None)
  with pytest.raises(ValueError, match="Config.radiance_weight_name"):
    t_ckpt.load_stage_weights(model, train_dir, unset, "radiance")
  with pytest.raises(FileNotFoundError, match=os.path.join(train_dir, "all")):
    t_ckpt.load_stage_weights(model, train_dir, t_config.Config(), "all")
  os.makedirs(os.path.join(train_dir, "radiance"))
  with pytest.raises(FileNotFoundError, match="radiance"):
    t_ckpt.load_stage_weights(model, train_dir, t_config.Config(),
                              "radiance")
  # The ior stage reads both names; the ior one unbound raises after the
  # radiance weights load.
  t_ckpt.save_checkpoint(os.path.join(train_dir, "radiance"), model,
                         torch.optim.Adam(model.parameters()), 2)
  with pytest.raises(ValueError, match="Config.ior_weight_name"):
    t_ckpt.load_stage_weights(model, train_dir,
                              t_config.Config(ior_weight_name=None), "ior")
  with pytest.raises(FileNotFoundError, match=os.path.join(train_dir, "ior")):
    t_ckpt.load_stage_weights(model, train_dir, t_config.Config(), "ior")
  with pytest.raises(ValueError, match="unknown stage"):
    t_ckpt.load_stage_weights(model, train_dir, t_config.Config(), "nope")


def test_eval_without_a_checkpoint_raises(tmp_path):
  scene = fixtures.make_scene(str(tmp_path / "scene"), num_train=1,
                              num_test=1, res=16, grid_n=8)
  cfg = _tiny_cfg(tmp_path)
  with pytest.raises(FileNotFoundError, match="radiance"):
    t_eval.main([f"--data_dir={scene}", f"--train_dir={tmp_path / 'out'}",
                 f"--config={cfg}", f"--gin_file={cfg}.gin", "--device=cpu"])
  assert not os.path.exists(tmp_path / "out" / "radiance" / "test_preds")


@pytest.mark.parametrize("stage", ["radiance", "all"])
def test_train_then_eval_renders_the_checkpoint(tmp_path, stage, capsys,
                                                monkeypatch):
  """`train` then `eval` on a tiny OpenCV scene with the ball's cut: eval's
  PSNR and SSIM are those of the model train returned, rendered on the
  same cropped test view with the same seeded jitter."""
  # The cut's box is chosen by substring of the config path, "pen" first,
  # and pytest-xdist's temporary paths hold "popen": give a relative one.
  monkeypatch.chdir(tmp_path)
  data = fixtures.make_opencv_scene("scene", num_train=3, num_test=1,
                                    res=16)
  real_scene.write_blob_grid(os.path.join(data, "hull"), 24, 1.5)
  cfg = fixtures.write_opencv_config("cfg")
  common = [f"--data_dir={data}", "--train_dir=logs", f"--config={cfg}",
            f"--gin_file={cfg}.gin", "--device=cpu", f"--stage={stage}",
            "--chunk=96"]
  model = t_loop.main(common + ["--render_every=3"])
  assert "SSIM = " in capsys.readouterr().out
  assert model.cut_box == ([-1, 0.03597, -1], [1, 2.03597, 1])
  res = t_eval.main(common)
  assert res.step == 3

  args, _, _ = t_config.load_args(cfg, [cfg + ".gin"])
  rays, images, _ = t_datasets.load_opencv(data, "test", True, False)
  view, pixels = t_datasets.eval_view(args, rays, images, 0)
  jitter = t_nerf.make_jitter(args.num_coarse_samples, args.num_path_samples,
                              torch.Generator().manual_seed(0))
  rgb, _, _ = t_render.render_image(t_eval.make_render_fn(model, jitter),
                                    view, False, chunk=96, device="cpu")
  assert res.psnrs == [t_metrics.compute_psnr(((rgb - pixels)**2).mean())]
  assert res.ssims == [float(t_metrics.compute_ssim(rgb, pixels, 1.0))]
  out = tmp_path / "logs" / stage / "test_preds"
  assert sorted(os.listdir(out)) == [
      "000.png", "depth_000.png", "depth_mod_000.png", "depth_normals_000.png",
      "disp_000.png", "psnr.txt", "psnrs_3.txt", "ssim.txt", "ssims_3.txt"]


def test_real_scene_writer_loads(tmp_path):
  """The chip smoke's OpenCV capture, at a small size: it loads through the
  port's loader, with an off-centre principal point and a blob grid."""
  data = real_scene.write_scene(str(tmp_path / "cap"), width=20, height=12,
                                grid_n=16)
  with open(os.path.join(data, "transforms_train.json")) as f:
    meta = json.load(f)
  assert meta["cam_mat"][0][2] != 10.0 and meta["cam_mat"][1][2] != 6.0
  for split, n in (("train", real_scene.NUM_TRAIN), ("val", 1),
                   ("test", 1)):
    rays, images, _ = t_datasets.load_opencv(data, split, True, False)
    assert images.shape == (n, 12, 20, 3) and images.dtype == np.float32
    assert all(np.isfinite(r).all() for r in rays)
  values, ndim, nmin, nmax = grid_io.load_mesh_pkl(
      data, "voxelize_uni384_bbox-3.5")
  assert values.dtype == np.float32 and ndim == [16] * 3
  assert (nmin, nmax) == ([-3.5] * 3, [3.5] * 3)
  np.testing.assert_array_equal(
      values, grid_io.synthetic_blob_grid(16, 3.5, 0.33, 2.0)[0])
