"""The port's data, config, grid-IO and eval modules against the JAX package."""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from samplenerfro_torch import eval as t_eval
from samplenerfro_torch.data import datasets as t_datasets
from samplenerfro_torch.data import rays as t_rays
from samplenerfro_torch.train import checkpoints as t_ckpt
from samplenerfro_torch.utils import config as t_config
from samplenerfro_torch.utils import grid_io as t_grid_io
from samplenerfro_torch.utils import metrics as t_metrics
from samplenerfro_torch.utils import render as t_render
from samplenerfro_tpu.data import datasets as j_datasets
from samplenerfro_tpu.data import rays as j_rays
from samplenerfro_tpu.ops import eikonal_tiled
from samplenerfro_tpu.tools import synth
from samplenerfro_tpu.utils import config as j_config
from samplenerfro_tpu.utils import gin_lite
from samplenerfro_tpu.utils import grid_io as j_grid_io
from samplenerfro_tpu.utils import metrics as j_metrics
from tests import fixtures, helpers

CONFIGS = sorted(glob.glob("configs/*.yaml") + glob.glob("configs/tpu/*.yaml"))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
  root = tmp_path_factory.mktemp("torch_scene")
  return fixtures.make_scene(str(root / "scene"), num_train=1, num_test=2,
                             res=16, grid_n=12)


@pytest.mark.parametrize("pth", CONFIGS)
def test_flat_yaml_reader_matches_pyyaml(pth):
  with open(pth) as f:
    want = yaml.load(f, Loader=yaml.FullLoader)
  assert t_config.read_flat_yaml(pth) == want


def test_gin_and_flag_overlay_match_jax():
  base = "configs/tpu/ship_skydome-bkgd_no-partial-reflect_cycles"
  extra = ["Config.kernel_size = 5  # trailing comment"]
  args, cfg, bindings = t_config.load_args(base, [base + ".gin"], extra,
                                           chunk=4096)
  assert bindings == gin_lite.parse_files_and_bindings([base + ".gin"], extra)
  assert cfg == t_config.Config(**vars(j_config.Config.from_gin(bindings)))
  assert cfg.kernel_size == 5 and cfg.voxel_grid == "voxelize_uni512_highpoly"
  assert args.chunk == 4096 and args.num_path_samples == 12
  assert args.march_interp == "default" and "march_interp" in (
      t_config.IGNORED_FLAGS)
  with pytest.raises(ValueError, match="unknown flags"):
    t_config.load_args(base, [base + ".gin"], not_a_flag=1)


def test_pinhole_rays_match():
  c2w = np.stack([np.eye(4), fixtures.look_at_pose([1.0, 3.0, 2.0])])
  got = t_rays.generate_pinhole_rays(6, 4, 5.0, c2w, True)
  want = j_rays.generate_pinhole_rays(6, 4, 5.0, c2w, True)
  for g, w in zip(got, want):
    np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("factor,white", [(0, False), (2, True)])
def test_blender_test_split_matches_jax(scene, factor, white):
  args = helpers.tiny_args(data_dir=scene, factor=factor, white_bkgd=white,
                           use_pixel_centers=True, bg_patch_size=0)
  ds = j_datasets.Blender("test", args)
  rays, images = t_datasets.load_blender(scene, "test", factor, True, white)
  assert images.shape == ds.images.shape
  # cv2.INTER_AREA averages each 2x2 block in its own summation order.
  np.testing.assert_allclose(images, ds.images, atol=1e-6)
  for g, w in zip(rays, ds.rays):
    np.testing.assert_allclose(g, w, atol=1e-6)


def test_synthetic_blob_grid_matches_synth():
  values, ndim, nmin, nmax = t_grid_io.synthetic_blob_grid(20, 1.5, 0.33)
  np.testing.assert_array_equal(values, synth.blob_ior_grid(20, 1.5, 0.33))
  assert (ndim, nmin, nmax) == ([20] * 3, [-1.5] * 3, [1.5] * 3)


def test_load_ior_grid_matches_jax(scene):
  for name in ("glass_scene", "ship_scene"):  # the two rescale factors
    cfg = t_config.Config(kernel_size=3, kernel_sigma=1.0)
    got = t_grid_io.load_ior_grid(scene, cfg, name, device="cpu")
    want = j_grid_io.load_ior_grid(scene, cfg, name)
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=1e-6)
    assert got[1:] == want[1:]


def test_tile_order_matches_jax():
  for h, w in ((32, 48), (20, 36)):
    for g, want in zip(t_render.tile_order(h, w, 16),
                       eikonal_tiled.tile_order(h, w, 16)):
      np.testing.assert_array_equal(g, want)


def test_render_image_unpermutes_tiles():
  h, w = 20, 36
  rays = t_rays.Rays(*[np.random.RandomState(i).rand(h, w, 3)
                       .astype(np.float32) for i in range(4)])
  # An identity renderer: the image must come back in raster order.
  fn = lambda r: (r.origins, r.directions[:, 0], r.viewdirs[:, 0])
  rgb, dist, acc = t_render.render_image(fn, rays, False, chunk=100,
                                         device="cpu")
  np.testing.assert_array_equal(rgb, rays.origins)
  np.testing.assert_array_equal(dist[..., 0], rays.directions[..., 0])
  np.testing.assert_array_equal(acc[..., 0], rays.viewdirs[..., 0])


def test_psnr_matches_jax():
  for mse in (1e-4, 0.01, 0.5):
    np.testing.assert_allclose(t_metrics.compute_psnr(mse),
                               float(j_metrics.compute_psnr(jnp.float32(mse))),
                               rtol=1e-6)


def test_eval_entry_point_on_cpu(scene, tmp_path):
  """Eval renders the radiance stage's checkpoint, a seeded model's saved
  at step 5, and writes its scores beside the images."""
  cfg = fixtures.write_tiny_config(str(tmp_path / "cfg"))
  args, gcfg, bindings = t_config.load_args(cfg, [cfg + ".gin"])
  model = t_eval.build_model(args, gcfg, bindings, scene, "cpu", seed=7)
  t_ckpt.save_checkpoint(str(tmp_path / "out" / "radiance"), model,
                         torch.optim.Adam(model.parameters()), 5)
  res = t_eval.main([
      f"--data_dir={scene}", f"--train_dir={tmp_path / 'out'}",
      f"--config={cfg}", f"--gin_file={cfg}.gin", "--device=cpu",
      "--chunk=128"])
  out = tmp_path / "out" / "radiance" / "test_preds"
  images = [f"{k}{i:03d}.png" for i in range(2)
            for k in ("", "depth_", "depth_mod_", "depth_normals_", "disp_")]
  assert sorted(os.listdir(out)) == sorted(
      images + ["psnr.txt", "psnrs_5.txt", "ssim.txt", "ssims_5.txt"])
  assert res.step == 5
  assert len(res.psnrs) == 2 and all(np.isfinite(res.psnrs))
  assert len(res.ssims) == 2 and all(np.isfinite(res.ssims))
  assert float((out / "psnr.txt").read_text()) == pytest.approx(
      np.mean(res.psnrs))
  assert float((out / "ssim.txt").read_text()) == pytest.approx(
      np.mean(res.ssims))
  assert [float(v) for v in (out / "ssims_5.txt").read_text().split()] == (
      res.ssims)


def test_eval_chunks_agree_with_one_batch(scene, tmp_path):
  """Chunking and the tile permutation change nothing in the image."""
  cfg = fixtures.write_tiny_config(str(tmp_path / "cfg"))
  args, gcfg, bindings = t_config.load_args(cfg, [cfg + ".gin"])
  model = t_eval.build_model(args, gcfg, bindings, scene, "cpu", seed=0)
  rays, _ = t_datasets.load_blender(scene, "test", args.factor, True, False)
  view = t_rays.Rays(*[r[0] for r in rays])
  jitter = torch.tensor([0, 3, 4, 6, 9, 11, 12, 15])
  fn = t_eval.make_render_fn(model, jitter)
  chunked = t_render.render_image(fn, view, False, chunk=96, device="cpu")
  whole = t_render.render_image(fn, view, False, chunk=16 * 16, device="cpu",
                                tile=0)
  for a, b in zip(chunked, whole):
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_eval_refuses_an_unported_dataset(scene, tmp_path, monkeypatch):
  """A config naming no scene format stops with ValueError naming the
  dataset, before eval reads any scene file."""
  cfg = fixtures.write_tiny_config(str(tmp_path / "cfg"))
  with open(cfg + ".yaml") as f:
    text = f.read().replace("dataset: blender", "dataset: colmap")
  with open(cfg + ".yaml", "w") as f:
    f.write(text)

  def untouched(*args, **kwargs):
    raise AssertionError("a scene file was read")

  monkeypatch.setattr(t_datasets, "load_split", untouched)
  monkeypatch.setattr(t_datasets, "load_render_path", untouched)
  monkeypatch.setattr(t_eval, "build_model", untouched)
  with pytest.raises(ValueError, match="'colmap'"):
    t_eval.main([f"--data_dir={scene}", f"--train_dir={tmp_path / 'out'}",
                 f"--config={cfg}", f"--gin_file={cfg}.gin", "--device=cpu"])


def test_eval_render_path_raises_on_blender(scene, tmp_path, monkeypatch):
  """--render_path on a Blender scene raises the JAX loader's ValueError
  before any scene file is read (fault F5: eval scored the test views)."""
  cfg = fixtures.write_tiny_config(str(tmp_path / "cfg"))

  def untouched(*args, **kwargs):
    raise AssertionError("a scene file was read")

  monkeypatch.setattr(t_datasets, "load_split", untouched)
  monkeypatch.setattr(t_eval, "build_model", untouched)
  with pytest.raises(ValueError, match="render_path cannot be used for the "
                     "blender dataset"):
    t_eval.main([f"--data_dir={scene}", f"--train_dir={tmp_path / 'out'}",
                 f"--config={cfg}", f"--gin_file={cfg}.gin", "--device=cpu",
                 "--render_path=True"])
  assert not os.path.exists(tmp_path / "out")


def _saved_radiance(scene, tmp_path, steps):
  cfg = fixtures.write_tiny_config(str(tmp_path / "cfg"))
  args, gcfg, bindings = t_config.load_args(cfg, [cfg + ".gin"])
  model = t_eval.build_model(args, gcfg, bindings, scene, "cpu", seed=7)
  for step in steps:
    t_ckpt.save_checkpoint(str(tmp_path / "out" / "radiance"), model,
                           torch.optim.Adam(model.parameters()), step)
  return cfg, model


def test_eval_save_output_false_writes_nothing(scene, tmp_path):
  """--save_output=False scores the views and writes no file (F5)."""
  cfg, _ = _saved_radiance(scene, tmp_path, [5])
  res = t_eval.main([
      f"--data_dir={scene}", f"--train_dir={tmp_path / 'out'}",
      f"--config={cfg}", f"--gin_file={cfg}.gin", "--device=cpu",
      "--chunk=128", "--save_output=False"])
  assert res.step == 5 and len(res.psnrs) == 2 and all(np.isfinite(res.psnrs))
  assert os.listdir(tmp_path / "out" / "radiance") == ["checkpoint_5"]


def test_eval_once_false_polls_until_max_steps(scene, tmp_path, monkeypatch):
  """--eval_once=False evaluates the newest checkpoint, waits while no newer
  one is written, and stops after one at --max_steps (F5); a checkpoint
  already at max_steps is evaluated once."""
  cfg, model = _saved_radiance(scene, tmp_path, [3])
  stage_dir = str(tmp_path / "out" / "radiance")
  sleeps = []

  def trainer_writes_step_5(secs):
    sleeps.append(secs)
    t_ckpt.save_checkpoint(stage_dir, model,
                           torch.optim.Adam(model.parameters()), 5)

  monkeypatch.setattr(t_eval.time, "sleep", trainer_writes_step_5)
  common = [f"--data_dir={scene}", f"--train_dir={tmp_path / 'out'}",
            f"--config={cfg}", f"--gin_file={cfg}.gin", "--device=cpu",
            "--chunk=128", "--eval_once=False", "--max_steps=5"]
  res = t_eval.main(common)
  assert res.step == 5 and sleeps == [t_eval.POLL_SECONDS]
  out = sorted(os.listdir(os.path.join(stage_dir, "test_preds")))
  assert {"psnrs_3.txt", "psnrs_5.txt", "psnr.txt"} <= set(out)
  # Already at max_steps: one evaluation, no wait.
  sleeps.clear()
  assert t_eval.main(common).step == 5 and sleeps == []
