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
  rays, images = t_datasets.load_blender_test(scene, factor, True, white)
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
  cfg = fixtures.write_tiny_config(str(tmp_path / "cfg"))
  psnrs = t_eval.main([
      f"--data_dir={scene}", f"--train_dir={tmp_path / 'out'}",
      f"--config={cfg}", f"--gin_file={cfg}.gin", "--device=cpu",
      "--chunk=128"])
  out = tmp_path / "out" / "radiance" / "test_preds"
  assert sorted(os.listdir(out)) == ["000.png", "001.png", "psnr.txt"]
  assert len(psnrs) == 2 and all(np.isfinite(psnrs))
  assert float((out / "psnr.txt").read_text()) == pytest.approx(
      np.mean(psnrs))


def test_eval_chunks_agree_with_one_batch(scene, tmp_path):
  """Chunking and the tile permutation change nothing in the image."""
  cfg = fixtures.write_tiny_config(str(tmp_path / "cfg"))
  args, gcfg, bindings = t_config.load_args(cfg, [cfg + ".gin"])
  model = t_eval.build_model(args, gcfg, bindings, scene, "cpu", seed=0)
  rays, _ = t_datasets.load_blender_test(scene, args.factor, True, False)
  view = t_rays.Rays(*[r[0] for r in rays])
  jitter = torch.tensor([0, 3, 4, 6, 9, 11, 12, 15])
  fn = t_eval.make_render_fn(model, jitter)
  chunked = t_render.render_image(fn, view, False, chunk=96, device="cpu")
  whole = t_render.render_image(fn, view, False, chunk=16 * 16, device="cpu",
                                tile=0)
  for a, b in zip(chunked, whole):
    np.testing.assert_allclose(a, b, atol=1e-6)
