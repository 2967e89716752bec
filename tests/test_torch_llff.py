"""The port's LLFF and NSVF loaders, camera paths and --render_path
against the JAX package.

The same files (debug/llff_scene.py's captures, an NSVF scene written
here) go to both packages' loaders: data/pose_paths.py against the JAX
package's goldens and functions; rays.convert_to_ndc; LLFF (spiral and
spherified, the llffhold split and the 200-image index split) and NSVF
rays, radii, images and render rays; the LLFF training batches against
LLFF._next_train on the same draws; --render_path refused, with the JAX
loaders' message, for the formats without a path; and `train` on an LLFF
capture, then `eval --render_path`, on the CPU.

Tolerances: exact everywhere (the same numpy expressions on the same
files), but the camera paths against the goldens, which
tests/test_pose_paths.py holds at 1e-5; against the JAX functions they
are exact too.
"""

import os

import numpy as np
import pytest
from PIL import Image

from samplenerfro_torch import eval as t_eval
from samplenerfro_torch.data import datasets as t_datasets
from samplenerfro_torch.data import pose_paths as t_pose_paths
from samplenerfro_torch.data import rays as t_rays
from samplenerfro_torch.debug import llff_scene
from samplenerfro_torch.train import loop as t_loop
from samplenerfro_torch.utils import config as t_config
from samplenerfro_tpu.data import datasets as j_datasets
from samplenerfro_tpu.data import pose_paths as j_pose_paths
from samplenerfro_tpu.data import rays as j_rays
from tests import fixtures, helpers

GOLD = os.path.join(os.path.dirname(__file__), "golden", "pose_paths",
                    "goldens.npz")


class _NoThreadLLFF(j_datasets.LLFF):
  def start(self):
    pass


class _NoThreadNSVF(j_datasets.NSVF):
  def start(self):
    pass


def test_pose_paths_match_goldens_and_jax():
  g = np.load(GOLD)
  got = t_pose_paths.recenter_poses(g["poses"])
  np.testing.assert_allclose(got, g["recentered"], rtol=1e-5, atol=1e-5)
  np.testing.assert_array_equal(got, j_pose_paths.recenter_poses(g["poses"]))
  spiral = t_pose_paths.spiral_path(g["recentered"], g["bds"])
  assert spiral.shape == (120, 3, 4) and spiral.dtype == np.float32
  np.testing.assert_allclose(spiral, g["spiral"], rtol=1e-5, atol=1e-5)
  np.testing.assert_array_equal(
      spiral, j_pose_paths.spiral_path(g["recentered"], g["bds"]))
  bds = g["bds"].copy()
  got = t_pose_paths.spherify_poses(g["recentered"], bds)
  want = j_pose_paths.spherify_poses(g["recentered"], g["bds"])
  for a, b, gold in zip(got, want, ("spherical_reset", "spherical_render",
                                    "bds_after_spherify")):
    np.testing.assert_allclose(a, g[gold], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(a, b)
  np.testing.assert_array_equal(bds, g["bds"])


def test_convert_to_ndc_matches_jax():
  rng = np.random.RandomState(0)
  o = (rng.randn(5, 7, 3) * 0.3 + [0, 0, 1.0]).astype(np.float32)
  d = (rng.randn(5, 7, 3) * 0.2 + [0, 0, -1.0]).astype(np.float32)
  focal = np.float32(21.5)
  got = t_rays.convert_to_ndc(o, d, focal, 24, 16)
  want = j_rays.convert_to_ndc(o, d, focal, 24, 16)
  for a, b in zip(got, want):
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)
  # The origins sit on the near plane, z = -1 in NDC.
  np.testing.assert_allclose(got[0][..., 2], -1.0, atol=1e-6)


@pytest.fixture(scope="module", params=[False, True], ids=["spiral",
                                                           "spherify"])
def llff(request, tmp_path_factory):
  root = tmp_path_factory.mktemp("llff")
  inward = request.param
  return inward, llff_scene.write_scene(str(root / "scene"), views=12,
                                        width=24, height=16, factor=0,
                                        grid_n=8, inward=inward)


def _llff_args(data_dir, spherify, **kw):
  base = dict(data_dir=data_dir, dataset="llff", factor=0, llffhold=4,
              spherify=spherify, batch_size=32, bg_patch_size=4,
              tile_size=4, tile_stride=1, tile_images=False)
  base.update(kw)
  return helpers.tiny_args(**base)


@pytest.mark.parametrize("split", ["train", "test"])
def test_llff_loader_matches_jax(llff, split):
  spherify, root = llff
  j_ds = _NoThreadLLFF(split, _llff_args(root, spherify))
  rays, images, path = t_datasets.load_llff(root, split, 0, spherify, 4, True)
  assert images.shape == ((9,) if split == "train" else (3,)) + (16, 24, 3)
  np.testing.assert_array_equal(images.reshape(j_ds.images.shape),
                                j_ds.images)
  for got, want in zip(rays, j_ds.rays):
    # (NDC radii are float64 in both: np.sqrt(12) is a float64 scalar.)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.reshape(want.shape), want)
  if split == "train":
    assert path is None
    return
  assert path.origins.shape == (120, 16, 24, 3)
  for got, want in zip(path, j_ds.render_rays):
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
  # NDC rays (spiral): the origins on the near plane; spherified rays are
  # world rays with unit viewdirs.
  if spherify:
    np.testing.assert_allclose(np.linalg.norm(rays.viewdirs, axis=-1), 1.0,
                               atol=1e-6)
  else:
    np.testing.assert_allclose(rays.origins[..., 2], -1.0, atol=1e-5)
  args = _llff_args(root, spherify, render_path=True)
  for got, want in zip(t_datasets.load_render_path(args), path):
    np.testing.assert_array_equal(got, want)


def test_llff_large_capture_splits_by_index(tmp_path):
  """200 or more views: 100-199 train, 0-99 test, whatever llffhold says."""
  root = llff_scene.write_scene(str(tmp_path / "big"), views=200, width=8,
                                height=6, factor=0, grid_n=4)
  for split, first in (("train", 100), ("test", 0)):
    j_ds = _NoThreadLLFF(split, _llff_args(root, False, llffhold=8))
    rays, images, _ = t_datasets.load_llff(root, split, 0, False, 8, True)
    assert images.shape[0] == 100
    np.testing.assert_array_equal(images.reshape(j_ds.images.shape),
                                  j_ds.images)
    for got, want in zip(rays, j_ds.rays):
      np.testing.assert_array_equal(got.reshape(want.shape), want)
    full = np.stack([np.asarray(Image.open(os.path.join(
        root, "images", f"{i:03d}.jpg")), np.float32) / 255.0
                     for i in (first, first + 99)])
    np.testing.assert_array_equal(images[[0, -1]], full)


def test_llff_factor_reads_its_folder(tmp_path):
  root = llff_scene.write_scene(str(tmp_path / "f2"), views=5, width=12,
                                height=8, factor=2, grid_n=4)
  j_ds = _NoThreadLLFF("train", _llff_args(root, False, factor=2))
  rays, images, _ = t_datasets.load_llff(root, "train", 2, False, 4, True)
  for got, want in zip(rays, j_ds.rays):
    np.testing.assert_array_equal(got.reshape(want.shape), want)
  with pytest.raises(ValueError, match="images_4"):
    t_datasets.load_llff(root, "train", 4, False, 4, True)


def _nsvf_scene(root):
  rng = np.random.RandomState(0)
  os.makedirs(os.path.join(root, "rgb"))
  os.makedirs(os.path.join(root, "pose"))
  with open(os.path.join(root, "intrinsics.txt"), "w") as f:
    f.write("21.0 8.0 8.0 0.0\n")
  for prefix, count in ((0, 3), (1, 1), (2, 2)):
    for i in range(count):
      img = (rng.rand(16, 20, 4) * 255).astype(np.uint8)
      Image.fromarray(img).save(os.path.join(root, "rgb",
                                             f"{prefix}_{i:04d}.png"))
      theta = 0.3 * i + prefix
      pose = np.eye(4)
      pose[:3, :3] = [[np.cos(theta), 0, np.sin(theta)], [0, 1, 0],
                      [-np.sin(theta), 0, np.cos(theta)]]
      pose[:3, 3] = [4 * np.sin(theta), 0.2, 4 * np.cos(theta)]
      np.savetxt(os.path.join(root, "pose", f"{prefix}_{i:04d}.txt"), pose)
  return root


@pytest.mark.parametrize("split,white", [("train", True), ("test", False)])
def test_nsvf_loader_matches_jax(tmp_path, split, white):
  root = _nsvf_scene(str(tmp_path / "nsvf"))
  args = helpers.tiny_args(data_dir=root, dataset="nsvf", factor=0,
                           white_bkgd=white, batching="single_image")
  j_ds = _NoThreadNSVF(split, args)
  rays, images = t_datasets.load_split(args, split)
  assert images.shape == ((3,) if split == "train" else (2,)) + (16, 20, 3)
  np.testing.assert_array_equal(images.reshape(j_ds.images.shape),
                                j_ds.images)
  for got, want in zip(rays, j_ds.rays):
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.reshape(want.shape), want)


def test_llff_batches_match_next_train(llff):
  spherify, root = llff
  args = _llff_args(root, spherify, batching="single_image")
  j_ds = _NoThreadLLFF("train", args)
  t_ds = t_datasets.TrainBatches(args, np.random.RandomState(3))
  np.random.seed(3)
  for _ in range(3):
    want, got = j_ds._next_train(), next(t_ds)
    np.testing.assert_array_equal(got["pixels"], want["pixels"])
    for name in ("rays", "env_rays"):
      for g, w in zip(got[name], want[name]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dataset", ["blender", "nsvf", "opencv"])
def test_render_path_refused_with_the_jax_message(dataset, tmp_path):
  args = helpers.tiny_args(data_dir=str(tmp_path), dataset=dataset,
                           render_path=True, factor=0)
  cls = {"blender": j_datasets.Blender, "nsvf": j_datasets.NSVF,
         "opencv": j_datasets.OpenCV}[dataset]
  with pytest.raises(ValueError) as want:
    cls("test", args)
  with pytest.raises(ValueError) as got:
    t_datasets.load_render_path(args)
  assert str(got.value) == str(want.value)
  with pytest.raises(ValueError, match="render_path cannot be used"):
    t_datasets.load_split(args, "train")


def test_llff_trains_and_renders_its_path_on_cpu(tmp_path, monkeypatch):
  """`train` on an LLFF capture (NDC rays, a val render), then `eval
  --render_path`: one image set a frame of the spiral in path_renders/,
  no score; then eval of the test views, scored. The spiral is cut to 4
  of its 120 frames here (the loader tests hold all 120)."""
  spiral = t_pose_paths.spiral_path
  monkeypatch.setattr(t_pose_paths, "spiral_path",
                      lambda poses, bds: spiral(poses, bds, frames=4))
  root = llff_scene.write_scene(str(tmp_path / "scene"), views=6, width=16,
                                height=12, factor=0, grid_n=8)
  cfg = fixtures.write_tiny_config(str(tmp_path / "cfg"))
  common = [f"--data_dir={root}", f"--train_dir={tmp_path / 'logs'}",
            f"--config={cfg}", f"--gin_file={cfg}.gin", "--device=cpu",
            "--dataset=llff", "--near=0.0", "--far=1.0", "--llffhold=3",
            "--gin_param=Config.radiance_weight_name='radiance'"]
  t_loop.main(common + ["--stage=radiance", "--max_steps=2",
                        "--save_every=2", "--render_every=2"])
  res = t_eval.main(common + ["--render_path=True", "--chunk=192"])
  out = tmp_path / "logs" / "radiance" / "path_renders"
  names = sorted(os.listdir(out))
  assert len(names) == 4 * 5 and "003.png" in names
  assert not any(n.endswith(".txt") for n in names)
  assert res.psnrs == [] and res.step == 2
  assert np.asarray(Image.open(out / "000.png")).shape == (12, 16, 3)
  res = t_eval.main(common + ["--chunk=192"])
  assert len(res.psnrs) == 2 and all(np.isfinite(res.psnrs))
  args, _, _ = t_config.load_args(cfg, [cfg + ".gin"], dataset="llff")
  assert args.dataset == "llff"
