"""The port's tools against the JAX package's, on the same numpy inputs.

objio (a round trip and example_data/mesh.obj), sdfcore's SDF binding
(the same source and flags in both packages, so containment and distance
are exact), marching tetrahedra (identical vertices and faces), the
voxelizer's two entry points on a copy of example_data (the grid exactly
equal, the preview named alike), the depth-image suite (1e-5: both sum the
same fp32 products of a 3x3 convolution, in other orders) with the turbo
table held against matplotlib's, and the synthetic exact-ground-truth
scene (mesh.pkl exact, every PNG within one level of 255: both march the
same fp32 ODE, in other frameworks).
"""

import os
import pickle
import shutil
import subprocess
import sys

import matplotlib
import numpy as np
import pytest
import torch
from PIL import Image

from samplenerfro_torch import voxelize_mesh as t_voxelize
from samplenerfro_torch.tools import isosurface as t_iso
from samplenerfro_torch.tools import objio as t_objio
from samplenerfro_torch.tools import sdf as t_sdf
from samplenerfro_torch.tools import synth as t_synth
from samplenerfro_torch.utils import turbo_table
from samplenerfro_torch.utils import vis as t_vis
from samplenerfro_tpu.tools import isosurface as j_iso
from samplenerfro_tpu.tools import objio as j_objio
from samplenerfro_tpu.tools import sdf as j_sdf
from samplenerfro_tpu.tools import synth as j_synth
from samplenerfro_tpu.utils import vis as j_vis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = os.path.join(REPO, "example_data", "mesh.obj")
VIS_ATOL = 1e-5


def test_objio_round_trip_and_load_match_jax(tmp_path):
  v = np.random.RandomState(0).rand(7, 3)
  f = np.array([[0, 1, 2], [2, 3, 4], [4, 5, 6]])
  pth = str(tmp_path / "m.obj")
  t_objio.save_obj(pth, v, f)
  got_v, got_f = t_objio.load_obj(pth)
  np.testing.assert_array_equal(got_v, v)
  np.testing.assert_array_equal(got_f, f)
  assert got_v.dtype == np.float64 and got_f.dtype == np.int64
  # Polygon faces fan out; negative indices count from the end.
  (tmp_path / "q.obj").write_text(
      "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1/1 2/2 3/3 4/4\nf -1 -2 -3\n")
  assert t_objio.load_obj(str(tmp_path / "q.obj"))[1].tolist() == [
      [0, 1, 2], [0, 2, 3], [3, 2, 1]]
  got, want = t_objio.load(MESH), j_objio.load(MESH)
  np.testing.assert_array_equal(got.vertices, want.vertices)
  np.testing.assert_array_equal(got.faces, want.faces)
  np.testing.assert_array_equal(got.bounds, want.bounds)
  np.testing.assert_array_equal(got.extents, want.extents)
  got.export(str(tmp_path / "t.obj"))
  want.export(str(tmp_path / "j.obj"))
  assert (tmp_path / "t.obj").read_bytes() == (tmp_path / "j.obj").read_bytes()


def test_sdf_matches_jax_binding():
  mesh = t_objio.load(MESH)
  pts = np.random.RandomState(3).uniform(-1.3, 1.3, (4096, 3))
  got, want = t_sdf.SDF(mesh.vertices, mesh.faces), j_sdf.SDF(
      mesh.vertices, mesh.faces)
  inside = got.contains(pts)
  np.testing.assert_array_equal(inside, want.contains(pts))
  assert 0.2 < inside.mean() < 0.8
  np.testing.assert_array_equal(got.calc(pts), want.calc(pts))
  np.testing.assert_array_equal(np.sign(got.calc(pts)) > 0, inside)
  np.testing.assert_array_equal(got.nn(pts), want.nn(pts))
  np.testing.assert_array_equal(got.aabb, want.aabb)
  np.testing.assert_array_equal(got.face_normals, want.face_normals)
  np.testing.assert_array_equal(got.sample_surface(64),
                                want.sample_surface(64))


def test_sdf_builds_into_build_dir_and_a_failed_build_raises(tmp_path,
                                                             monkeypatch):
  lib = t_sdf.library_path()
  assert lib.parent == t_sdf.BUILD_DIR
  assert t_sdf.BUILD_DIR.parts[-2:] == ("build", "sdfcore")
  t_sdf.SDF(*t_objio.load_obj(MESH))
  assert lib.exists()
  bad = tmp_path / "sdfcore.cpp"
  bad.write_text("this is not C++\n")
  monkeypatch.setattr(t_sdf, "SRC", bad)
  monkeypatch.setattr(t_sdf, "BUILD_DIR", tmp_path / "b")
  monkeypatch.setattr(t_sdf, "_lib", None)
  with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
    t_sdf.SDF(*t_objio.load_obj(MESH))


@pytest.mark.parametrize("kind", ["seeded", "empty", "sphere"])
def test_marching_tetrahedra_matches_jax(kind):
  rng = np.random.RandomState(5)
  if kind == "seeded":
    vol, iso = rng.rand(20, 20, 20), 0.5
  elif kind == "empty":
    vol, iso = np.zeros((20, 20, 20)), 0.5
  else:
    a = np.linspace(-1, 1, 20)
    vol = np.sqrt(a[:, None, None]**2 + a[None, :, None]**2
                  + a[None, None, :]**2)
    iso = 0.7
  got_v, got_f = t_iso.marching_cubes(vol, iso)
  want_v, want_f = j_iso.marching_cubes(vol, iso)
  np.testing.assert_array_equal(got_v, want_v)
  np.testing.assert_array_equal(got_f, want_f)
  assert (len(got_f) == 0) == (kind == "empty")


def _voxelize_flags(data_dir):
  return [f"--data_dir={data_dir}", "--num_voxels=16", "--num_samples=2",
          "--extent=1.5", "--threshold=1.165"]


def test_voxelize_mesh_matches_jax_entry_point(tmp_path):
  for name in ("t", "j"):
    os.makedirs(tmp_path / name)
    shutil.copy(MESH, tmp_path / name / "mesh.obj")
  t_voxelize.main(_voxelize_flags(tmp_path / "t"))
  env = dict(os.environ, JAX_PLATFORMS="cpu")
  subprocess.run([sys.executable, os.path.join(REPO, "voxelize_mesh.py")]
                 + _voxelize_flags(tmp_path / "j"), check=True, env=env,
                 cwd=REPO, capture_output=True)
  out = {}
  for name in ("t", "j"):
    vdir = tmp_path / name / "voxelize"
    with open(vdir / "mesh.pkl", "rb") as f:
      out[name] = (pickle.load(f), sorted(os.listdir(vdir)))
  got, want = out["t"][0], out["j"][0]
  assert got.keys() == want.keys()
  assert got["data"].dtype == np.float64 and got["data"].shape == (16**3, 1)
  np.testing.assert_array_equal(got["data"], want["data"])
  for k in ("extent", "min_point", "max_point", "num_voxels"):
    assert got[k] == want[k], k
  assert out["t"][1] == out["j"][1] == ["mesh.pkl", "mesh_2_16_1.5_1.165.obj"]
  assert ((tmp_path / "t" / "voxelize" / out["t"][1][1]).read_bytes()
          == (tmp_path / "j" / "voxelize" / out["j"][1][1]).read_bytes())
  assert set(np.unique(got["data"])) > {1.0, 1.33}


def test_turbo_table_matches_matplotlib():
  cmap = matplotlib.colormaps["turbo"]
  table = np.asarray(turbo_table.TURBO)
  assert table.shape == (256, 3)
  np.testing.assert_array_equal(table, cmap(np.arange(256))[:, :3])
  x = np.concatenate([np.linspace(0, 1, 1001), [1 / 256 - 1e-7, 1 / 256,
                                                0.5 - 1e-7, 255 / 256, 1.0]])
  x = x.astype(np.float32)
  np.testing.assert_array_equal(t_vis.turbo(torch.from_numpy(x)).numpy(),
                                cmap(x)[:, :3].astype(np.float32))


def _depth_and_acc():
  """An asymmetric ramp (so a flipped convolution kernel changes the
  normals' signs), a NaN, and acc < 1 in places."""
  rng = np.random.RandomState(0)
  yy, xx = np.mgrid[0:24, 0:31]
  depth = (2.0 + 0.07 * xx + 0.013 * yy**1.5
           + 0.01 * rng.rand(24, 31)).astype(np.float32)
  acc = np.clip(rng.rand(24, 31) * 1.3, 0, 1).astype(np.float32)
  return depth, acc


def test_vis_suite_matches_jax():
  depth, acc = _depth_and_acc()
  got = t_vis.visualize_suite(depth, acc)
  want = j_vis.visualize_suite(depth, acc)
  assert sorted(got) == sorted(want) == ["depth", "depth_mod",
                                         "depth_normals"]
  for k in want:
    np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                               atol=VIS_ATOL, rtol=0, err_msg=k)
  np.testing.assert_allclose(
      t_vis.depth_to_normals(torch.from_numpy(depth)).numpy(),
      np.asarray(j_vis.depth_to_normals(depth)), atol=VIS_ATOL, rtol=0)
  nan = depth.copy()
  nan[3, 4] = np.nan
  for fn in (lambda v, d: v.visualize_depth(d, acc),
             lambda v, d: v.visualize_depth(d, acc, near=0.0, far=9.0),
             lambda v, d: v.visualize_depth(d, None, ignore_frac=0.1)):
    np.testing.assert_allclose(fn(t_vis, nan).numpy(),
                               np.asarray(fn(j_vis, nan)), atol=VIS_ATOL,
                               rtol=0)


def test_vis_convolution_is_a_true_convolution():
  """dx is the depth's slope along columns, with the JAX sign."""
  depth = torch.arange(8.0)[None, :].repeat(6, 1)
  normals = t_vis.depth_to_normals(depth)
  inner = normals[2:-2, 2:-2]
  assert torch.all(inner[..., 0] < 0) and torch.allclose(
      inner[..., 1], torch.zeros(()))


def test_synth_scene_matches_jax(tmp_path):
  kw = dict(n_train=1, n_val=1, n_test=1, res=8, grid_n=16, num_samples=64)
  j_synth.make_scene(str(tmp_path / "j"), **kw)
  t_synth.make_scene(str(tmp_path / "t"), device="cpu", **kw)
  for rel in ("transforms_train.json", "transforms_val.json",
              "transforms_test.json"):
    assert (tmp_path / "t" / rel).read_text() == (
        tmp_path / "j" / rel).read_text()
  with open(tmp_path / "t" / "voxelize" / "mesh.pkl", "rb") as f:
    got = pickle.load(f)
  with open(tmp_path / "j" / "voxelize" / "mesh.pkl", "rb") as f:
    want = pickle.load(f)
  assert got.keys() == want.keys()
  np.testing.assert_array_equal(got["data"], want["data"])
  assert got["data"].dtype == want["data"].dtype == np.float64
  for k in ("extent", "min_point", "max_point", "num_voxels"):
    assert got[k] == want[k]
  for i in range(3):
    a, b = (np.asarray(Image.open(tmp_path / d / "imgs" / f"r_{i}.png"),
                       np.int32) for d in ("t", "j"))
    assert a.shape == b.shape == (8, 8, 4)
    assert np.abs(a - b).max() <= 1
  np.testing.assert_allclose(
      t_synth.envmap(torch.from_numpy(np.eye(3, dtype=np.float32))).numpy(),
      np.asarray(j_synth.envmap(np.eye(3, dtype=np.float32))), atol=1e-6)


TINY_QUALITY_YAML = """\
dataset: blender
batching: {batching}
factor: 0
batch_size: {batch_size}
num_coarse_samples: 8
num_fine_samples: 16
num_path_samples: 2
use_viewdirs: true
white_bkgd: false
use_pixel_centers: true
randomized: true
max_steps: {steps}
lr_delay_steps: 0
render_every: 0
save_every: {steps}
print_every: 1
sh_deg: -1
sh_direnc_deg: -1
sparsity_weight: 0.0
use_online_sparsity: false
extra_batch_size: 16
bg_weight: 0.025
bg_smooth_weight: 1.0
bg_patch_size: 4
anneal_delay_steps: 1
anneal_max_steps: {anneal_max}
net_depth: 2
net_width: 32
net_width_condition: 16
chunk: 64
tile_size: 4
"""


@pytest.mark.parametrize("batching", ["single_image", "tile"])
def test_validate_quality_trains_scores_and_seeds_the_all_stage(
    tmp_path, monkeypatch, batching):
  """validate_quality on a tiny scene with a tiny config: the radiance
  stage is trained and scored, the `all` stage resumes from its
  checkpoint (the shared groups' Adam state carried over, the path
  sampler's fresh), and a finished radiance stage is reused."""
  from samplenerfro_torch.tools import validate_quality as vq
  monkeypatch.setattr(vq, "CONFIG_YAML", TINY_QUALITY_YAML)
  t_synth.make_scene(str(tmp_path / "scene"), n_train=2, n_val=1, n_test=1,
                     res=16, grid_n=16, num_samples=16, device="cpu")
  flags = ["--steps=2", "--batch_size=32", f"--batching={batching}",
           f"--workdir={tmp_path}", "--device=cpu", "--all_steps=1"]
  res = vq.main(flags)
  assert sorted(res) == [vq.ALL_STAGE, vq.RADIANCE_STAGE]
  assert all(np.isfinite(r["psnr"]) and 0 < r["ssim"] <= 1
             for r in res.values())
  logs = tmp_path / f"logs_{batching}_b32"
  rad = torch.load(logs / vq.RADIANCE_STAGE / "checkpoint_2",
                   weights_only=True)["optimizer"]
  allst = torch.load(logs / vq.ALL_STAGE / "checkpoint_3",
                     weights_only=True)["optimizer"]
  names = lambda o: [g["name"] for g in o["param_groups"]]
  assert names(rad) == ["bkgd_mlp", "coarse_mlp", "fine_mlp"]
  assert names(allst) == ["path_sampler", "bkgd_mlp", "coarse_mlp",
                          "fine_mlp"]
  steps = {g["name"]: {int(allst["state"][i]["step"]) for i in g["params"]}
           for g in allst["param_groups"]}
  assert steps == {"path_sampler": {1}, "bkgd_mlp": {3}, "coarse_mlp": {3},
                   "fine_mlp": {3}}
  again = vq.main(flags[:-1])
  assert again[vq.RADIANCE_STAGE]["train_s"] is None
  assert again[vq.RADIANCE_STAGE]["psnr"] == pytest.approx(
      res[vq.RADIANCE_STAGE]["psnr"])
