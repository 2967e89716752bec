"""The port reads the JAX package's checkpoints without flax, orbax,
msgpack, tensorstore or zstandard, and carries a JAX TrainState into its
model and Adam.

Every comparison of what is read is exact (dtype and bytes): decoding
loses nothing. The resumed train steps are held at the tolerances of
tests/test_torch_train.py (gradient-scale atol 1e-4 on the first moment,
2e-4 on the second, which carries the squared gradient and so twice its
relative error; parameters at 2 * lr of the step); counts and learning
rates are equal.

Run as a script, the file rewrites the committed fixture
samplenerfro_torch/debug/fixtures/flax_ckpt/ with the JAX package:

    JAX_PLATFORMS=cpu python tests/test_torch_flax_ckpt.py
"""

import copy
import os
import shutil
import struct
import sys
import types

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import flax  # noqa: E402
import flax.serialization as fser  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import zstandard  # noqa: E402
from flax.training import checkpoints as flax_ckpt  # noqa: E402
from flax.training.train_state import TrainState  # noqa: E402
from jax import random  # noqa: E402

from samplenerfro_torch.debug import flax_fixture  # noqa: E402
from samplenerfro_torch.debug import march_parity  # noqa: E402
from samplenerfro_torch.models import convert  # noqa: E402
from samplenerfro_torch.models import nerf as t_nerf  # noqa: E402
from samplenerfro_torch.train import checkpoints as t_ckpt  # noqa: E402
from samplenerfro_torch.train import flax_checkpoints  # noqa: E402
from samplenerfro_torch.train import ocdbt  # noqa: E402
from samplenerfro_torch.train import step as t_step  # noqa: E402
from samplenerfro_torch.utils import config as t_config  # noqa: E402
from samplenerfro_torch.utils import flax_msgpack  # noqa: E402
from samplenerfro_torch.utils import grid_io  # noqa: E402
from samplenerfro_torch.utils import zstd  # noqa: E402
from samplenerfro_tpu.data.rays import Rays as JRays  # noqa: E402
from samplenerfro_tpu.models import construct_nerf  # noqa: E402
from samplenerfro_tpu.train import checkpoints as j_ckpt  # noqa: E402
from samplenerfro_tpu.train import step as j_step  # noqa: E402

SHIP = march_parity.SHIP


def _flax_bytes(tree):
  """flax's msgpack_serialize of a copy of `tree`, its keys in order (as
  to_bytes and the legacy save_checkpoint write them)."""
  return fser.msgpack_serialize(copy.deepcopy(tree), in_place=True)


def _save_legacy(fn, *args, **kwargs):
  was = flax.config.flax_use_orbax_checkpointing
  flax.config.update("flax_use_orbax_checkpointing", False)
  try:
    return fn(*args, **kwargs)
  finally:
    flax.config.update("flax_use_orbax_checkpointing", was)


def _assert_same(got, want, path=""):
  """Trees equal leaf for leaf: arrays in dtype, shape and bytes, Python
  scalars in type and value."""
  if isinstance(want, dict):
    assert isinstance(got, dict), path
    assert set(got) == set(want), (path, set(got) ^ set(want))
    for k in want:
      _assert_same(got[k], want[k], f"{path}/{k}")
  elif isinstance(want, (np.ndarray, np.generic, jax.Array)):
    w = np.asarray(want)
    bf16 = w.dtype.name == "bfloat16"
    assert isinstance(got, (np.ndarray, np.generic)), (path, type(got))
    assert type(got) is type(want) or bf16 or isinstance(want, jax.Array), (
        path, type(got), type(want))
    g = np.asarray(got)
    if bf16:
      assert isinstance(got, flax_msgpack.Bfloat16Bits), path
      w = w.view(np.uint16)
    assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype,
                                                       w.dtype)
    assert g.tobytes() == w.tobytes(), path
  else:
    assert type(got) is type(want) and got == want, (path, got, want)


def _optimizer_moments(optimizer, model):
  """The port's Adam state in convert.moments_from_flax's form."""
  names = {p: k for k, p in model.named_parameters()}
  out = {}
  for group, count in zip(optimizer.param_groups, optimizer.counts):
    out[group["name"]] = {
        "label": group["label"], "count": int(count),
        "schedule_count": (int(count) if group["label"] != "adam" else None),
        "exp_avg": {names[p]: optimizer.state[p]["exp_avg"]
                    for p in group["params"]},
        "exp_avg_sq": {names[p]: optimizer.state[p]["exp_avg_sq"]
                       for p in group["params"]}}
  return out


# ------------------------------------------------------ (a) msgpack codec

_DTYPES = ["float16", "float32", "float64", "bfloat16", "int8", "int16",
           "int32", "int64", "uint8", "uint16", "uint32", "uint64", "bool"]


def _array(dtype, shape, seed):
  rng = np.random.RandomState(seed)
  if dtype == "bfloat16":
    return np.asarray(jnp.asarray(rng.randn(*shape), jnp.bfloat16))
  if dtype == "bool":
    return np.asarray(rng.rand(*shape) > 0.5)
  dt = np.dtype(dtype)
  if dt.kind == "f":
    return np.asarray(rng.randn(*shape)).astype(dt)
  info = np.iinfo(dt)
  return rng.randint(max(info.min, -2**62), min(info.max, 2**62), shape,
                     dtype=np.int64).astype(dt)


@pytest.mark.parametrize("dtype", _DTYPES)
def test_msgpack_arrays_match_flax(dtype):
  tree = {"b": {"x": _array(dtype, (3, 5), 0), "empty": _array(dtype,
                                                               (0, 2), 1)},
          "a": _array(dtype, (), 2), "t": _array(dtype, (4, 3), 3).T,
          "s": _array(dtype, (2,), 4)[0]}
  want = _flax_bytes(tree)
  assert flax_msgpack.packb(tree) == want
  got = flax_msgpack.unpackb(want)
  _assert_same(got, fser.msgpack_restore(want))
  assert flax_msgpack.packb(got) == want
  # msgpack_serialize's default copy sorts the keys first.
  _assert_same(flax_msgpack.unpackb(fser.msgpack_serialize(tree)), got)


def test_msgpack_scalars_and_trees_match_flax():
  tree = {"z": None, "e": {}, "n": {"m": {"k": 1}},
          "ints": {str(i): v for i, v in enumerate(
              [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
               2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
               -2**31 - 1, -2**63])},
          "f": 1.25, "b": True, "c": 1 + 2j, "s": "hé", "long": "x" * 40000,
          "bin": b"\x00\x01", "np": {"f32": np.float32(2.5), "f64":
                                     np.float64(3.5), "i": np.int32(7),
                                     "t": np.bool_(True)},
          "many": {str(i): i for i in range(70000)}}
  want = _flax_bytes(tree)
  assert flax_msgpack.packb(tree) == want
  got = flax_msgpack.unpackb(want)
  _assert_same(got, fser.msgpack_restore(want))


def test_bfloat16_weights_convert_exactly():
  """A bfloat16 kernel read from msgpack (its bits) widens to the float32
  values ml_dtypes gives."""
  kernel = _array("bfloat16", (5, 3), 7)
  bias = _array("bfloat16", (3,), 8)
  tree = flax_msgpack.unpackb(_flax_bytes({"coarse_mlp": {"Dense_0": {
      "kernel": kernel, "bias": bias}}}))
  sd = convert.params_from_flax(tree)
  assert torch.equal(sd["coarse_mlp.layers.0.weight"],
                     torch.from_numpy(kernel.astype(np.float32).T.copy()))
  assert torch.equal(sd["coarse_mlp.layers.0.bias"],
                     torch.from_numpy(bias.astype(np.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "uint8"])
def test_msgpack_chunked_arrays_match_flax(monkeypatch, dtype):
  monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 40)
  tree = {"w": {"k": _array(dtype, (7, 9), 5)}, "small": _array(dtype,
                                                                (3,), 6)}
  want = _flax_bytes(tree)
  assert b"__msgpack_chunked_array__" in want
  assert flax_msgpack.packb(tree, max_chunk_size=40) == want
  _assert_same(flax_msgpack.unpackb(want), fser.msgpack_restore(want))


# ------------------------------------------------------------- zstd frames


def test_zstd_frames_follow_the_rfc():
  data = np.random.RandomState(0).bytes(5000) + b"a" * 70000
  known = zstandard.ZstdCompressor(write_checksum=True).compress(data)
  unknown = zstandard.ZstdCompressor(write_content_size=False).compress(data)
  obj = zstandard.ZstdCompressor().compressobj()
  streamed = obj.compress(data) + obj.flush()
  skip = struct.pack("<II", 0x184D2A5A, 3) + b"xyz"
  assert zstd.decompress(known) == data
  assert zstd.decompress(unknown) == data
  assert zstd.decompress(streamed) == data
  assert zstd.decompress(skip + known + skip + unknown) == data + data
  assert zstd.decompress(b"") == b""
  bad = bytearray(known)
  bad[-1] ^= 1
  for broken in (known[:-5], bytes(bad), b"not a frame"):
    with pytest.raises(ValueError, match="zstd"):
      zstd.decompress(broken)


# ------------------------------------------------- JAX states on the disk


def _rays(n=32, seed=0):
  rng = np.random.RandomState(seed)
  d = rng.randn(n, 3).astype(np.float32)
  d /= np.linalg.norm(d, axis=-1, keepdims=True)
  o = np.broadcast_to(np.array([0.0, 0.0, -4.0], np.float32), d.shape)
  return JRays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(d),
               jnp.full((n, 1), 1e-3, jnp.float32))


def _jax_model(args, bindings, grid_n=16):
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(grid_n, 1.5, 0.33)
  jargs = types.SimpleNamespace(**{**vars(args), "march_mode": "scan"})
  model, variables = construct_nerf(random.PRNGKey(0), {"rays": _rays()},
                                    jargs, ndim, nmin, nmax, values,
                                    gin_overrides=bindings)
  return model, variables, jargs, (values, ndim, nmin, nmax)


def _updated_state(args, params, seed=0, updates=1):
  """TrainState of `params` after `updates` optax updates on seeded
  gradients (mu, nu and the counts non-trivial)."""
  tx, _, _ = j_step.create_optimizer(args)
  state = TrainState.create(apply_fn=None, params=params, tx=tx)
  rng = np.random.RandomState(seed)
  for _ in range(updates):
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.randn(*p.shape), p.dtype), state.params)
    state = state.apply_gradients(grads=grads)
  return jax.device_get(state)


@pytest.fixture(scope="module")
def ship_state(tmp_path_factory):
  """A ship-width radiance TrainState saved by the JAX package in both
  formats: (state, orbax dir, msgpack file)."""
  args, _, bindings = t_config.load_args(SHIP, [SHIP + ".gin"],
                                         stage="radiance")
  _, variables, jargs, _ = _jax_model(args, bindings)
  state = _updated_state(jargs, variables["params"])
  root = tmp_path_factory.mktemp("ship_state")
  j_ckpt.save_checkpoint(str(root / "orbax"), state, 1)
  _save_legacy(j_ckpt.save_checkpoint, str(root / "msgpack"), state, 1)
  return (state, str(root / "orbax" / "checkpoint_1"),
          str(root / "msgpack" / "checkpoint_1"))


# ------------------------------------------------ (b) orbax OCDBT + zarr


@pytest.mark.parametrize("fmt", ["orbax", "msgpack"])
def test_ship_width_state_reads_bit_for_bit(ship_state, fmt):
  state, orbax_dir, msgpack_file = ship_state
  path = orbax_dir if fmt == "orbax" else msgpack_file
  assert os.path.isdir(orbax_dir) and os.path.isfile(msgpack_file)
  want = flax_ckpt.restore_checkpoint(path, None)
  got = flax_checkpoints.restore(path)
  _assert_same(got, want)
  # The same through the stage directory (its newest checkpoint).
  _assert_same(flax_checkpoints.restore(os.path.dirname(path)), want)
  count = want["opt_state"]["inner_states"]["adam_lr_scheduler"][
      "inner_state"]["0"]["count"]
  assert int(count) == 1 and got["step"] == 1


def test_ocdbt_store_lists_every_zarr_key(ship_state):
  _, orbax_dir, _ = ship_state
  store = ocdbt.OcdbtStore(orbax_dir)
  keys = store.keys()
  assert "step/.zarray" in keys and "step/0" in keys
  arrays = {k.rsplit("/", 1)[0] for k in keys}
  assert len(keys) >= 2 * len(arrays)
  assert all(f"{a}/.zarray" in store for a in arrays)


@pytest.mark.parametrize("order,fill", [("C", 1.5), ("F", None),
                                         ("C", 0)])
def test_zarr_chunks_fill_values_and_order(tmp_path, order, fill):
  """Edge chunks, chunks never written (the fill value; zeros for a null
  one) and Fortran order, in a zarr v2 array tensorstore writes into an
  OCDBT database as orbax does."""
  import tensorstore as ts
  path = str(tmp_path / "db")
  meta = {"shape": [7, 5, 3], "chunks": [2, 2, 3], "dtype": "<f4",
          "order": order, "fill_value": fill,
          "compressor": {"id": "zstd", "level": 1}}
  arr = ts.open({"driver": "zarr", "kvstore": {
      "driver": "ocdbt", "base": f"file://{path}"}, "path": "a.b",
                 "metadata": meta}, create=True).result()
  rng = np.random.RandomState(0)
  arr[0:3, 1:4].write(rng.randn(3, 3, 3).astype(np.float32)).result()
  arr[6:7, 4:5].write(np.full((1, 1, 3), 2.0, np.float32)).result()
  want = arr.read().result()
  store = ocdbt.OcdbtStore(path)
  written = [k for k in store.keys() if not k.endswith(".zarray")]
  assert 0 < len(written) < 4 * 3  # some of the 12 chunks never written
  got = ocdbt.read_zarr(store, "a.b")
  assert got.dtype == want.dtype and got.shape == want.shape
  assert got.tobytes() == np.ascontiguousarray(want).tobytes()


# ------------------------------------------------------------ (g) fixture


def test_fixture_restores_to_its_leaves_through_jax():
  index, arrays = flax_fixture.read_index()
  for fmt in flax_fixture.FORMATS:
    want = flax_ckpt.restore_checkpoint(
        flax_fixture.checkpoint_path(fmt), None)
    assert flax_fixture.compare(fmt, want, index, arrays) == [], fmt
  assert os.path.isdir(flax_fixture.checkpoint_path("orbax"))
  for fmt in ("msgpack", "reference"):
    assert os.path.isfile(flax_fixture.checkpoint_path(fmt))


def test_fixture_restores_to_its_leaves_through_the_port():
  out = flax_fixture.check()
  assert out["leaves"] > 100 and set(out["seconds"]) == set(
      flax_fixture.FORMATS)
  ckpt = flax_checkpoints.restore(flax_fixture.checkpoint_path("reference"))
  assert flax_checkpoints.is_reference_layout(ckpt)
  state = flax_checkpoints.restore(flax_fixture.checkpoint_path("orbax"))
  assert state["step"] == flax_fixture.STEP


# ----------------------------------------------- (h) damaged checkpoints


def _damaged_copy(tmp_path, fmt):
  dst = str(tmp_path / fmt)
  src = flax_fixture.checkpoint_path(fmt)
  if os.path.isdir(src):
    shutil.copytree(src, dst)
  else:
    shutil.copy(src, dst)
  return dst


def _largest_data_file(root):
  files = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
           if os.sep + "d" + os.sep in os.path.join(d, f)]
  return max(files, key=os.path.getsize)


def _rewrite(path, fn):
  with open(path, "rb") as f:
    data = bytearray(f.read())
  with open(path, "wb") as f:
    f.write(fn(data))


def _with_crc(data):
  data[-4:] = struct.pack("<I", ocdbt.crc32c(bytes(data[:-4])))
  return data


def _version(data):
  data[12] = 1  # the format version varint after magic and length
  return _with_crc(data)


def _compression(data):
  data[13] = 7
  return _with_crc(data)


@pytest.mark.parametrize("case,match", [
    ("manifest_truncated", "length field"),
    ("manifest_flipped", "CRC-32C"),
    ("manifest_version", "unknown format version 1"),
    ("manifest_compression", "unknown compression format 7"),
    ("manifest_magic", "magic"),
    ("data_truncated", "truncated"),
    ("metadata_truncated", "_METADATA: not JSON"),
    ("msgpack_truncated", "msgpack data ends"),
    ("msgpack_trailing", "bytes after the msgpack object"),
])
def test_damaged_checkpoints_raise_naming_the_path(tmp_path, case, match):
  fmt = "msgpack" if case.startswith("msgpack") else "orbax"
  path = _damaged_copy(tmp_path, fmt)
  manifest = os.path.join(path, "manifest.ocdbt")
  if case == "manifest_truncated":
    _rewrite(manifest, lambda d: d[:-7])
  elif case == "manifest_flipped":
    _rewrite(manifest, lambda d: d[:20] + bytes([d[20] ^ 0x10]) + d[21:])
  elif case == "manifest_version":
    _rewrite(manifest, _version)
  elif case == "manifest_compression":
    _rewrite(manifest, _compression)
  elif case == "manifest_magic":
    _rewrite(manifest, lambda d: b"\x0c\xdb\x20\xde" + d[4:])
  elif case == "data_truncated":
    data = _largest_data_file(path)
    _rewrite(data, lambda d: d[:len(d) // 2])
  elif case == "metadata_truncated":
    _rewrite(os.path.join(path, "_METADATA"), lambda d: d[:len(d) // 2])
  elif case == "msgpack_truncated":
    _rewrite(path, lambda d: d[:len(d) - 100])
  elif case == "msgpack_trailing":
    _rewrite(path, lambda d: d + b"\x00")
  with pytest.raises(ValueError, match=match) as err:
    flax_checkpoints.restore(path)
  assert path in str(err.value)


def test_damaged_node_raises_naming_the_node(tmp_path):
  path = _damaged_copy(tmp_path, "orbax")
  root = os.path.join(path, "d")
  node = os.path.join(root, os.listdir(root)[0])
  _rewrite(node, _version)
  with pytest.raises(ValueError, match="unknown format version 1") as err:
    flax_checkpoints.restore(path)
  assert node in str(err.value)


def test_ocdbt_interior_nodes_and_many_versions(tmp_path):
  """A tree deep enough for interior nodes (keys stored below their
  subtree's common prefix), indirect values, more commits than the
  manifest holds inline, an overwrite and a deleted range, as tensorstore
  writes them."""
  import tensorstore as ts
  path = str(tmp_path / "db")
  kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}",
                        "config": {"max_decoded_node_bytes": 512,
                                   "max_inline_value_bytes": 16}}).result()
  rng = np.random.RandomState(0)
  for i in range(40):
    kv.write(f"key/{i:04d}/{'x' * rng.randint(1, 30)}",
             rng.bytes(rng.randint(0, 60))).result()
  txn = ts.Transaction()
  for i in range(400):
    kv.with_transaction(txn).write(f"b/{rng.randint(10**9)}",
                                   rng.bytes(rng.randint(0, 40))).result()
  txn.commit_async().result()
  kv.write("key/0000/x", b"overwritten").result()
  kv.delete_range(ts.KvStore.KeyRange("key/0010", "key/0015")).result()
  store = ocdbt.OcdbtStore(path)
  want = sorted(k.decode() for k in kv.list().result())
  assert store.keys() == want and len(want) > 400
  assert all(store.get(k) == kv.read(k).result().value for k in want)


# --------------------------------------- (c) stage surgery from JAX dirs


def _tiny_jax(args, grid_n=16):
  values, ndim, nmin, nmax = grid_io.synthetic_blob_grid(grid_n, 1.5, 0.33)
  model, variables = construct_nerf(
      random.PRNGKey(0), {"rays": _rays()}, args, ndim, nmin, nmax, values)
  variables = jax.device_get(variables)
  port = t_nerf.construct_nerf(args, ndim, nmin, nmax, values, device="cpu")
  convert.load_into(port, convert.params_from_flax(variables["params"]))
  return model, variables, port


def _bumped(params, by):
  return jax.tree_util.tree_map(lambda x: np.asarray(x) + np.float32(by),
                                params)


def _write(fmt, stage_dir, params, step, args):
  if fmt == "reference":
    _save_legacy(j_ckpt.export_reference_checkpoint, stage_dir, params, step)
    return
  state = _updated_state(args, params)
  state = state.replace(step=step)
  if fmt == "orbax":
    j_ckpt.save_checkpoint(stage_dir, state, step)
  else:
    _save_legacy(j_ckpt.save_checkpoint, stage_dir, state, step)


@pytest.fixture(scope="module")
def jax_stage_dirs(tmp_path_factory):
  """<train_dir>/<fmt>/{rad,ior,all}: JAX-written stage directories of
  the tiny model, each with its own weights and step, and an older
  checkpoint below the newest."""
  import tests.helpers as helpers
  args = helpers.tiny_args(stage="all")
  _, variables, _ = _tiny_jax(args)
  root = tmp_path_factory.mktemp("jax_stages")
  for fmt in ("orbax", "msgpack", "reference"):
    for i, name in enumerate(("rad", "ior", "all")):
      stage_dir = str(root / fmt / name)
      _write(fmt, stage_dir, _bumped(variables["params"], 10.0), 2, args)
      _write(fmt, stage_dir, _bumped(variables["params"], i + 1.0),
             11 + i, args)
  return args, variables, root


@pytest.mark.parametrize("fmt", ["orbax", "msgpack", "reference"])
@pytest.mark.parametrize("stage", ["radiance_x", "ior_x", "all_x"])
def test_load_stage_weights_matches_load_stage_variables(jax_stage_dirs,
                                                         fmt, stage):
  from samplenerfro_tpu.utils import config as j_config
  args, variables, root = jax_stage_dirs
  cfg = j_config.Config(radiance_weight_name="rad", ior_weight_name="ior",
                        all_weight_name="all")
  merged, want_step = j_ckpt.load_stage_variables(
      dict(variables), str(root / fmt), cfg, stage, args.num_fine_samples)
  want = convert.params_from_flax(jax.device_get(merged["params"]))
  _, _, port = _tiny_jax(args)
  step = t_ckpt.load_stage_weights(port, str(root / fmt), cfg, stage)
  assert step == want_step == {"radiance_x": 11, "ior_x": 12,
                               "all_x": 13}[stage]
  got = {k: v for k, v in port.state_dict().items()
         if k != "path_sampler.grid"}
  assert set(got) == set(want)
  for k, w in want.items():
    assert got[k].dtype == w.dtype and torch.equal(got[k], w), k


# ------------------------------------------------- (d) reference export


def test_export_reference_checkpoint_reads_back_in_jax(tmp_path):
  import tests.helpers as helpers
  from samplenerfro_tpu.utils import config as j_config
  args = helpers.tiny_args(stage="all")
  _, variables, port = _tiny_jax(args)
  params = convert.params_to_flax(port)
  out = str(tmp_path / "all")
  for step in (5, 7):
    path = flax_checkpoints.export_reference_checkpoint(out, params, step,
                                                        keep=1)
  assert sorted(os.listdir(out)) == ["checkpoint_7"] and os.path.isfile(path)
  ckpt = flax_ckpt.restore_checkpoint(out, None)
  assert j_ckpt.is_reference_layout(ckpt)
  assert flax_checkpoints.is_reference_layout(ckpt)
  step, converted = j_ckpt.convert_reference_checkpoint(ckpt)
  assert step == 7
  want = {k: v for k, v in port.state_dict().items()
          if k != "path_sampler.grid"}
  got = convert.params_from_flax(converted)
  assert set(got) == set(want)
  assert all(torch.equal(got[k], want[k]) for k in want)
  # The JAX package's own export of the same params, written as the
  # original code's msgpack, holds the same bytes.
  j_out = str(tmp_path / "j")
  _save_legacy(j_ckpt.export_reference_checkpoint, j_out, params, 7)
  with open(path, "rb") as f, open(os.path.join(j_out, "checkpoint_7"),
                                   "rb") as g:
    assert f.read() == g.read()
  # And the JAX stage surgery reads it.
  cfg = j_config.Config(all_weight_name="all")
  merged, step = j_ckpt.load_stage_variables(
      dict(variables), str(tmp_path), cfg, "all", args.num_fine_samples)
  assert step == 7
  np.testing.assert_array_equal(
      merged["params"]["path_sampler"]["so3_mlp"]["Dense_out"]["kernel"],
      params["path_sampler"]["so3_mlp"]["Dense_out"]["kernel"])


def test_save_checkpoint_prunes_orbax_directories(tmp_path):
  import tests.helpers as helpers
  args = helpers.tiny_args(stage="radiance")
  _, variables, port = _tiny_jax(args)
  stage_dir = str(tmp_path / "radiance")
  for step in (1, 2):
    _write("orbax", stage_dir, variables["params"], step, args)
  optimizer, _, _ = t_step.create_optimizer(port, args)
  t_ckpt.save_checkpoint(stage_dir, port, optimizer, 3, keep=2)
  assert sorted(os.listdir(stage_dir)) == ["checkpoint_2", "checkpoint_3"]
  assert os.path.isdir(os.path.join(stage_dir, "checkpoint_2"))
  assert t_ckpt.checkpoint_kind(os.path.join(stage_dir,
                                             "checkpoint_3")) == "torch"
  t_ckpt.save_checkpoint(stage_dir, port, optimizer, 4, keep=1)
  assert os.listdir(stage_dir) == ["checkpoint_4"]


# ---------------------------------------------------- (e) resume parity


def _moment_tol(name, want):
  scale = max(float(np.abs(want).max()), 1e-12)
  return (1e-4 if name == "mu" else 2e-4) * scale


@pytest.mark.parametrize("stage,steps", [("radiance", 3), ("all", 1)])
def test_resumed_jax_state_steps_as_jax_does(tmp_path, stage, steps):
  import tests.test_torch_train as tt
  args = tt._args(stage, "scan")
  model, variables, port, b = tt._setup(args)
  tx, lr_fn, _ = j_step.create_optimizer(args)
  state = TrainState.create(apply_fn=model.apply, params=variables["params"],
                            tx=tx)
  tstep = j_step.make_train_step(model, args, {"grid": variables["grid"]},
                                 donate=False)
  jbatch = tt._jax_batch(b)
  rng = random.PRNGKey(3)
  for _ in range(steps):
    state, _, rng = tstep(rng, state, jbatch)
  stage_dir = str(tmp_path / stage)
  j_ckpt.save_checkpoint(stage_dir, state, steps)

  optimizer, _, _ = t_step.create_optimizer(port, args)
  assert t_ckpt.restore_checkpoint(stage_dir, port, optimizer) == steps
  assert [int(c) for c in optimizer.counts] == [steps] * len(
      optimizer.param_groups)
  saved = jax.device_get(state)
  got = {k: v for k, v in port.state_dict().items()
         if k != "path_sampler.grid"}
  want = convert.params_from_flax(saved.params)
  assert all(torch.equal(got[k], want[k]) for k in want)
  opt_state = flax_ckpt.restore_checkpoint(stage_dir, None)["opt_state"]
  moments = _optimizer_moments(optimizer, port)
  back = convert.optimizer_state_to_flax(moments)
  for label, inner in back["inner_states"].items():
    ref = opt_state["inner_states"][label]["inner_state"]
    assert int(inner["inner_state"]["0"]["count"]) == int(ref["0"]["count"])
    assert int(inner["inner_state"]["1"]["count"]) == int(ref["1"]["count"])
    for key in ("mu", "nu"):
      for module, tree in inner["inner_state"]["0"][key].items():
        _assert_same(tree, ref["0"][key][module], f"{label}/{key}/{module}")
  assert convert.optimizer_state_from_flax(
      opt_state, stage, args.num_fine_samples).keys() == moments.keys()
  # The rates of the next update: optax's schedule reads its count, the
  # port the step it resumes from.
  lrs = t_step.learning_rates(optimizer, steps)
  assert lrs == [lr_fn(steps)] * len(lrs)
  count = int(opt_state["inner_states"]["adam_lr_scheduler"]["inner_state"][
      "1"]["count"])
  assert lr_fn(count) == lrs[0]

  state1, _, _ = tstep(rng, state, jbatch)
  t_step.train_step(port, optimizer, tt._step_batch(
      b, args, optimizer, steps, tt._jitter(rng, args)), args)
  assert [int(c) for c in optimizer.counts] == [steps + 1] * len(
      optimizer.param_groups)
  want = convert.params_from_flax(jax.device_get(state1.params))
  got = {k: v.detach() for k, v in port.named_parameters()}
  tt._assert_close_tree({k: v.numpy() for k, v in got.items()},
                        {k: v.numpy() for k, v in want.items()},
                        lambda _: 2 * lr_fn(steps), "param")
  moments = _optimizer_moments(optimizer, port)
  ref = jax.device_get(state1.opt_state.inner_states[
      "adam_lr_scheduler"].inner_state[0])
  assert int(ref.count) == steps + 1
  for key, name in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
    tree = {m: v for m, v in getattr(ref, key).items()
            if isinstance(v, dict)}
    want = convert.params_from_flax(tree)
    got = {k: v for m in moments.values() for k, v in m[name].items()}
    assert set(got) == set(want)
    tt._assert_close_tree({k: v.numpy() for k, v in got.items()},
                          {k: v.numpy() for k, v in want.items()},
                          lambda w, key=key: _moment_tol(key, w), key)


# ------------------------------------- (f) the entry points on JAX dirs


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
  from tests import fixtures
  root = tmp_path_factory.mktemp("flax_scene")
  return fixtures.make_scene(str(root / "scene"), num_train=2, num_test=1,
                             res=16, grid_n=12)


def _jax_stage_of(model, args, stage_dir, step):
  """A JAX TrainState at `step` with the port model's weights and the Adam
  state of `step` optax updates, saved by the JAX package into
  stage_dir."""
  params = convert.params_to_flax(model)
  state = _updated_state(args, params, updates=step).replace(params=params)
  j_ckpt.save_checkpoint(stage_dir, state, step)
  return state


def test_train_resumes_a_jax_stage_directory(scene, tmp_path, capsys):
  from samplenerfro_torch import eval as t_eval
  from samplenerfro_torch.train import loop as t_loop
  from tests import fixtures
  cfg = fixtures.write_tiny_config(str(tmp_path / "cfg"))
  args, gcfg, bindings = t_config.load_args(cfg, [cfg + ".gin"],
                                            stage="radiance", max_steps=4)
  model = t_eval.build_model(args, gcfg, bindings, scene, "cpu", seed=1)
  stage_dir = str(tmp_path / "out" / "radiance")
  state = _jax_stage_of(model, args, stage_dir, 2)
  common = [f"--data_dir={scene}", f"--train_dir={tmp_path / 'out'}",
            f"--config={cfg}", f"--gin_file={cfg}.gin", "--device=cpu",
            "--stage=radiance", "--save_every=2", "--print_every=1"]
  capsys.readouterr()
  resumed = t_loop.main(common + ["--max_steps=4"])
  lines = [ln for ln in capsys.readouterr().out.splitlines()
           if "/4: i_loss" in ln]
  assert [ln.split("/")[0].strip() for ln in lines] == ["3", "4"]
  assert sorted(os.listdir(stage_dir)) == ["checkpoint_2", "checkpoint_4"]
  assert os.path.isdir(os.path.join(stage_dir, "checkpoint_2"))
  saved = torch.load(os.path.join(stage_dir, "checkpoint_4"),
                     weights_only=True)
  assert saved["step"] == 4
  assert {int(s["step"]) for s in saved["optimizer"]["state"].values()} == {
      4}
  # The resumed run started from the JAX state's weights and Adam state.
  fresh = t_eval.build_model(args, gcfg, bindings, scene, "cpu", seed=1)
  optimizer, _, _ = t_step.create_optimizer(fresh, args)
  assert t_ckpt.restore_checkpoint(stage_dir, fresh, optimizer) == 4
  assert not torch.equal(fresh.coarse_mlp.layers[0].weight,
                         model.coarse_mlp.layers[0].weight)
  assert torch.equal(fresh.coarse_mlp.layers[0].weight,
                     resumed.coarse_mlp.layers[0].weight)
  del state
  t_ckpt.save_checkpoint(stage_dir, fresh, optimizer, 5, keep=1)
  assert os.listdir(stage_dir) == ["checkpoint_5"]


def test_eval_and_extract_render_from_a_jax_stage_directory(scene,
                                                            tmp_path):
  """eval and extract_mesh read the JAX package's stage directory (an
  orbax TrainState, and the reference-layout msgpack export) and give
  what they give from the port's own checkpoint of the same weights."""
  from samplenerfro_torch import eval as t_eval
  from samplenerfro_torch import extract_mesh as t_extract
  from tests import fixtures
  cfg = fixtures.write_tiny_config(str(tmp_path / "cfg"))
  args, gcfg, bindings = t_config.load_args(cfg, [cfg + ".gin"],
                                            stage="radiance")
  model = t_eval.build_model(args, gcfg, bindings, scene, "cpu", seed=4)
  _jax_stage_of(model, args, str(tmp_path / "jax" / "rad_w"), 3)
  _save_legacy(j_ckpt.export_reference_checkpoint,
               str(tmp_path / "ref" / "rad_w"),
               convert.params_to_flax(model), 3)
  optimizer, _, _ = t_step.create_optimizer(model, args)
  t_ckpt.save_checkpoint(str(tmp_path / "port" / "rad_w"), model,
                         optimizer, 3)
  common = [f"--data_dir={scene}", f"--config={cfg}",
            f"--gin_file={cfg}.gin", "--device=cpu", "--stage=radiance",
            "--gin_param=Config.radiance_weight_name='rad_w'"]
  results, meshes = {}, {}
  for kind in ("port", "jax", "ref"):
    out = [f"--train_dir={tmp_path / kind}"]
    results[kind] = t_eval.main(common + out + ["--chunk=256"])
    got = t_extract.main(common + out + ["--resolution=8", "--img_idx=1",
                                         "--pixel=3", "--pixel=4",
                                         "--threshold=0.0"])
    meshes[kind] = got["sigma"]
  for kind in ("jax", "ref"):
    assert results[kind].step == 3
    assert results[kind].psnrs == results["port"].psnrs
    np.testing.assert_array_equal(meshes[kind], meshes["port"])
  assert np.isfinite(results["jax"].psnrs[0])


def test_fixture_resumes_on_the_cpu(tmp_path):
  """The fixture's orbax state restored into the port (what chip_smoke's
  phase 14 runs on the card): counts, weights and moments as the JAX
  package wrote them, then two windows of 2 steps bit for bit 4 single
  steps, every loss finite."""
  stage_dirs = {k: flax_fixture.stage_copy(str(tmp_path / f"k{k}"))
                for k in (1, 2)}
  small = dict(batch_size=64, bg_patch_size=4, num_coarse_samples=8,
               num_path_samples=4, num_fine_samples=8)
  want = flax_ckpt.restore_checkpoint(flax_fixture.checkpoint_path("orbax"),
                                      None)
  runs = {}
  for k, stage_dir in stage_dirs.items():
    model, optimizer, step, stats, counts, _ = flax_fixture.resume(
        stage_dir, torch.device("cpu"), k, windows=4 // k, grid_n=16,
        **small)
    assert step == flax_fixture.STEP and set(counts) == {step}
    assert [int(c) for c in optimizer.counts] == [step + 4] * len(counts)
    runs[k] = (stats, {n: p.detach().clone()
                       for n, p in model.named_parameters()})
  assert runs[1][0] == runs[2][0] and len(runs[1][0]) == 4
  assert all(np.isfinite(s.loss) for s in runs[1][0])
  for n, p in runs[1][1].items():
    assert torch.equal(runs[2][1][n], p), n
  # Before the steps: the restored weights and moments are the JAX ones.
  args = flax_fixture.fixture_args(**small)
  _, model, _ = march_parity.ship_model(torch.device("cpu"), 0, 16,
                                        **flax_fixture.OVERRIDES)
  optimizer, _, _ = t_step.create_optimizer(model, args)
  t_ckpt.restore_checkpoint(stage_dirs[1], model, optimizer)
  params = convert.params_from_flax(want["params"])
  assert all(torch.equal(model.state_dict()[k], v) for k, v in params.items())
  moments = convert.optimizer_state_from_flax(want["opt_state"], "radiance",
                                              args.num_fine_samples)
  mine = _optimizer_moments(optimizer, model)
  assert moments.keys() == mine.keys() == {"bkgd_mlp", "coarse_mlp",
                                           "fine_mlp"}
  for m, ref in moments.items():
    assert mine[m]["count"] == ref["count"] == flax_fixture.STEP
    for key in ("exp_avg", "exp_avg_sq"):
      assert all(torch.equal(mine[m][key][n], v)
                 for n, v in ref[key].items()), (m, key)


# -------------------------------------------------- fixture regeneration


def _fixture_state():
  """The fixture's TrainState: the narrow ship model after STEP JAX
  radiance train steps on a synthetic batch."""
  args = flax_fixture.fixture_args()
  _, _, bindings = t_config.load_args(
      SHIP, [SHIP + ".gin"], **flax_fixture.OVERRIDES)
  model, variables, jargs, _ = _jax_model(args, bindings)
  jargs.batch_size, jargs.bg_patch_size = 64, 4
  tx, _, _ = j_step.create_optimizer(jargs)
  state = TrainState.create(apply_fn=model.apply,
                            params=variables["params"], tx=tx)
  tstep = j_step.make_train_step(model, jargs, {"grid": variables["grid"]},
                                 donate=False)
  host = march_parity.synthetic_batch(jargs, 0)
  batch = {"pixels": jnp.asarray(host["pixels"]),
           "rays": JRays(*map(jnp.asarray, host["rays"])),
           "env_rays": JRays(*map(jnp.asarray, host["env_rays"])),
           "annealed_alpha": jnp.float32(0.0),
           "coarse_alpha_target": jnp.float32(0.0),
           "fine_alpha_target": jnp.float32(0.0)}
  rng = random.PRNGKey(0)
  for _ in range(flax_fixture.STEP):
    state, _, rng = tstep(rng, state, batch)
  return jax.device_get(state.replace(apply_fn=None))


def regenerate(fixture=flax_fixture.FIXTURE):
  """Rewrite the committed fixture with the JAX package."""
  if os.path.exists(fixture):
    shutil.rmtree(fixture)
  os.makedirs(fixture)
  state = _fixture_state()
  step = flax_fixture.STEP
  j_ckpt.save_checkpoint(os.path.join(fixture, "orbax"), state, step)
  _save_legacy(j_ckpt.save_checkpoint, os.path.join(fixture, "msgpack"),
               state, step)
  _save_legacy(j_ckpt.export_reference_checkpoint,
               os.path.join(fixture, "reference"), state.params, step)
  flax_fixture.write_index({
      fmt: flax_ckpt.restore_checkpoint(flax_fixture.checkpoint_path(
          fmt, fixture), None) for fmt in flax_fixture.FORMATS}, fixture)


if __name__ == "__main__":
  regenerate()
  print(flax_fixture.check())
