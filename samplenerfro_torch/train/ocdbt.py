"""Read the orbax OCDBT checkpoints the JAX package writes, without orbax
or tensorstore.

samplenerfro_tpu/train/checkpoints.py saves through
flax.training.checkpoints, which writes `checkpoint_<step>/` as an orbax
PyTree checkpoint: `_METADATA` (JSON, the tree: each leaf's key path and
value type) and one OCDBT key-value database (tensorstore's "optionally
cooperative distributed B+tree") holding a zarr v2 array per leaf. This
module reads that database and those arrays with numpy and the zstd
binding (utils/zstd.py) alone:

  * `OcdbtStore(dir)`: the root `manifest.ocdbt` (its config and its
    newest inline version), then the B+tree from that version's root node
    down, each value inline in its leaf node or indirect (data file,
    offset, length). Manifests and nodes are tensorstore's encoding: a
    4-byte big-endian magic (0x0cdb3a2a manifest, 0x0cdb20de B-tree node),
    the file's length (uint64 LE), a format version (varint 0), a
    compression byte (0 none, 1 zstd) and the body, then a CRC-32C of all
    that (uint32 LE). Data files are named by a table in each node,
    relative to the base path of the file that holds the node (a merged
    root refers to `ocdbt.process_<i>/d/<hash>`).
  * `read_zarr(store, name)`: the `.zarray` JSON (dtype, shape, chunks,
    order, fill_value, zstd or no compressor, no filters) and its chunks,
    keyed `<name>/<i>.<j>...`, assembled into the array; a chunk never
    written takes the fill value.
  * `restore_orbax(dir)`: the nested dict that
    `flax.training.checkpoints.restore_checkpoint(dir, None)` gives: dict
    keys (key_type 2) as they are, sequence indices (key_type 1) as their
    decimal strings, `np.ndarray` (and `jax.Array`) leaves as numpy
    arrays, `scalar` leaves as Python numbers (orbax's `.item()`), and the
    masked `None` leaves (skip_deserialize) as None. A leaf's database
    name is its key path joined with '.'.

Anything else raises ValueError naming the file and the field: another
magic, format version, compression, manifest kind or node height, a bad
checksum, a truncated file, a zarr filter or compressor, a value type.
"""

import json
import os
import struct

import numpy as np

from samplenerfro_torch.utils import flax_msgpack
from samplenerfro_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_HEADER = 12  # magic + length


def _crc32c_table():
  table = []
  for i in range(256):
    c = i
    for _ in range(8):
      c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
    table.append(c)
  return table


_CRC_TABLE = _crc32c_table()


def crc32c(data):
  """CRC-32C (Castagnoli) of `data`, as tensorstore checksums its
  manifests and nodes."""
  crc, table = 0xFFFFFFFF, _CRC_TABLE
  for b in data:
    crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
  return crc ^ 0xFFFFFFFF


class _Reader:
  """Cursor over a decoded body; every read past its end raises."""

  def __init__(self, data, where):
    self.data, self.pos, self.where = data, 0, where

  def fail(self, what):
    raise ValueError(f"{self.where}: {what} (at byte {self.pos} of "
                     f"{len(self.data)} decoded)")

  def take(self, n):
    if self.pos + n > len(self.data):
      self.fail(f"needs {n} more bytes")
    out = self.data[self.pos:self.pos + n]
    self.pos += n
    return out

  def byte(self):
    return self.take(1)[0]

  def varint(self):
    out, shift = 0, 0
    while True:
      b = self.byte()
      out |= (b & 0x7F) << shift
      if not b & 0x80:
        return out
      shift += 7
      if shift > 63:
        self.fail("varint longer than 64 bits")

  def varints(self, n):
    return [self.varint() for _ in range(n)]

  def done(self):
    if self.pos != len(self.data):
      self.fail(f"{len(self.data) - self.pos} bytes left over")


def decode_envelope(raw, magic, where):
  """The body of a manifest or node file: checks magic, length, format
  version, checksum; decompresses a zstd body."""
  if len(raw) < _HEADER + 6:
    raise ValueError(f"{where}: {len(raw)} bytes, too short for a header")
  got = struct.unpack(">I", raw[:4])[0]
  if got != magic:
    raise ValueError(f"{where}: magic {got:#010x}, expected {magic:#010x}")
  length = struct.unpack("<Q", raw[4:_HEADER])[0]
  if length != len(raw):
    raise ValueError(f"{where}: length field {length}, file has "
                     f"{len(raw)} bytes (truncated or padded)")
  want = struct.unpack("<I", raw[-4:])[0]
  if crc32c(raw[:-4]) != want:
    raise ValueError(f"{where}: CRC-32C mismatch (corrupted)")
  r = _Reader(raw[:-4], where)
  r.pos = _HEADER
  version = r.varint()
  if version != 0:
    raise ValueError(f"{where}: unknown format version {version}")
  compression = r.varint()
  body = raw[r.pos:-4]
  if compression == 1:
    try:
      body = zstd.decompress(body)
    except ValueError as e:
      raise ValueError(f"{where}: zstd body: {e}") from e
  elif compression != 0:
    raise ValueError(f"{where}: unknown compression format {compression}")
  return _Reader(body, where)


def _data_file_table(r, base):
  """[(base path, relative path)] of a node's or manifest's data files,
  under the base path of the file that holds it."""
  n = r.varint()
  prefix = [0] + r.varints(n - 1) if n else []
  suffix = r.varints(n)
  base_len = r.varints(n)
  files, prev = [], b""
  for i in range(n):
    if prefix[i] > len(prev):
      r.fail(f"data file {i}: prefix {prefix[i]} longer than the path "
             "before it")
    full = prev[:prefix[i]] + r.take(suffix[i])
    if base_len[i] > len(full):
      r.fail(f"data file {i}: base path length {base_len[i]} > "
             f"{len(full)}")
    files.append((base + full[:base_len[i]].decode(),
                  full[base_len[i]:].decode()))
    prev = full
  return files


def _location(r, files, n):
  """n (file, offset, length) triples, stored as three columns."""
  ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
  for i in ids:
    if i >= len(files):
      r.fail(f"data file id {i} of a table of {len(files)}")
  return [(files[i], o, l) for i, o, l in zip(ids, offsets, lengths)]


def _key_lengths(r, n):
  prefix = [0] + r.varints(n - 1) if n else []
  return prefix, r.varints(n)


def _keys(r, prefix, suffix):
  """Keys stored as the length each shares with the key before it and the
  bytes that follow."""
  keys, prev = [], b""
  for i in range(len(suffix)):
    if prefix[i] > len(prev):
      r.fail(f"key {i}: prefix {prefix[i]} longer than the key before it")
    prev = prev[:prefix[i]] + r.take(suffix[i])
    keys.append(prev)
  return keys


class OcdbtStore:
  """The key-value pairs of one OCDBT database directory, newest version.

  `get(key)` gives a value's bytes; `keys()` every key, sorted. The whole
  tree is read when the store is opened; indirect values are read from
  their data files when asked for.
  """

  def __init__(self, root):
    self.root = os.fspath(root)
    self._values = {}
    manifest = os.path.join(self.root, "manifest.ocdbt")
    r = decode_envelope(self._read(("", "manifest.ocdbt")), MANIFEST_MAGIC,
                        manifest)
    r.take(16)  # the database's uuid
    kind = r.varint()
    if kind != 0:
      r.fail(f"manifest_kind {kind} (only 0, a single manifest file, is "
             "read)")
    r.varints(2)  # max_inline_value_bytes, max_decoded_node_bytes
    r.byte()  # version_tree_arity_log2
    method = r.varint()
    if method == 1:
      r.take(4)  # zstd level, int32 LE
    elif method != 0:
      r.fail(f"unknown compression_method {method}")
    files = _data_file_table(r, "")
    n = r.varint()
    if n == 0:
      r.fail("no version")
    r.varints(n)  # generation numbers
    heights = [r.byte() for _ in range(n)]
    roots = _location(r, files, n)
    r.varints(3 * n)  # num_keys, num_tree_bytes, num_indirect_value_bytes
    r.take(8 * n)  # commit times
    if r.varint() == 0:  # references to older version-tree nodes
      r.done()
    self._walk(roots[-1], heights[-1])

  def _read(self, ref, offset=0, length=None):
    base, rel = ref
    path = os.path.join(self.root, base, rel)
    try:
      with open(path, "rb") as f:
        f.seek(offset)
        data = f.read() if length is None else f.read(length)
    except FileNotFoundError as e:
      raise ValueError(f"{self.root}: data file {base}{rel} is missing"
                       ) from e
    if length is not None and len(data) != length:
      raise ValueError(f"{path}: {length} bytes at {offset} asked for, "
                       f"{len(data)} there (truncated)")
    return data

  def _walk(self, location, height, prefix=b""):
    """Read the node at `location` and its subtree; its keys are stored
    without `prefix`, the common prefix its parent entry stripped."""
    ref, offset, length = location
    where = f"{os.path.join(self.root, *ref)}@{offset}+{length}"
    if length == 0:  # an empty tree
      return
    r = decode_envelope(self._read(ref, offset, length), NODE_MAGIC, where)
    got = r.byte()
    if got != height:
      r.fail(f"node height {got}, its parent says {height}")
    files = _data_file_table(r, ref[0])
    n = r.varint()
    lengths = _key_lengths(r, n)
    if height == 0:
      keys = [prefix + k for k in _keys(r, *lengths)]
      sizes = r.varints(n)
      kinds = r.varints(n)
      if any(k > 1 for k in kinds):
        r.fail(f"unknown value kind {max(kinds)}")
      indirect = [i for i, k in enumerate(kinds) if k == 1]
      ids, offsets = r.varints(len(indirect)), r.varints(len(indirect))
      for i, fid, off in zip(indirect, ids, offsets):
        if fid >= len(files):
          r.fail(f"data file id {fid} of a table of {len(files)}")
        self._values[keys[i]] = (files[fid], off, sizes[i])
      for i, kind in enumerate(kinds):
        if kind == 0:
          self._values[keys[i]] = r.take(sizes[i])
      r.done()
      return
    common = r.varints(n)  # of each subtree's keys, beyond `prefix`
    keys = [prefix + k for k in _keys(r, *lengths)]
    children = _location(r, files, n)
    r.varints(3 * n)  # num_keys, num_tree_bytes, num_indirect_value_bytes
    r.done()
    for key, c, child in zip(keys, common, children):
      if len(prefix) + c > len(key):
        r.fail(f"subtree common prefix {c} longer than its key")
      self._walk(child, height - 1, key[:len(prefix) + c])

  def keys(self):
    return sorted(k.decode() for k in self._values)

  def __contains__(self, key):
    return key.encode() in self._values

  def get(self, key):
    v = self._values.get(key.encode())
    if v is None:
      raise KeyError(f"{self.root}: no key {key!r}")
    if isinstance(v, tuple):
      v = self._read(*v)
    return v


def zarr_dtype(name, where):
  """numpy dtype of a zarr v2 dtype string; bfloat16 as its uint16 view."""
  if name == "bfloat16":
    return flax_msgpack.BFLOAT16
  try:
    dt = np.dtype(name)
  except TypeError as e:
    raise ValueError(f"{where}: unknown zarr dtype {name!r}") from e
  if dt.hasobject or dt.fields is not None:
    raise ValueError(f"{where}: unsupported zarr dtype {name!r}")
  return dt


def read_zarr(store, name):
  """The zarr v2 array `name` of `store`, as a numpy array (a bfloat16
  array as flax_msgpack.as_bfloat16 of its bits)."""
  where = f"{store.root}: {name}/.zarray"
  meta = json.loads(store.get(f"{name}/.zarray"))
  if meta.get("zarr_format") != 2:
    raise ValueError(f"{where}: zarr_format {meta.get('zarr_format')}")
  if meta.get("filters"):
    raise ValueError(f"{where}: filters {meta['filters']} are not read")
  comp = meta.get("compressor")
  if comp is not None and comp.get("id") != "zstd":
    raise ValueError(f"{where}: compressor {comp} (only zstd is read)")
  order = meta.get("order", "C")
  if order not in ("C", "F"):
    raise ValueError(f"{where}: order {order!r}")
  bf16 = meta["dtype"] == "bfloat16"
  dtype = zarr_dtype(meta["dtype"], where)
  shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
  sep = meta.get("dimension_separator", ".")
  fill = meta.get("fill_value")
  if len(chunks) != len(shape):
    raise ValueError(f"{where}: chunks {chunks} for shape {shape}")
  out = np.zeros(shape, dtype)
  if fill is not None:
    out[...] = fill
  grid = [-(-s // c) for s, c in zip(shape, chunks)]
  nbytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
  for idx in np.ndindex(*grid):
    key = f"{name}/" + (sep.join(map(str, idx)) if idx else "0")
    if key not in store:
      continue
    raw = store.get(key)
    if comp is not None:
      try:
        raw = zstd.decompress(raw)
      except ValueError as e:
        raise ValueError(f"{store.root}: chunk {key}: {e}") from e
    if len(raw) != nbytes:
      raise ValueError(f"{store.root}: chunk {key} holds {len(raw)} bytes, "
                       f"a {chunks} chunk of {dtype} {nbytes}")
    block = np.frombuffer(raw, dtype).reshape(chunks, order=order)
    sl = tuple(slice(i * c, min((i + 1) * c, s))
               for i, c, s in zip(idx, chunks, shape))
    out[sl] = block[tuple(slice(0, t.stop - t.start) for t in sl)]
  return flax_msgpack.as_bfloat16(out) if bf16 else out


def restore_orbax(path):
  """The nested dict flax's restore_checkpoint(path, None) gives for an
  orbax OCDBT checkpoint directory."""
  path = os.fspath(path)
  meta_path = os.path.join(path, "_METADATA")
  try:
    with open(meta_path) as f:
      meta = json.load(f)
  except json.JSONDecodeError as e:
    raise ValueError(f"{meta_path}: not JSON: {e}") from e
  for field, want in (("use_ocdbt", True), ("use_zarr3", False)):
    if meta.get(field, want) != want:
      raise ValueError(f"{meta_path}: {field} is {meta.get(field)}; only "
                       f"{field}={want} is read")
  tree = {}
  store = None
  for entry in meta["tree_metadata"].values():
    keys = entry["key_metadata"]
    for k in keys:
      if k["key_type"] not in (1, 2):
        raise ValueError(f"{meta_path}: key {k['key']!r} has unknown "
                         f"key_type {k['key_type']}")
    value = entry["value_metadata"]
    kind = value["value_type"]
    if value.get("skip_deserialize"):
      if kind != "None":
        raise ValueError(f"{meta_path}: skip_deserialize on a {kind!r} leaf")
      leaf = None
    elif kind in ("np.ndarray", "jax.Array", "scalar"):
      if store is None:
        store = OcdbtStore(path)
      leaf = read_zarr(store, ".".join(str(k["key"]) for k in keys))
      if kind == "scalar":
        if leaf.ndim != 0:
          raise ValueError(f"{meta_path}: scalar leaf {keys} has shape "
                           f"{leaf.shape}")
        leaf = leaf.item()
    else:
      raise ValueError(f"{meta_path}: unknown value_type {kind!r}")
    node = tree
    for k in keys[:-1]:
      node = node.setdefault(str(k["key"]), {})
    node[str(keys[-1]["key"])] = leaf
  return tree
