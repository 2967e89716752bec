"""flax's msgpack checkpoint format, without the msgpack package.

A legacy flax checkpoint (`flax.training.checkpoints` with orbax off, and
the original SampleNeRFRO's release checkpoints) is one file:
`flax.serialization.msgpack_serialize` of the state dict. That is
msgpack (https://github.com/msgpack/msgpack/blob/master/spec.md) of
nested maps with str keys and these leaves:

  * nil, bool, int (up to 64 bits), float (float64; float32 read),
    str, bin, and arrays (read as lists);
  * ext 1: an ndarray, its data a msgpack array
    `(shape, dtype name, C-order bytes)` with bin/str as written by
    flax's `_ndarray_to_bytes`;
  * ext 2: a Python complex, its data msgpack `(real, imag)`;
  * ext 3: a numpy scalar, encoded as a 0-d ext 1 payload;
  * a map {"__msgpack_chunked_array__": True, "shape": {"0": ..},
    "chunks": {"0": flat chunk, ..}}: an array flax split because it
    exceeded `MAX_CHUNK_SIZE` bytes, joined again on reading.

`unpackb` gives what `flax.serialization.msgpack_restore` gives (arrays
read-only views of the buffer, as np.frombuffer makes them); `packb`
writes the bytes `msgpack_serialize(tree, in_place=True)` writes for a
tree of dicts, numpy arrays, numpy scalars and Python scalars (what
flax's `to_bytes`, and so its legacy save_checkpoint, writes): map keys
in their order, arrays above `max_chunk_size` bytes chunked as flax
chunks them. (Without in_place, msgpack_serialize copies the tree with
jax.tree_util, which sorts every map's keys first.)

bfloat16, which numpy lacks, travels as a uint16 array of its bits in the
`Bfloat16Bits` subclass (a bfloat16 numpy scalar as a 0-d
`Bfloat16Scalar`), whose dtype name packb writes as "bfloat16".
"""

import struct

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE
_CHUNKED = "__msgpack_chunked_array__"
BFLOAT16 = np.dtype(np.uint16)


class Bfloat16Bits(np.ndarray):
  """A uint16 array that holds bfloat16 bits."""


class Bfloat16Scalar(Bfloat16Bits):
  """A 0-d Bfloat16Bits that stands for a numpy bfloat16 scalar (ext 3),
  which numpy cannot hold as a scalar without ml_dtypes."""


def as_bfloat16(bits):
  """Mark a uint16 array as bfloat16 bits."""
  return np.asarray(bits).view(np.uint16).view(Bfloat16Bits)


def _dtype_name(arr):
  return "bfloat16" if isinstance(arr, Bfloat16Bits) else arr.dtype.name


# ---------------------------------------------------------------- packing


def _pack_int(v, out):
  if 0 <= v < 0x80:
    out.append(v)
  elif -32 <= v < 0:
    out.append(v & 0xFF)
  elif 0 <= v <= 0xFF:
    out += b"\xcc" + struct.pack(">B", v)
  elif 0 <= v <= 0xFFFF:
    out += b"\xcd" + struct.pack(">H", v)
  elif 0 <= v <= 0xFFFFFFFF:
    out += b"\xce" + struct.pack(">I", v)
  elif 0 <= v < 2**64:
    out += b"\xcf" + struct.pack(">Q", v)
  elif -0x80 <= v < 0:
    out += b"\xd0" + struct.pack(">b", v)
  elif -0x8000 <= v < 0:
    out += b"\xd1" + struct.pack(">h", v)
  elif -0x80000000 <= v < 0:
    out += b"\xd2" + struct.pack(">i", v)
  elif -2**63 <= v < 0:
    out += b"\xd3" + struct.pack(">q", v)
  else:
    raise OverflowError(f"int {v} does not fit msgpack's 64 bits")


def _pack_len(n, fix, fix_max, codes, out):
  """A length header: a fix form below fix_max, then 8/16/32-bit forms
  (codes, None where the kind has no 8-bit form)."""
  if fix is not None and n < fix_max:
    out.append(fix | n)
  elif codes[0] is not None and n <= 0xFF:
    out += bytes([codes[0]]) + struct.pack(">B", n)
  elif n <= 0xFFFF:
    out += bytes([codes[1]]) + struct.pack(">H", n)
  elif n <= 0xFFFFFFFF:
    out += bytes([codes[2]]) + struct.pack(">I", n)
  else:
    raise ValueError(f"msgpack object of {n} items or bytes is too long")


def _pack_ext(code, data, out):
  n = len(data)
  fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
  if n in fixed:
    out.append(fixed[n])
  else:
    _pack_len(n, None, 0, (0xC7, 0xC8, 0xC9), out)
  out.append(code)
  out += data


def _ndarray_bytes(arr):
  """flax's _ndarray_to_bytes: msgpack of (shape, dtype name, bytes)."""
  if arr.dtype.hasobject or arr.dtype.fields is not None:
    raise ValueError("object and structured dtypes are not serialized")
  out = bytearray()
  _pack([list(arr.shape), _dtype_name(arr),
         np.asarray(arr).view(np.ndarray).tobytes("C")], out)
  return bytes(out)


def _pack(v, out):
  # Exact types, as msgpack.packb(strict_types=True) dispatches them;
  # numpy scalars (np.float64 included) go to ext 3 as flax's default does.
  t = type(v)
  if v is None:
    out.append(0xC0)
  elif t is bool:
    out.append(0xC3 if v else 0xC2)
  elif t is int:
    _pack_int(v, out)
  elif t is float:
    out += b"\xcb" + struct.pack(">d", v)
  elif t is str:
    b = v.encode("utf-8")
    _pack_len(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
    out += b
  elif t in (bytes, bytearray, memoryview):
    b = bytes(v)
    _pack_len(len(b), None, 0, (0xC4, 0xC5, 0xC6), out)
    out += b
  elif t is list:
    _pack_len(len(v), 0x90, 16, (None, 0xDC, 0xDD), out)
    for x in v:
      _pack(x, out)
  elif t is dict:
    _pack_len(len(v), 0x80, 16, (None, 0xDE, 0xDF), out)
    for k, x in v.items():
      _pack(k, out)
      _pack(x, out)
  elif isinstance(v, Bfloat16Scalar):
    _pack_ext(EXT_NPSCALAR, _ndarray_bytes(v), out)
  elif isinstance(v, np.ndarray):
    _pack_ext(EXT_NDARRAY, _ndarray_bytes(v), out)
  elif isinstance(v, np.generic):
    _pack_ext(EXT_NPSCALAR, _ndarray_bytes(np.asarray(v)), out)
  elif t is complex:
    inner = bytearray()
    _pack([v.real, v.imag], inner)
    _pack_ext(EXT_COMPLEX, bytes(inner), out)
  else:
    raise TypeError(f"can not serialize {t.__name__!r} object")


def _chunk(arr, max_chunk_size):
  """flax's _chunk: a flat array split into max_chunk_size-byte pieces."""
  size = max(1, int(max_chunk_size / arr.dtype.itemsize))
  flat = arr.reshape(-1)
  chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
  return {_CHUNKED: True,
          "shape": {str(i): d for i, d in enumerate(arr.shape)},
          "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _chunk_leaves(tree, max_chunk_size):
  """flax's _chunk_array_leaves_in_place, on a copy of the dicts."""
  if isinstance(tree, dict):
    return {k: _chunk_leaves(v, max_chunk_size) for k, v in tree.items()}
  if (isinstance(tree, np.ndarray)
      and tree.size * tree.dtype.itemsize > max_chunk_size):
    return _chunk(tree, max_chunk_size)
  return tree


def packb(tree, max_chunk_size=MAX_CHUNK_SIZE):
  """The bytes flax.serialization.msgpack_serialize(tree, in_place=True)
  writes."""
  out = bytearray()
  _pack(_chunk_leaves(tree, max_chunk_size), out)
  return bytes(out)


# -------------------------------------------------------------- unpacking


class _Unpacker:

  def __init__(self, data, where):
    self.data, self.pos, self.where = memoryview(data), 0, where

  def fail(self, what):
    raise ValueError(f"{self.where}: {what} at byte {self.pos} of "
                     f"{len(self.data)}")

  def take(self, n):
    if self.pos + n > len(self.data):
      self.fail(f"msgpack data ends: {n} bytes needed")
    out = self.data[self.pos:self.pos + n]
    self.pos += n
    return out

  def num(self, fmt):
    return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

  def obj(self, raw=False):
    c = self.take(1)[0]
    if c <= 0x7F:
      return c
    if c >= 0xE0:
      return c - 0x100
    if 0x80 <= c <= 0x8F:
      return self.map(c & 0x0F, raw)
    if 0x90 <= c <= 0x9F:
      return [self.obj(raw) for _ in range(c & 0x0F)]
    if 0xA0 <= c <= 0xBF:
      return self.str(c & 0x1F, raw)
    simple = {0xC0: None, 0xC2: False, 0xC3: True}
    if c in simple:
      return simple[c]
    ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
            0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
    if c in ints:
      return self.num(ints[c])
    lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H",
            0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",
            0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
    fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
    if c in (0xC4, 0xC5, 0xC6):
      return bytes(self.take(self.num(lens[c])))
    if c in (0xD9, 0xDA, 0xDB):
      return self.str(self.num(lens[c]), raw)
    if c in (0xDC, 0xDD):
      return [self.obj(raw) for _ in range(self.num(lens[c]))]
    if c in (0xDE, 0xDF):
      return self.map(self.num(lens[c]), raw)
    if c in fixext or c in (0xC7, 0xC8, 0xC9):
      n = fixext[c] if c in fixext else self.num(lens[c])
      code = self.num(">b")
      return self.ext(code, bytes(self.take(n)))
    self.fail(f"byte {c:#04x} starts no msgpack object")

  def str(self, n, raw):
    b = bytes(self.take(n))
    if raw:
      return b
    try:
      return b.decode("utf-8")
    except UnicodeDecodeError as e:
      self.fail(f"str is not UTF-8 ({e})")

  def map(self, n, raw):
    out = {}
    for _ in range(n):
      k = self.obj(raw)
      if type(k) not in (str, bytes):
        self.fail(f"map key of type {type(k).__name__}")
      out[k] = self.obj(raw)
    return out

  def ext(self, code, data):
    if code in (EXT_NDARRAY, EXT_NPSCALAR):
      arr = _ndarray(data, self.where)
      if code == EXT_NDARRAY:
        return arr
      if isinstance(arr, Bfloat16Bits):
        return arr.reshape(()).view(Bfloat16Scalar)
      return arr[()]
    if code == EXT_COMPLEX:
      re, im = _unpack(data, self.where)
      return complex(re, im)
    self.fail(f"unknown msgpack ext type {code}")


def _unpack(data, where, raw=False):
  u = _Unpacker(data, where)
  out = u.obj(raw)
  if u.pos != len(u.data):
    u.fail(f"{len(u.data) - u.pos} bytes after the msgpack object")
  return out


def _ndarray(data, where):
  try:
    shape, name, buf = _unpack(data, where, raw=True)
    name = name.decode()
  except (TypeError, ValueError, AttributeError) as e:
    raise ValueError(f"{where}: ndarray ext is not (shape, dtype, bytes): "
                     f"{e}") from e
  try:
    dtype = BFLOAT16 if name == "bfloat16" else np.dtype(name)
  except TypeError as e:
    raise ValueError(f"{where}: unknown ndarray dtype {name!r}") from e
  count = int(np.prod(shape, dtype=np.int64))
  if count * dtype.itemsize != len(buf):
    raise ValueError(f"{where}: ndarray {name}{list(shape)} needs "
                     f"{count * dtype.itemsize} bytes, has {len(buf)}")
  arr = np.frombuffer(buf, dtype).reshape(shape)
  return as_bfloat16(arr) if name == "bfloat16" else arr


def _unchunk_leaves(tree):
  """flax's _unchunk_array_leaves_in_place."""
  if not isinstance(tree, dict):
    return tree
  if _CHUNKED in tree:
    shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
    chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
    joined = np.concatenate(chunks).reshape(shape)
    return (as_bfloat16(joined) if isinstance(chunks[0], Bfloat16Bits)
            else joined)
  return {k: _unchunk_leaves(v) for k, v in tree.items()}


def unpackb(data, where="msgpack"):
  """What flax.serialization.msgpack_restore gives for `data`.

  Raises:
    ValueError: `data` is not one whole msgpack object of flax's kinds
      (`where` names the source in the message).
  """
  return _unchunk_leaves(_unpack(bytes(data), where))
