"""Zstandard decompression through the system's libzstd.so.1 (ctypes).

The JAX package's orbax checkpoints compress every OCDBT manifest, B-tree
node and zarr chunk as zstd frames (train/ocdbt.py). The port reads them
with the system's C library, libzstd.so.1 (package libzstd1, which
common Linux distributions install), bound here with ctypes as
tools/sdf.py binds its library, with no Python zstd package. A machine
without the library raises OSError naming it.

`decompress` follows RFC 8878 section 3: the input is any number of
frames back to back, each either a Zstandard frame, whose output is
appended, or a skippable frame, which is skipped. A frame that states its
content size is decompressed in one call into a buffer of that size; one
that does not is streamed.
"""

import ctypes
import threading

LIBRARY = "libzstd.so.1"
_CONTENTSIZE_UNKNOWN = 2**64 - 1
_CONTENTSIZE_ERROR = 2**64 - 2

_lib = None
_lock = threading.Lock()


class _InBuffer(ctypes.Structure):
  _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t),
              ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
  _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t),
              ("pos", ctypes.c_size_t)]


def _load():
  global _lib
  with _lock:
    if _lib is not None:
      return _lib
    try:
      lib = ctypes.CDLL(LIBRARY)
    except OSError as e:
      raise OSError(f"zstd decompression needs the system library {LIBRARY} "
                    f"(libzstd, package libzstd1), which did not load: {e}"
                    ) from e
    vp, sz = ctypes.c_void_p, ctypes.c_size_t
    for fn, argtypes, restype in (
        (lib.ZSTD_findFrameCompressedSize, [vp, sz], sz),
        (lib.ZSTD_getFrameContentSize, [vp, sz], ctypes.c_ulonglong),
        (lib.ZSTD_isError, [sz], ctypes.c_uint),
        (lib.ZSTD_getErrorName, [sz], ctypes.c_char_p),
        (lib.ZSTD_isSkippableFrame, [vp, sz], ctypes.c_uint),
        (lib.ZSTD_createDCtx, [], vp),
        (lib.ZSTD_freeDCtx, [vp], sz),
        (lib.ZSTD_decompressDCtx, [vp, vp, sz, vp, sz], sz),
        (lib.ZSTD_DStreamOutSize, [], sz),
        (lib.ZSTD_decompressStream,
         [vp, ctypes.POINTER(_OutBuffer), ctypes.POINTER(_InBuffer)], sz)):
      fn.argtypes, fn.restype = argtypes, restype
    _lib = lib
    return lib


def _check(lib, code, what):
  if lib.ZSTD_isError(code):
    raise ValueError(f"zstd: {what}: "
                     f"{lib.ZSTD_getErrorName(code).decode()}")
  return code


def _stream(lib, dctx, src, size):
  """Decompress one frame of `size` bytes at `src` whose header states no
  content size."""
  out = bytearray()
  chunk = ctypes.create_string_buffer(lib.ZSTD_DStreamOutSize())
  inb = _InBuffer(src, size, 0)
  while True:
    outb = _OutBuffer(ctypes.cast(chunk, ctypes.c_void_p), len(chunk), 0)
    left = _check(lib, lib.ZSTD_decompressStream(dctx, ctypes.byref(outb),
                                                  ctypes.byref(inb)),
                  "streamed frame")
    out += chunk.raw[:outb.pos]
    if left == 0:
      return bytes(out)
    if inb.pos == inb.size and outb.pos < outb.size:
      raise ValueError("zstd: streamed frame: input ends inside the frame")


def decompress(data):
  """Decompressed bytes of `data`: Zstandard and skippable frames back to
  back (RFC 8878).

  Raises:
    ValueError: the input is not a sequence of whole frames, or a frame's
      content does not decode (checksum, corrupt block) or differs in
      length from the size its header states.
    OSError: libzstd.so.1 does not load.
  """
  lib = _load()
  data = bytes(data)
  buf = ctypes.create_string_buffer(data, len(data))
  base = ctypes.addressof(buf)
  out = []
  dctx = lib.ZSTD_createDCtx()
  if not dctx:
    raise MemoryError("ZSTD_createDCtx failed")
  try:
    pos = 0
    while pos < len(data):
      src, left = base + pos, len(data) - pos
      size = _check(lib, lib.ZSTD_findFrameCompressedSize(src, left),
                    f"frame at byte {pos}")
      if not lib.ZSTD_isSkippableFrame(src, size):
        content = lib.ZSTD_getFrameContentSize(src, size)
        if content == _CONTENTSIZE_ERROR:
          raise ValueError(f"zstd: bad frame header at byte {pos}")
        if content == _CONTENTSIZE_UNKNOWN:
          out.append(_stream(lib, dctx, src, size))
        else:
          dst = ctypes.create_string_buffer(max(content, 1))
          n = _check(lib, lib.ZSTD_decompressDCtx(dctx, dst, content, src,
                                                  size),
                     f"frame at byte {pos}")
          if n != content:
            raise ValueError(f"zstd: frame at byte {pos} gave {n} bytes, "
                             f"its header states {content}")
          out.append(dst.raw[:n])
      pos += size
  finally:
    lib.ZSTD_freeDCtx(dctx)
  return b"".join(out)
