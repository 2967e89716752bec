"""Host-to-device batch prefetching.

Counterpart of samplenerfro_tpu/data/prefetch.py:15-44: a daemon thread
calls a host-batch function and copies each batch to the device a few
batches ahead of the train loop, so that assembling and copying overlap
the steps. On the card each batch goes through pinned host buffers to the
device with non_blocking copies on a copy stream of its own, whose event
the consuming stream waits on; on the CPU the same iterator hands the
batches on as tensors, with no pinning and no streams.
"""

import queue
import threading

import numpy as np
import torch

_END = object()


class _Failure:
  """An exception of the worker, raised again in the consuming loop."""

  def __init__(self, exc):
    self.exc = exc


def map_tensors(fn, tree, *rest):
  """fn over the leaves of a batch tree (dicts, tuples and namedtuples such
  as Rays and march_kernel.CheckedJitter, None kept as it is), with the
  matching leaves of `rest` as further arguments; keeps the structure."""
  if tree is None:
    return None
  if isinstance(tree, dict):
    return {k: map_tensors(fn, v, *[r[k] for r in rest])
            for k, v in tree.items()}
  if isinstance(tree, tuple):
    vals = [map_tensors(fn, *xs) for xs in zip(tree, *rest)]
    return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
  return fn(tree, *rest)


def _as_tensor(x):
  if isinstance(x, torch.Tensor):
    return x
  a = np.asarray(x)
  return torch.from_numpy(a if a.flags.c_contiguous else a.copy())


def stack(batches):
  """Host batches of one structure -> one batch whose leaves carry a
  leading step axis (numpy arrays)."""
  return map_tensors(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                     *batches)


def to_device(batch, device):
  """A host batch (numpy arrays, numbers, tensors) as tensors on `device`,
  copied there and then, with no prefetching."""
  return map_tensors(lambda t: _as_tensor(t).to(device), batch)


def _leading(batch):
  sizes = set()
  map_tensors(lambda t: sizes.add(t.shape[0] if t.dim() else None), batch)
  if len(sizes) != 1 or None in sizes:
    raise ValueError(f"a stacked batch's leaves must share a leading step "
                     f"axis, got leading sizes {sorted(sizes, key=str)}")


def _copy_to_card(batch, device, stream):
  """The batch through pinned buffers to `device` on `stream`; returns
  (device batch, the copies' event)."""
  with torch.cuda.stream(stream):
    out = map_tensors(
        lambda t: t.pin_memory().to(device, non_blocking=True), batch)
    event = torch.cuda.Event()
    event.record(stream)
  return out, event


def device_prefetch(batch_fn, device, size=3, stacked=False):
  """Iterator of device batches, in order, `size` ahead of the consumer.

  Args:
    batch_fn: callable () -> host batch (a tree of numpy arrays, numbers
      and tensors; see map_tensors), or None when there are no more.
    device: where the batches go.
    size: batches held ready.
    stacked: every leaf carries the same leading step axis (multi-step
      dispatch); checked on the host.

  Yields:
    the batches as tensors on `device`. On the card the current stream
    (the consumer's, when it takes the batch) waits for the copy, and the
    batch's memory is kept until that stream's work on it is done.

  An exception in batch_fn or the copy is raised here, in the consumer.
  Closing the iterator stops the worker.
  """
  device = torch.device(device)
  stream = torch.cuda.Stream(device) if device.type == "cuda" else None
  q = queue.Queue(size)
  stop = threading.Event()

  def put(item):
    while not stop.is_set():
      try:
        q.put(item, timeout=0.1)
        return
      except queue.Full:
        pass

  def worker():
    try:
      while not stop.is_set():
        host = batch_fn()
        if host is None:
          put(_END)
          return
        host = map_tensors(_as_tensor, host)
        if stacked:
          _leading(host)
        put(_copy_to_card(host, device, stream) if stream is not None
            else (host, None))
    except Exception as exc:  # handed to the consumer, which raises it
      put(_Failure(exc))

  thread = threading.Thread(target=worker, name="device_prefetch",
                            daemon=True)
  thread.start()
  try:
    while True:
      try:
        item = q.get(timeout=0.5)
      except queue.Empty:
        if thread.is_alive():
          continue
        try:
          item = q.get_nowait()
        except queue.Empty:
          raise RuntimeError("device_prefetch: the worker ended without a "
                             "batch, an end or an error") from None
      if item is _END:
        return
      if isinstance(item, _Failure):
        raise item.exc
      batch, event = item
      if event is not None:
        current = torch.cuda.current_stream(device)
        current.wait_event(event)
        map_tensors(lambda t: t.record_stream(current), batch)
      yield batch
  finally:
    stop.set()
    while True:
      try:
        q.get_nowait()
      except queue.Empty:
        break
    thread.join(timeout=10)
