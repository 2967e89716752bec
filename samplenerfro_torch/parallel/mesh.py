"""Data parallelism over torch.distributed ranks.

Counterpart of samplenerfro_tpu/parallel/mesh.py and of
samplenerfro_tpu/utils/config.py:maybe_initialize_distributed. The JAX
package shards the ray batch over a 1-D device mesh and lets GSPMD turn
the step into the single-device step of the global batch. The port does
the same by hand, one process a rank (torchrun):

- each rank draws batch_size // W rays of its own (data/datasets.py);
- parameters and Adam state are replicated: broadcast_module_state sends
  rank 0's after build or restore, as `replicate` places them;
- the leaves of a batch that are not ray-sharded (the env-ray patch, the
  Grid's points, alpha, learning rates, jitter) are broadcast from rank 0
  on the main thread, as `put_batch` does (broadcast_replicated);
- the loss is the global batch's (train/step.py): ray means enter as
  local_mean / W, ratios take all-reduced denominators (global_sum), and
  terms of replicated inputs enter as term / W; one all-reduce of the
  gradients (all_reduce_grads) then gives the global gradient before
  clipping;
- noise is drawn at the global batch's shape from a generator seeded
  alike on every rank, and sliced to the rank's rows (draw_global), as a
  JAX key draws over a sharded array;
- views are rendered with each chunk's rays split over the ranks and
  gathered (gather_rows, utils/render.py).

A process without WORLD_SIZE in its environment joins no group, and every
function here is then the identity of a world of one. Nothing falls back:
a failed init, a failed collective, NCCL without CUDA and a batch that
does not divide by W raise.

Collectives go to the default process group and are issued from the main
thread only: two threads issuing on one communicator may order them
differently on two ranks, which hangs.
"""

import contextlib
import os

import torch
import torch.distributed as dist

from samplenerfro_torch import resolve_device
from samplenerfro_torch.data import prefetch

# Top-level batch keys whose leaves are replicated rather than ray-sharded
# (samplenerfro_tpu/parallel/mesh.py:36).
REPLICATED_BATCH_KEYS = ("env_rays", "pts", "grads")
# The keys whose leaves are split by rank along the ray axis; every other
# leaf of a train batch (REPLICATED_BATCH_KEYS, "annealed_alpha", "lr",
# "jitter") is broadcast from rank 0.
RAY_KEYS = ("rays", "pixels")
# The parameters' buffer that every rank builds from the scene's files,
# as every JAX process builds its grid: not broadcast (2 GB at 512^3).
GRID_BUFFER = "path_sampler.grid"


def active():
  """Whether this process is a rank of a process group (of any world)."""
  return dist.is_available() and dist.is_initialized()


def rank():
  return dist.get_rank() if active() else 0


def world():
  return dist.get_world_size() if active() else 1


def backend():
  """The default group's backend ("nccl", "gloo"), or None."""
  return dist.get_backend() if active() else None


@contextlib.contextmanager
def process_group(device=None, backend_name=None):
  """Join the process group torchrun's environment describes for the
  duration of an entry point; yields this rank's device.

  Args:
    device: the entry point's --device (None: CUDA); with a group, a CUDA
      rank runs on cuda:LOCAL_RANK.
    backend_name: None picks NCCL on CUDA and gloo on the CPU; "gloo" on
      CUDA runs gloo collectives on CUDA tensors (two ranks on one card,
      which NCCL refuses).

  Without WORLD_SIZE in the environment no group is joined and the device
  is resolve_device(device)'s. A group this call made ends on the way out;
  one that already exists is used and left.

  Raises:
    RuntimeError: CUDA asked for and absent; ValueError: NCCL asked for
    on the CPU. A failed init_process_group raises its own error.
  """
  dev = resolve_device(device)
  joined = False
  if "WORLD_SIZE" in os.environ:
    if dev.type == "cuda":
      dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
      torch.cuda.set_device(dev)
    name = backend_name or ("nccl" if dev.type == "cuda" else "gloo")
    if name == "nccl" and dev.type != "cuda":
      raise ValueError(f"NCCL needs CUDA devices; this rank runs on {dev}")
    if not active():
      dist.init_process_group(name, init_method="env://")
      joined = True
  try:
    yield dev
  finally:
    if joined:
      dist.destroy_process_group()


def per_rank(n, what):
  """n // W, raising ValueError unless W divides n (train.py:54-55)."""
  w = world()
  if n % w:
    raise ValueError(f"{what}={n} must be divisible by the number of ranks "
                     f"({w}).")
  return n // w


def local_rows(n):
  """This rank's row range [lo, hi) of n rows split over the ranks
  (samplenerfro_tpu/parallel/mesh.py:115-123); W must divide n."""
  per = per_rank(n, "rows")
  lo = rank() * per
  return lo, lo + per


def draw_global(draw, shape, **kwargs):
  """draw(shape, **kwargs) (torch.rand, torch.randn) for this rank's rows
  of the global batch: drawn at [shape[0] * W, ...] and sliced, so every
  rank's generator moves alike and the rows are those the global batch's
  draw gives them. With no group, or a world of one, the same call as
  without ranks."""
  w = world()
  if w == 1:
    return draw(shape, **kwargs)
  n = shape[0]
  lo = rank() * n
  return draw([n * w, *shape[1:]], **kwargs)[lo:lo + n]


def global_sum(x):
  """The sum over ranks of a tensor (a copy; x is left as it is); x itself
  without a group. Not differentiated: counts and statistics."""
  if not active():
    return x
  out = x.detach().clone()
  dist.all_reduce(out)
  return out


def all_reduce_grads(params):
  """Sum every parameter's gradient over the ranks, in one flat buffer a
  dtype. Parameters without a gradient are skipped (alike on every rank:
  the same graph). Does nothing without a group."""
  if not active():
    return
  grads = [p.grad for p in params if p.grad is not None]
  for dtype in sorted({g.dtype for g in grads}, key=str):
    group = [g for g in grads if g.dtype == dtype]
    flat = torch.cat([g.reshape(-1) for g in group])
    dist.all_reduce(flat)
    for g, f in zip(group, flat.split([g.numel() for g in group])):
      g.copy_(f.view_as(g))


@torch.no_grad()
def broadcast_module_state(model, optimizer=None):
  """Rank 0's parameters and buffers (the scene grid excepted, GRID_BUFFER)
  and, given an optimizer (train/step.Adam), its moments and counts, into
  every rank's, in place (samplenerfro_tpu/parallel/mesh.py:97-112). Run
  once after build or restore."""
  if not active():
    return
  for name, t in model.state_dict().items():
    if name != GRID_BUFFER:
      dist.broadcast(t, 0)
  if optimizer is not None:
    for group in optimizer.param_groups:
      for p in group["params"]:
        for t in optimizer.state[p].values():
          dist.broadcast(t, 0)
    for count in optimizer.counts:
      dist.broadcast(count, 0)


def broadcast_replicated(batch):
  """Rank 0's values of every leaf of a (stacked) device batch that is not
  ray-sharded (all but RAY_KEYS), in place, as put_batch broadcasts them
  (samplenerfro_tpu/parallel/mesh.py:86-91). Call on the main thread."""
  if not active():
    return batch
  for key, value in batch.items():
    if key not in RAY_KEYS:
      prefetch.map_tensors(lambda t: dist.broadcast(t, 0), value)
  return batch


def gather_rows(local):
  """[W * n, C] of every rank's [n, C] tensor, rank by rank, on every
  rank; local itself without a group. gloo gathers host copies (it takes
  CUDA tensors for broadcast and all_reduce only); the result lies on
  local's device."""
  if not active():
    return local
  w = world()
  if backend() == "gloo":
    host = local.detach().cpu().contiguous()
    parts = [torch.empty_like(host) for _ in range(w)]
    dist.all_gather(parts, host)
    return torch.cat(parts).to(local.device)
  out = torch.empty((w * local.shape[0], *local.shape[1:]),
                    dtype=local.dtype, device=local.device)
  dist.all_gather_into_tensor(out, local.contiguous())
  return out


def broadcast_object(value):
  """Rank 0's picklable value on every rank; value without a group."""
  if not active():
    return value
  box = [value]
  dist.broadcast_object_list(box, 0)
  return box[0]


def barrier():
  if active():
    dist.barrier()
