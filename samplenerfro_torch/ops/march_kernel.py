"""The forward eikonal march kernels: wrappers and their plain versions.

K1, the lean march (csrc/march_lean.cu), replaces
samplenerfro_tpu/ops/pallas/march_kernel.py:_march_kernel in lean mode
(march_tiled_pallas_lean): the radiance stage and eval.
K2, the so3-refined march (csrc/march_so3.cu), replaces the same kernel in
full-emit mode with the so3 head (march_tiled_pallas(so3_params=...)): the
'all' stage's forward. K2 with the head off (march_tiled_pallas(
so3_params=None)), the full trajectory stepping with the grid's own
gradient, is K1's template in csrc/march_lean.cu with the full emit: the
radiance stage's path dump (extract_mesh) and the synthetic scene's ground
truth (tools/synth.py). Each source comment says what bounds it on the
card.

`march_lean`, `march_full` and `march_full_plain` launch their kernel for
CUDA tensors and use `march_lean_reference` / `march_full_reference` /
`march_full_plain_reference` only for CPU tensors.
Unlike the TPU kernel they march straight out of the grid in device
memory, so they take no window, refetch or skip settings and report no
out-of-window count. Each takes the interpolation's precision (`interp`,
ops/precision.INTERPS: the TPU kernel's interp_precision), and K2 the so3
head's arm (`bwd_dtype`, tied to march_bwd_dtype: ops/precision.py); each
arm is its own instantiation of the kernel, and K2's bf16 head a kernel of
its own (the so3 head on tensor cores, its weights resident in one CTA). A
wrapper counts its launches in `.launches` and, by arm, in `.arms`.
"""

import collections
import ctypes
import functools
import typing

import torch

from samplenerfro_torch.ops import cuda_build
from samplenerfro_torch.ops import eikonal as eik_ops
from samplenerfro_torch.ops import math as math_ops
from samplenerfro_torch.ops import mlp as mlp_ops
from samplenerfro_torch.ops import precision


def march_lean_reference(spec, data, origins, directions, near, step_size,
                         num_samples, jitter, interp="highest"):
  """Plain PyTorch version of K1: ops/eikonal.march plus the jitter gather."""
  pos, dirs, dist, _, _ = eik_ops.march(spec, data, origins, directions, near,
                                        step_size, num_samples, interp=interp)
  jitter = jitter.to(device=pos.device, dtype=torch.int64)
  return pos, dirs, dist, pos[:, jitter], dirs[:, jitter], dist[:, jitter]


def check_march_inputs(who, spec, data, origins, directions):
  """Raise ValueError unless the march kernels can take these tensors."""
  dev = origins.device
  nvox = spec.ndim[0] * spec.ndim[1] * spec.ndim[2]
  for name, t, shape in (("origins", origins, (origins.shape[0], 3)),
                         ("directions", directions, (origins.shape[0], 3)),
                         ("data", data, (nvox, 4))):
    if t.device != dev:
      raise ValueError(f"{who}: {name} is on {t.device}, origins on {dev}")
    if t.dtype != torch.float32:
      raise ValueError(f"{who}: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
      raise ValueError(f"{who}: {name} has shape {tuple(t.shape)}, "
                       f"expected {shape}")
    if not t.is_contiguous():
      raise ValueError(f"{who}: {name} must be contiguous")
  if data.data_ptr() % 16:
    raise ValueError(f"{who}: data must be 16-byte aligned (float4 voxels)")


# K1's launch geometry (csrc/march_lean.cu): 8 lanes a ray, one a trilinear
# corner; 8 rays a block; each ray's dense rows staged in shared memory for
# LEAN_STAGE steps, its subsample rows for the whole march.
LEAN_LANES, LEAN_RAYS, LEAN_STAGE, ROW = 8, 8, 32, 7
# Dynamic shared memory a block may use on an H100.
SMEM_LIMIT = 232448


def lean_launch_geometry(batch, num_samples, num_coarse):
  """K1's launch for `batch` rays of num_samples steps and num_coarse
  subsample bins: rays a block, threads, blocks, shared bytes a block.

  Raises ValueError, naming the limit, for a shape K1 does not take.
  """
  if batch < 1:
    raise ValueError(f"march_lean: batch must be at least 1, got {batch}")
  if num_coarse < 1 or num_samples % num_coarse:
    raise ValueError(f"march_lean: num_samples {num_samples} is not a "
                     f"multiple of the {num_coarse} coarse bins")
  smem = 4 * ROW * LEAN_RAYS * (LEAN_STAGE + num_coarse)
  if smem > SMEM_LIMIT:
    most = SMEM_LIMIT // (4 * ROW * LEAN_RAYS) - LEAN_STAGE
    raise ValueError(f"march_lean: {num_coarse} coarse bins need {smem} "
                     f"bytes of shared memory a block, over the "
                     f"{SMEM_LIMIT} a block may use (at most {most} bins)")
  return {"lanes": LEAN_LANES, "rays_per_block": LEAN_RAYS,
          "threads": LEAN_LANES * LEAN_RAYS,
          "blocks": -(-batch // LEAN_RAYS), "stage_steps": LEAN_STAGE,
          "smem_bytes": smem}


def check_jitter(jitter, num_samples):
  """Raise ValueError unless `jitter` is a 1-D integer host tensor that
  puts bin c's index in [c * num_path, (c + 1) * num_path), num_path =
  num_samples / bins; returns the number of bins. It reads the values, so
  it takes them where they are drawn: on the host (nerf.make_jitter)."""
  if jitter.device.type != "cpu":
    raise ValueError(f"march_lean: pass the jitter on the host, where it is "
                     f"checked, not on {jitter.device}: reading it back from "
                     f"the card would stall the stream")
  if jitter.dim() != 1 or jitter.dtype not in (torch.int32, torch.int64):
    raise ValueError("march_lean: jitter must be a 1-D integer tensor")
  nc = jitter.shape[0]
  if nc == 0 or num_samples % nc:
    raise ValueError(f"march_lean: num_samples {num_samples} is not a "
                     f"multiple of the {nc} coarse bins")
  per = num_samples // nc
  lo = torch.arange(nc) * per
  if not bool(((jitter >= lo) & (jitter < lo + per)).all()):
    raise ValueError("march_lean: jitter[c] must lie in "
                     "[c*num_path, (c+1)*num_path)")
  return nc


class CheckedJitter(typing.NamedTuple):
  """A jitter (or a [K, Nc] stack of them, one a step) whose values
  check_jitter read on the host, as int64 `indices` on any device.

  Made by checked_jitter; a copy or a stack keeps the type
  (data/prefetch.py stacks a window's and copies them to the card with
  the batch). K1 and the coarse gather take it where it lies, with no
  check and no copy, so that a CUDA graph can capture them.
  """
  indices: torch.Tensor


def checked_jitter(jitter, num_samples):
  """check_jitter on a [Nc] host jitter; returns it as a CheckedJitter of
  int64 indices."""
  check_jitter(jitter, num_samples)
  return CheckedJitter(jitter.to(torch.int64))


def _check_inputs(spec, data, origins, directions, num_samples, jitter):
  """K1's launch geometry for these inputs; raises ValueError unless K1
  can take them. Reads no value on the card: a CheckedJitter was checked
  on the host, and only its shape is checked here."""
  check_march_inputs("march_lean", spec, data, origins, directions)
  if isinstance(jitter, CheckedJitter):
    idx = jitter.indices
    if idx.device != origins.device or idx.dim() != 1:
      raise ValueError(f"march_lean: a checked jitter must be one step's "
                       f"[Nc] on {origins.device}, got "
                       f"{tuple(idx.shape)} on {idx.device}")
    nc = idx.shape[0]
  else:
    nc = check_jitter(jitter, num_samples)
  return lean_launch_geometry(origins.shape[0], num_samples, nc)


def march_lean(spec, data, origins, directions, near, step_size, num_samples,
               jitter, interp="highest"):
  """March, emitting the dense path and the jittered coarse subsample.

  Args:
    spec: GridSpec of the IOR grid.
    data: [N^3, 4] float32 grid of [n, grad n], on the device of `origins`.
    origins, directions: [batch, 3] float32.
    near: distance to start marching at.
    step_size: Euler step h.
    num_samples: S, path vertices per ray.
    jitter: [Nc] integer indices on the host, jitter[c] in
      [c*S/Nc, (c+1)*S/Nc) (nerf.make_jitter); checked there and copied to
      the card without a wait. Or a CheckedJitter on the card, taken as
      it is (the form a CUDA graph captures). The call reads nothing back
      from the card.
    interp: the interpolation's precision (ops/precision.INTERPS).

  Returns:
    (pos [B, S, 3], unit dirs [B, S, 3], dist [B, S],
     sub_pos [B, Nc, 3], sub_dirs [B, Nc, 3], sub_dist [B, Nc]).
  """
  precision.check_interp(interp)
  dev = origins.device
  if dev.type == "cpu":
    if isinstance(jitter, CheckedJitter):
      jitter = jitter.indices
    return march_lean_reference(spec, data, origins, directions, near,
                                step_size, num_samples, jitter, interp)
  if dev.type != "cuda":
    raise ValueError(f"march_lean runs on CUDA or CPU tensors, not {dev}")
  geom = _check_inputs(spec, data, origins, directions, num_samples, jitter)
  if isinstance(jitter, CheckedJitter):
    jitter = jitter.indices
  batch, nc = origins.shape[0], jitter.shape[0]
  lib = _library()
  dense = torch.empty((batch, num_samples, ROW), dtype=torch.float32,
                      device=dev)
  sub = torch.empty((batch, nc, ROW), dtype=torch.float32, device=dev)
  jit32 = jitter.to(device=dev, dtype=torch.int32,
                    non_blocking=True).contiguous()
  with torch.cuda.device(dev):
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.march_lean_launch(
        origins.data_ptr(), directions.data_ptr(), data.data_ptr(),
        jit32.data_ptr(), dense.data_ptr(), sub.data_ptr(), batch,
        num_samples, nc, *spec.ndim, near, step_size, *spec.nmin,
        *spec.ndelta, geom["rays_per_block"], geom["threads"],
        geom["smem_bytes"], precision.INTERP_CODES[interp], stream)
  if err != 0:
    raise RuntimeError(f"march_lean: kernel launch failed with CUDA error "
                       f"{err}")
  march_lean.launches += 1
  march_lean.arms[interp] += 1
  return (dense[..., 0:3], math_ops.safe_l2_normalize(dense[..., 3:6]),
          dense[..., 6], sub[..., 0:3],
          math_ops.safe_l2_normalize(sub[..., 3:6]), sub[..., 6])


march_lean.launches = 0
march_lean.arms = collections.Counter()


def _library():
  lib = cuda_build.load("march_lean")
  vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
  for fn, argtypes in (
      (lib.march_lean_launch, [vp] * 6 + [ci] * 6 + [cf] * 8 + [ci] * 4),
      (lib.march_full_plain_launch, [vp] * 4 + [ci] * 5 + [cf] * 8
       + [ci] * 4)):
    if fn.restype is not ci or not fn.argtypes:
      fn.argtypes = argtypes + [vp]
      fn.restype = ci
  return lib


# K2 with the head off runs K1's blocks with rows of FULL_ROW floats (p,
# raw d, t, n, grad n) and no subsample.
FULL_ROW = 11


def full_plain_launch_geometry(batch):
  """The head-off full emit's launch for `batch` rays: K1's 8 lanes a ray
  and 8 rays a block, each ray's rows staged for LEAN_STAGE steps."""
  if batch < 1:
    raise ValueError(f"march_full_plain: batch must be at least 1, got "
                     f"{batch}")
  return {"lanes": LEAN_LANES, "rays_per_block": LEAN_RAYS,
          "threads": LEAN_LANES * LEAN_RAYS,
          "blocks": -(-batch // LEAN_RAYS), "stage_steps": LEAN_STAGE,
          "smem_bytes": 4 * FULL_ROW * LEAN_RAYS * LEAN_STAGE}


def march_full_plain_reference(spec, data, origins, directions, near,
                               step_size, num_samples, interp="highest"):
  """Plain PyTorch version of the head-off full emit: ops/eikonal.march
  with the grid's gradient and raw directions, as [B, S, 11]."""
  pos, dirs, dist, n, g = eik_ops.march(spec, data, origins, directions,
                                        near, step_size, num_samples,
                                        use_pred_grad=False,
                                        normalize_dirs=False, interp=interp)
  return torch.cat([pos, dirs, dist[..., None], n, g], dim=-1)


def march_full_plain(spec, data, origins, directions, near, step_size,
                     num_samples, interp="highest"):
  """The march without the so3 head, emitting the full trajectory.

  Args: as march_lean, without the jitter.

  Returns:
    [B, S, 11] float32 trajectory as march_full's (split_trajectory), each
    row the state before that step's update; its positions, directions
    and arclength are K1's bit for bit. The call reads nothing back from
    the card.
  """
  precision.check_interp(interp)
  dev = origins.device
  if dev.type == "cpu":
    return march_full_plain_reference(spec, data, origins, directions, near,
                                      step_size, num_samples, interp)
  if dev.type != "cuda":
    raise ValueError(f"march_full_plain runs on CUDA or CPU tensors, not "
                     f"{dev}")
  check_march_inputs("march_full_plain", spec, data, origins, directions)
  if num_samples < 1:
    raise ValueError(f"march_full_plain: num_samples must be at least 1, "
                     f"got {num_samples}")
  batch = origins.shape[0]
  geom = full_plain_launch_geometry(batch)
  lib = _library()
  traj = torch.empty((batch, num_samples, FULL_ROW), dtype=torch.float32,
                     device=dev)
  with torch.cuda.device(dev):
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.march_full_plain_launch(
        origins.data_ptr(), directions.data_ptr(), data.data_ptr(),
        traj.data_ptr(), batch, num_samples, *spec.ndim, near, step_size,
        *spec.nmin, *spec.ndelta, geom["rays_per_block"], geom["threads"],
        geom["smem_bytes"], precision.INTERP_CODES[interp], stream)
  if err != 0:
    raise RuntimeError(f"march_full_plain: kernel launch failed with CUDA "
                       f"error {err}")
  march_full_plain.launches += 1
  march_full_plain.arms[interp] += 1
  return traj


march_full_plain.launches = 0
march_full_plain.arms = collections.Counter()


# K2's launch geometry with the fp32 head (csrc/march_so3.cu): a cluster
# of SO3_CLUSTER CTAs marches SO3_RAYS rays, each CTA holding the columns
# [rank * 64, rank * 64 + 64) of hidden layers 1-3 of the head padded to
# width SO3_PAD_WIDTH and SO3_PAD_IN PE features, and the first hidden
# layer and the output layer whole; 8 lanes a ray, a warp 4 rays.
SO3_CLUSTER, SO3_RAYS, SO3_THREADS = 2, 16, 128
SO3_PAD_WIDTH, SO3_PAD_IN, SO3_DEG_LIMIT = 128, 60, 10
# With the bf16 head (csrc/march_so3.cu, namespace bfh): no cluster; a CTA
# of one 16-ray group or two 32-ray groups (8 lanes a ray), each running its
# head as one tensor-core tile on 4 warps, the whole head resident in K3's
# padded input-major bf16 layout (csrc/so3_bf16.cuh: SO3_BF16_ROWS rows of
# SO3_PAD_WIDTH, the PE padded to SO3_BF16_PE). SO3_BF16_SHAPES: the (rays
# a group, groups a CTA) it is built for, smallest CTA first.
SO3_BF16_SHAPES = ((16, 1), (32, 2))
SO3_BF16_PE = 64
SO3_BF16_ROWS = 2 * SO3_BF16_PE + 3 * SO3_PAD_WIDTH
# The -D switch of march_so3.cu's trial build, which writes the bf16
# head's pre-activations out (march_full_preacts).
PREACTS_TRIAL = ("K2_TRIAL_PREACTS",)


def so3_window(alpha, max_deg):
  """The annealed PE's [max_deg] window weights at annealing alpha.

  The path sampler embeds with alpha * max_deg
  (samplenerfro_tpu/models/path_sampler.py:_embed); this is the window
  ops/math.annealed_pos_enc applies, differentiable in alpha.
  """
  return math_ops.cosine_easing_window(0, max_deg - 1, max_deg,
                                       alpha * max_deg)


class So3Head(typing.NamedTuple):
  """The so3 head's configuration (gin VoxMLP.*,
  samplenerfro_tpu/models/path_sampler.py:161-180). The default is the
  shipped head, the one K2 and K3 compute: the annealed PE from degree 0
  and the Rodrigues residual."""
  annealed: bool = True
  use_residual: bool = True
  use_direct_output: bool = True
  normalized: bool = False

  def in_dim(self, max_deg):
    """The MLP's input width: the annealed PE's 6 max_deg, or the legacy
    pos_enc's 3 + 6 max_deg."""
    return 6 * max_deg if self.annealed else 3 + 6 * max_deg

  def check(self):
    """Raise NotImplementedError where the JAX head's _apply_head does."""
    if self.use_residual and self.normalized:
      raise NotImplementedError("VoxMLP.normalized = True with "
                                "VoxMLP.use_residual = True has no head")
    if not self.use_residual and not (self.normalized
                                      and self.use_direct_output):
      raise NotImplementedError(
          "VoxMLP.use_residual = False needs VoxMLP.normalized = True and "
          "VoxMLP.use_direct_output = True")


SHIPPED_HEAD = So3Head()


def so3_embed(head, p, alpha, max_deg):
  """The head's input encoding of points p [..., 3] (_embed,
  samplenerfro_tpu/models/path_sampler.py:161-167)."""
  if head.annealed:
    return math_ops.annealed_pos_enc(p, 0, max_deg, alpha * max_deg)
  return math_ops.pos_enc(p, 0, max_deg, legacy_posenc_order=True)


def so3_apply_head(head, raw, g):
  """The refined gradient from the MLP's raw output and the grid gradient
  g (_apply_head, samplenerfro_tpu/models/path_sampler.py:169-180)."""
  head.check()
  if head.use_residual:
    if head.use_direct_output:
      return eik_ops.rodrigues_rotate(raw, g)
    return eik_ops.spherical_residual(raw, g)
  return (torch.linalg.norm(g + 1e-6, dim=-1, keepdim=True)
          * math_ops.safe_l2_normalize(raw))


def so3_refine_fn(so3_params, alpha, max_deg, head=SHIPPED_HEAD,
                  dtype="float32"):
  """(p, g) -> refined g of the so3 head (its PE, the skip-MLP and its
  output head), as the plain marches call it; dtype "bfloat16" is K2's
  bf16 head (mlp_ops.apply_params with the bf16 rounding)."""
  rnd = None if precision.check_bwd_dtype(dtype) == "float32" else (
      precision.bf16)

  def refine(p, g):
    raw = mlp_ops.apply_params(so3_params, so3_embed(head, p, alpha,
                                                     max_deg), rnd=rnd)
    return so3_apply_head(head, raw, g)
  return refine


def so3_width(so3_params, max_deg):
  """Width of the so3 MLP; raises unless it is the shape K2 supports."""
  if len(so3_params) != 10:
    raise ValueError("so3 head must have 4 hidden layers and an output "
                     f"layer, got {len(so3_params) // 2} layers")
  in_dim, width = 6 * max_deg, so3_params[0].shape[0]
  shapes = [(width, in_dim), (width,), (width, width), (width,),
            (width, width), (width,), (width, width + in_dim), (width,),
            (3, width), (3,)]
  for i, (p, want) in enumerate(zip(so3_params, shapes)):
    if tuple(p.shape) != want or p.dtype != torch.float32:
      raise ValueError(f"so3 param {i}: {tuple(p.shape)} {p.dtype}, "
                       f"expected {want} float32")
  if width > SO3_PAD_WIDTH or not 1 <= max_deg <= SO3_DEG_LIMIT:
    raise ValueError(f"K2 takes width <= {SO3_PAD_WIDTH} and 1 <= max_deg "
                     f"<= {SO3_DEG_LIMIT}, got {width} and {max_deg}")
  return width


def march_full_reference(spec, data, origins, directions, near, step_size,
                         num_samples, so3_params, alpha, max_deg=10,
                         interp="highest", bwd_dtype="float32"):
  """Plain PyTorch version of K2: ops/eikonal.march with the so3 head.

  Returns the [B, S, 11] trajectory (pos, raw dir, arclength, n, grad n).
  """
  out = eik_ops.march(spec, data, origins, directions, near, step_size,
                      num_samples,
                      pred_grad_fn=so3_refine_fn(so3_params, alpha, max_deg,
                                                 dtype=bwd_dtype),
                      use_pred_grad=True, normalize_dirs=False,
                      interp=interp)
  pos, dirs, dist, n, g = out
  return torch.cat([pos, dirs, dist[..., None], n, g], dim=-1)


def so3_launch_geometry(batch, width, max_deg):
  """K2's launch for `batch` rays and a head of `width` at PE degree
  max_deg: cluster size, rays a cluster, clusters, CTAs, threads, dynamic
  shared bytes a CTA, each rank's columns [lo, hi) of the padded width in
  hidden layers 1-3 (`columns`), and the layers every rank holds whole
  (`whole`: the first hidden layer and the output layer).

  Raises ValueError, naming the limit, for a shape K2 does not take.
  """
  if batch < 1:
    raise ValueError(f"march_full: batch must be at least 1, got {batch}")
  if not 1 <= width <= SO3_PAD_WIDTH:
    raise ValueError(f"K2 takes a head of width 1 to {SO3_PAD_WIDTH}, got "
                     f"{width}")
  if not 1 <= max_deg <= SO3_DEG_LIMIT:
    raise ValueError(f"K2 takes 1 <= max_deg <= {SO3_DEG_LIMIT}, got "
                     f"{max_deg}")
  cols = SO3_PAD_WIDTH // SO3_CLUSTER
  w, i, r = SO3_PAD_WIDTH, SO3_PAD_IN, SO3_RAYS
  floats = (
      i * w                         # W0, whole
      + (2 * w + (w + i)) * cols    # W1..W3, this rank's columns
      + w + 3 * cols                # b0 whole, b1..b3's columns
      + 4 * w + 4                   # the output layer, whole
      + (i + 3 * w) * (r + 4)       # PE features, three activation
                                    # buffers (rows of r rays padded by 4)
      + 16                          # window
      + 2 * 2 * (SO3_THREADS // 32))  # two mbarriers a warp
  smem = 4 * floats
  if smem > SMEM_LIMIT:
    raise ValueError(f"K2 needs {smem} bytes of shared memory a CTA, over "
                     f"the {SMEM_LIMIT} a block may use")
  clusters = -(-batch // SO3_RAYS)
  return {"cluster": SO3_CLUSTER, "rays_per_cluster": SO3_RAYS,
          "clusters": clusters, "ctas": SO3_CLUSTER * clusters,
          "threads": SO3_THREADS, "smem_bytes": smem,
          "columns": [(k * cols, (k + 1) * cols)
                      for k in range(SO3_CLUSTER)],
          "whole": ["Dense_0", "Dense_out"]}


def so3_bf16_smem_bytes(rows, groups):
  """Dynamic shared bytes a CTA of K2's bf16 head with `groups` groups of
  `rows` rays (csrc/march_so3.cu, bfh::Smem)."""
  ld_h, ld_x = SO3_PAD_WIDTH + 8, SO3_BF16_PE + 8   # rows padded by 16 B
  helpers = rows * groups if so3_bf16_helpers(rows) else 1
  return (2 * (SO3_BF16_ROWS * ld_h             # the hidden layers, bf16
               + rows * groups * 2 * (ld_x + ld_h))  # PE, activations: 2
          + 4 * (4 * SO3_PAD_WIDTH              # b0 .. b3
                 + 4 * (SO3_PAD_WIDTH + 4) + 4  # the output layer, [o][k]
                 + 16                           # window
                 + 2 * 3 * helpers))            # the helpers' positions


def so3_bf16_helpers(rows):
  """Whether K2's bf16 head gives a CTA of groups of `rows` rays its
  helper warps (the next step's PE during the head): 16-ray groups."""
  return rows == 16


def so3_bf16_launch_geometry(batch, width, max_deg, sms, shape=None):
  """K2's launch with the bf16 head for `batch` rays, a head of `width` at
  PE degree max_deg, on a card of `sms` SMs: rays a group, groups a CTA
  (one CTA an SM: the resident head leaves room for no second), rays a
  CTA, CTAs, threads (8 a ray, twice that with helper warps), dynamic
  shared bytes a CTA. shape None picks 16-ray CTAs while one wave of them
  covers the batch (a step's latency sets the time: the batch spreads
  over the most SMs), else two 32-ray groups a CTA (the waves set it:
  the fewest).

  Raises ValueError, naming the limit, for a shape K2 does not take.
  """
  if batch < 1:
    raise ValueError(f"march_full: batch must be at least 1, got {batch}")
  if not 1 <= width <= SO3_PAD_WIDTH:
    raise ValueError(f"K2 takes a head of width 1 to {SO3_PAD_WIDTH}, got "
                     f"{width}")
  if not 1 <= max_deg <= SO3_DEG_LIMIT:
    raise ValueError(f"K2 takes 1 <= max_deg <= {SO3_DEG_LIMIT}, got "
                     f"{max_deg}")
  if sms < 1:
    raise ValueError(f"K2's bf16 head needs at least 1 SM, got {sms}")
  if shape is None:
    shape = next((sh for sh in SO3_BF16_SHAPES
                  if -(-batch // (sh[0] * sh[1])) <= sms),
                 SO3_BF16_SHAPES[-1])
  if tuple(shape) not in SO3_BF16_SHAPES:
    raise ValueError(f"K2's bf16 head runs (rays a group, groups a CTA) in "
                     f"{SO3_BF16_SHAPES}, got {shape}")
  rows, groups = shape
  smem = so3_bf16_smem_bytes(rows, groups)
  if smem > SMEM_LIMIT:
    raise ValueError(f"K2's bf16 head needs {smem} bytes of shared memory "
                     f"a CTA, over the {SMEM_LIMIT} a block may use")
  per = rows * groups
  threads = per * LEAN_LANES * (2 if so3_bf16_helpers(rows) else 1)
  return {"rays_per_group": rows, "groups": groups, "rays_per_cta": per,
          "ctas": -(-batch // per), "threads": threads, "smem_bytes": smem}


@functools.lru_cache(maxsize=None)
def sm_count(dev):
  """The SMs of the CUDA device `dev`."""
  return torch.cuda.get_device_properties(dev).multi_processor_count


def march_full(spec, data, origins, directions, near, step_size, num_samples,
               so3_params, alpha, max_deg=10, interp="highest",
               bwd_dtype="float32"):
  """The 'all'-stage forward march with the so3-refined gradient (K2).

  Args:
    spec, data, origins, directions, near, step_size, num_samples: as
      march_lean.
    so3_params: the so3 MLP's [W_0, b_0, ..., W_out, b_out]
      (ops/mlp.So3MLP.params()), float32 on the device of `origins`; K2
      reads them in place.
    alpha: annealing progress (float or 0-d tensor); the PE window runs
      at alpha * max_deg.
    max_deg: PE degrees (the MLP takes 6 * max_deg inputs).
    interp: the interpolation's precision (ops/precision.INTERPS).
    bwd_dtype: the head's arm: "float32", or "bfloat16" (its weights, PE
      features and activations rounded to bf16 in the kernel, which runs
      the hidden layers on tensor cores).

  Returns:
    [B, S, 11] float32 trajectory: pos 0:3, raw dir 3:6, arclength 6,
    n 7, grad n 8:11, each the state before that step's update. The call
    reads nothing back from the card.
  """
  precision.check_interp(interp)
  precision.check_bwd_dtype(bwd_dtype)
  dev = origins.device
  if dev.type == "cpu":
    return march_full_reference(spec, data, origins, directions, near,
                                step_size, num_samples, so3_params, alpha,
                                max_deg, interp, bwd_dtype)
  if dev.type != "cuda":
    raise ValueError(f"march_full runs on CUDA or CPU tensors, not {dev}")
  traj = _launch_so3(spec, data, origins, directions, near, step_size,
                     num_samples, so3_params, alpha, max_deg, interp,
                     bwd_dtype)
  march_full.launches += 1
  march_full.arms[(interp, bwd_dtype)] += 1
  return traj


march_full.launches = 0
march_full.arms = collections.Counter()


def march_full_preacts(spec, data, origins, directions, near, step_size,
                       num_samples, so3_params, alpha, max_deg=10,
                       interp="default"):
  """K2 with the bf16 head built with -DK2_TRIAL_PREACTS, on CUDA tensors:
  (the trajectory, (pre1, pre2, pre3)), each pre-activation [B, S, width]
  of hidden layers 1-3 as the kernel summed them, written at every step
  where the ray's group ran the head (every active ray-step; where it did
  not, NaN). The trajectory is the kernel's own; march_full's launch
  counts do not move."""
  if origins.device.type != "cuda":
    raise ValueError("march_full_preacts reads a kernel's sums: CUDA "
                     "tensors only")
  b, width = origins.shape[0], so3_params[0].shape[0]
  pre = torch.full((3, b, num_samples, width), float("nan"),
                   dtype=torch.float32, device=origins.device)
  traj = _launch_so3(spec, data, origins, directions, near, step_size,
                     num_samples, so3_params, alpha, max_deg, interp,
                     "bfloat16", pre=pre)
  return traj, (pre[0], pre[1], pre[2])


def _launch_so3(spec, data, origins, directions, near, step_size,
                num_samples, so3_params, alpha, max_deg, interp, bwd_dtype,
                pre=None, shape=None):
  """K2 in its arm on CUDA tensors; `pre`, the trial build's buffer;
  `shape`, the bf16 head's (rays a group, groups a CTA) where a
  measurement pins one of SO3_BF16_SHAPES (None: chosen from the batch)."""
  dev = origins.device
  check_march_inputs("march_full", spec, data, origins, directions)
  width = so3_width(so3_params, max_deg)
  for p in so3_params:
    if p.device != dev:
      raise ValueError(f"march_full: so3 params on {p.device}, rays on {dev}")
  batch = origins.shape[0]
  params = [p.detach().contiguous() for p in so3_params]
  if torch.is_tensor(alpha):
    alpha_t = alpha.to(device=dev, dtype=torch.float32, non_blocking=True)
  else:
    alpha_t = torch.full((), alpha, dtype=torch.float32, device=dev)
  window = so3_window(alpha_t, max_deg).detach().contiguous()
  traj = torch.empty((batch, num_samples, 11), dtype=torch.float32,
                     device=dev)
  if bwd_dtype == "bfloat16":
    geom = so3_bf16_launch_geometry(batch, width, max_deg, sm_count(dev),
                                    shape)
    lib = _so3_library(PREACTS_TRIAL if pre is not None else ())
    launch = lib.march_so3_bf16_launch
    extra = (pre.data_ptr() if pre is not None else None,)
    dims = (geom["rays_per_group"], geom["groups"], geom["ctas"],
            geom["threads"], geom["smem_bytes"])
  else:
    if shape is not None:
      raise ValueError("march_full: a pinned shape is the bf16 head's")
    geom = so3_launch_geometry(batch, width, max_deg)
    launch = _so3_library().march_so3_launch
    extra = ()
    dims = (geom["cluster"], geom["rays_per_cluster"], geom["ctas"],
            geom["threads"], geom["smem_bytes"])
  with torch.cuda.device(dev):
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = launch(
        origins.data_ptr(), directions.data_ptr(), data.data_ptr(),
        *[p.data_ptr() for p in params], window.data_ptr(), traj.data_ptr(),
        *extra, batch, num_samples, max_deg, width, *spec.ndim, near,
        step_size, *spec.nmin, *spec.ndelta, *dims,
        precision.INTERP_CODES[interp], stream)
  if err != 0:
    raise RuntimeError(f"march_full: kernel launch failed with CUDA error "
                       f"{err}")
  return traj


def split_trajectory(traj):
  """[B, S, 11] -> (pos, raw dirs, dist, n, grad n) views."""
  return (traj[..., 0:3], traj[..., 3:6], traj[..., 6], traj[..., 7:8],
          traj[..., 8:11])


def _so3_library(defines=()):
  lib = cuda_build.load("march_so3", defines)
  vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
  for fn, argtypes in (
      (lib.march_so3_launch, [vp] * 15 + [ci] * 7 + [cf] * 8 + [ci] * 6),
      (lib.march_so3_bf16_launch, [vp] * 16 + [ci] * 7 + [cf] * 8
       + [ci] * 6)):
    if fn.restype is not ci or not fn.argtypes:
      fn.argtypes = argtypes + [vp]
      fn.restype = ci
  return lib
