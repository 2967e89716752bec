"""The fused NerfMLP kernels: wrappers, plain versions, autograd Function.

K4, the forward (csrc/mlp_fwd.cu), replaces
samplenerfro_tpu/ops/pallas/mlp_kernel.py:_fwd_kernel; K5, the parameter
backward (csrc/mlp_bwd.cu), replaces its _bwd_kernel. Both run the whole
NerfMLP (trunk with the input skip, sigma head, bottleneck, condition
layer, rgb head) at the TPU kernel's rounding points (`_forward_tile`):
every product accumulates in fp32 and adds an fp32 bias, ReLU runs in
fp32, each activation is then stored in the compute type, the sigma column
and the rgb head stay fp32, and the bottleneck is rounded to the compute
type before it meets the condition. ReLU is hard-coded, whatever the
model's net_activation (the JAX kernel does the same; construct_nerf
refuses another activation with the fused path).

`fused_nerf_mlp` is the entry point the model calls. Its autograd Function
returns gradients for the MLP's weights only: the radiance stage's inputs
come from the frozen path sampler, and an input that requires grad raises.
`mlp_fwd` and `mlp_bwd` launch K4 and K5 for CUDA tensors and use the plain
versions only for CPU tensors. The Function packs the weights once a step
(pack_params) for both kernels. The JAX kernel's 128-lane padding of the
features and heads is a TPU layout and is not carried over.
"""

import collections
import contextlib
import ctypes
import math

import torch

from samplenerfro_torch.ops import cuda_build
from samplenerfro_torch.ops import math as math_ops

# The widest layer and the most feature or condition columns the CUDA
# kernels take (csrc/mlp_common.cuh: kMaxWidth, kMaxInputs), and their
# deepest trunk (kMaxLayers less the four heads).
MAX_WIDTH = 1024
MAX_INPUTS = 128
MAX_DEPTH = 20
IN_PAD = 32      # feature and condition widths padded to this in the kernels
OUT_COLS = 8     # the cotangent's columns, padded (csrc/mlp_common.cuh)
# Rows of a K5 super-tile: each block adds its weight gradients into its
# partial once per this many rows (csrc/mlp_bwd.cu). The warpgroup
# engine's are twice as many, so that the ship's train fine call (196,608
# rows, 1,490 a block) takes one and its partial is only stored.
SUPER_ROWS = 1024
SUPER_ROWS_WARPGROUP = 2048
# `-D` switches the kernels are built with: empty in use; the trial of
# debug/k5_scratch_cost.py sets one (csrc/mlp_bwd.cu).
TRIAL_DEFINES = ()

# The static geometry of a fused MLP: trunk depth and width, skip period,
# feature and condition widths, condition layer width, rgb and sigma
# channels, and pe = None (features given) or (pts_deg, dirs_deg) (raw
# [N, 3] points and view directions, encoded in the kernel).
MlpSpec = collections.namedtuple(
    "MlpSpec", ("depth", "width", "skip", "feat", "cond", "cond_width",
                "num_rgb", "num_sigma", "pe"))


def supports(feature_dim, cond_dim, net_depth, net_width, skip_layer,
             net_depth_condition, cond_width, num_rgb, num_sigma, pe=None):
  """Whether the fused kernels implement this NerfMLP configuration.

  The same answers as samplenerfro_tpu/ops/pallas/mlp_kernel.py:102-117.
  """
  if pe is not None and (feature_dim != 3 + 6 * pe[0]
                         or cond_dim != 3 + 6 * pe[1]):
    return False
  return (net_depth_condition == 1
          and net_width % 128 == 0 and cond_width % 128 == 0
          and num_rgb <= 8 - num_sigma and num_sigma >= 1
          and feature_dim <= 128 and cond_dim <= 128
          and net_depth >= 2
          and (net_depth - 1) % skip_layer != 0)


def skip_after(spec, i):
  """Whether trunk layer i's output gets the input features appended."""
  return i > 0 and i % spec.skip == 0


def layer_dims(spec):
  """[(inputs, outputs)] of the layers in nn.Linear order: trunk, sigma,
  bottleneck, condition, rgb."""
  dims = []
  for i in range(spec.depth):
    k = (spec.feat if i == 0 else
         spec.width + spec.feat if skip_after(spec, i - 1) else spec.width)
    dims.append((k, spec.width))
  return dims + [(spec.width, spec.num_sigma), (spec.width, spec.width),
                 (spec.width + spec.cond, spec.cond_width),
                 (spec.cond_width, spec.num_rgb)]


def mlp_spec(mlp, pe=None):
  """The MlpSpec of a port NerfMLP (models/mlp.py) with one condition
  layer; pe as in MlpSpec."""
  depth = mlp.net_depth
  layers = mlp.layers
  if not mlp.has_condition or len(layers) != depth + 4:
    raise ValueError("the fused MLP needs a NerfMLP with a view condition "
                     "and one condition layer")
  width = layers[0].out_features
  spec = MlpSpec(depth, width, mlp.skip_layer, layers[0].in_features,
                 layers[depth + 2].in_features - width,
                 layers[depth + 2].out_features,
                 layers[depth + 3].out_features,
                 layers[depth].out_features, pe)
  if pe is not None and (spec.feat, spec.cond) != (3 + 6 * pe[0],
                                                   3 + 6 * pe[1]):
    raise ValueError(f"pe degrees {pe} do not give the MLP's input widths "
                     f"{spec.feat} and {spec.cond}")
  return spec


def mlp_params(mlp):
  """A NerfMLP's flat parameter list [W_0, b_0, W_1, b_1, ...]."""
  return [p for layer in mlp.layers for p in (layer.weight, layer.bias)]


# The kernels' operands: every weight input-major (wkn, [in, out], the JAX
# kernel's layout) and output-major (wnk, [out, kp] with each row of `in`
# weights padded with zeros to kp = `in` rounded up to 16, so that rows
# start on 16 bytes for K5's dZ W^T products), each concatenated in layer
# order in the compute type, the biases concatenated in fp32, and the
# warpgroup engine's weight slabs (slab_pack; empty where the kernels run
# no warpgroup products).
Pack = collections.namedtuple("Pack", ("wkn", "wnk", "bias", "slabs"))

# The warpgroup engine's weight slabs (csrc/mlp_common.cuh: kSlabK,
# kSlabN): SLAB_K inputs of SLAB_N outputs, K-major, in the 128-byte
# swizzle of wgmma's shared-memory operands.
SLAB_K, SLAB_N = 64, 128
SLAB_BYTES = SLAB_K * SLAB_N * 2
# Shared memory a block may use, and the most slabs the feed's ring holds
# (csrc/mlp_common.cuh: kMaxSmem, kMaxFeedStages).
MAX_SMEM = 232448
MAX_FEED_STAGES = 4


def wnk_row_len(k):
  """The row length of a layer with k inputs in the wnk pack."""
  return -(-k // 16) * 16


def pack_params(params, dtype):
  """The Pack of the flat [W_0, b_0, ...] (nn.Linear, W [out, in])."""
  weights = [w.detach() for w in params[0::2]]
  wkn = torch.cat([w.t().reshape(-1) for w in weights]).to(dtype)
  wnk = torch.cat([
      torch.nn.functional.pad(w, (0, wnk_row_len(w.shape[1]) - w.shape[1]))
      .reshape(-1) for w in weights]).to(dtype)
  bias = torch.cat([b.detach().reshape(-1) for b in params[1::2]]).float()
  spec = _params_geometry(params)
  slabs = (slab_pack(spec, params) if warpgroup(spec, dtype) else
           torch.empty((0,), dtype=dtype, device=wkn.device))
  return Pack(wkn.contiguous(), wnk.contiguous(), bias.contiguous(), slabs)


def _params_geometry(params):
  """An MlpSpec of the layer shapes of a flat [W_0, b_0, ...], enough for
  wide() and slab_pack (its skip and pe, which neither reads, set to 1 and
  None)."""
  w = params[0::2]
  d = len(w) - 4
  width, cond_width = w[0].shape[0], w[d + 2].shape[0]
  return MlpSpec(d, width, 1, w[0].shape[1], w[d + 2].shape[1] - width,
                 cond_width, w[d + 3].shape[0], w[d].shape[0], None)


def warpgroup(spec, dtype):
  """Whether K4 and K5 run this geometry's layers, and K5 its cotangents,
  as warpgroup products (wgmma) on fed weight slabs: bf16 tiles that are
  not wide. Wide bf16 tiles run mma.sync, fp32 the CUDA cores."""
  return dtype == torch.bfloat16 and not wide(spec)


def slab_products(spec):
  """[(layer, outputs, inputs, transposed)] of the products the slab pack
  holds, in the kernels' order: the forward's layers (trunk, bottleneck,
  condition layer: `outputs` x `inputs` of weight [out, in]), then K5's
  cotangents (the condition layer's, the bottleneck's, the trunk's from
  the last to the second: the first `width` inputs of the layer are the
  product's outputs and its outputs the product's k, weight transposed)."""
  d, w = spec.depth, spec.width
  dims = layer_dims(spec)
  fwd = [(l, dims[l][1], dims[l][0], False)
         for l in list(range(d)) + [d + 1, d + 2]]
  cot = [(l, w, dims[l][1], True) for l in [d + 2, d + 1]
         + list(range(d - 1, 0, -1))]
  return fwd + cot


def slab_counts(spec):
  """(forward slabs, cotangent slabs) of the slab pack (csrc/
  mlp_common.cuh: Spec.fwd_slabs, Spec.cot_slabs)."""
  counts = [0, 0]
  for _, n, k, transposed in slab_products(spec):
    counts[transposed] += -(-k // SLAB_K) * (n // SLAB_N)
  return tuple(counts)


def slab_pack(spec, params):
  """The warpgroup engine's bf16 weight slabs, flat, in the order K4 and
  K5 take them (slab_products): per product, per panel of SLAB_N outputs,
  per SLAB_K-slab of its inputs (zero past them), a [SLAB_N, SLAB_K]
  K-major block whose element (c, k) sits at c * SLAB_K + ((k // 8) ^
  (c % 8)) * 8 + k % 8 (csrc/mlp_common.cuh: desc_sw128)."""
  if wide(spec):
    raise ValueError("slab_pack: a wide geometry (layers past 256 or more "
                     "than 128 padded input columns) runs no warpgroup "
                     "products")
  weights = [w.detach() for w in params[0::2]]
  dev = weights[0].device
  chunk = torch.arange(8, device=dev)
  # Stored chunk p of row c holds chunk p ^ (c % 8).
  swz = chunk[None, :] ^ (torch.arange(SLAB_N, device=dev) % 8)[:, None]
  out = []
  for l, _, _, transposed in slab_products(spec):
    w = weights[l].t()[:spec.width] if transposed else weights[l]
    n, k = w.shape
    kp = -(-k // SLAB_K) * SLAB_K
    w = torch.nn.functional.pad(w.to(torch.bfloat16), (0, kp - k))
    w = w.reshape(n // SLAB_N, SLAB_N, kp // SLAB_K, 8, 8).transpose(1, 2)
    w = torch.gather(w, 3, swz[None, None, :, :, None].expand(w.shape))
    out.append(w.reshape(-1))
  return torch.cat(out).contiguous()


def shared_bytes(spec, dtype, kernel):
  """(bytes, feed stages) of the shared memory a block of `kernel`
  ("mlp_fwd" or "mlp_bwd") takes (csrc/mlp_common.cuh: tile_bytes,
  csrc/mlp_bwd.cu: smem_bytes), the feed holding as many slabs as fit up
  to MAX_FEED_STAGES (0 without the warpgroup engine)."""
  if kernel not in ("mlp_fwd", "mlp_bwd"):
    raise ValueError(f"shared_bytes: kernel {kernel!r} is not mlp_fwd or "
                     f"mlp_bwd")
  size = 2 if dtype == torch.bfloat16 else 4
  rows, pad = tile_rows(spec, dtype), 16 // size
  maxw = max(spec.width, spec.cond_width)
  bufs = size * (2 * rows * (maxw + pad) + rows * (
      feature_cols(spec.feat) + pad + feature_cols(spec.cond) + pad))
  group = warpgroup(spec, dtype)
  extra = 0
  if kernel == "mlp_bwd":
    extra = (4 + size) * rows * OUT_COLS + 4 * (8 * SLAB_N if group
                                                 else 2 * 256)
    if group:  # the sigma head's weights, copied
      extra += size * spec.num_sigma * spec.width
  if not group:
    slab = 16 if size == 4 else 32
    return bufs + size * 3 * slab * (min(maxw, 256) + pad) + extra, 0
  for stages in range(MAX_FEED_STAGES, 1, -1):
    total = 1024 + stages * SLAB_BYTES + 128 + bufs + extra
    if total <= MAX_SMEM or stages == 2:
      return total, stages


def unpack_grads(spec, flat):
  """K5's flat fp32 gradients (input-major weights, then biases) -> the
  flat [dW_0, db_0, ...] in nn.Linear's layout."""
  dims = layer_dims(spec)
  nweights = sum(k * n for k, n in dims)
  grads, w_off, b_off = [], 0, nweights
  for k, n in dims:
    grads.append(flat[w_off:w_off + k * n].reshape(k, n).t().contiguous())
    grads.append(flat[b_off:b_off + n].clone())
    w_off += k * n
    b_off += n
  return grads


@contextlib.contextmanager
def _full_fp32():
  """fp32 matrix products without TF32 on the card, as the plain versions
  are defined (PyTorch's default; set and restored here)."""
  saved = torch.backends.cuda.matmul.allow_tf32
  torch.backends.cuda.matmul.allow_tf32 = False
  try:
    yield
  finally:
    torch.backends.cuda.matmul.allow_tf32 = saved


def _rnd(t, dtype):
  """Round fp32 values to the compute type and back: exact bf16 operands,
  whose products fp32 then holds exactly."""
  return t if dtype == torch.float32 else t.to(dtype).float()


def _featurize(spec, x, cond, dtype):
  """The kernels' inputs, in fp32 holding compute-type values: x and cond
  as given, or (pe) their encodings (ops/math.pe_cols)."""
  if spec.pe is not None:
    x = math_ops.pe_cols(x, spec.pe[0])
    cond = math_ops.pe_cols(cond, spec.pe[1])
  return _rnd(x.float(), dtype), _rnd(cond.float(), dtype)


def _forward(spec, params, x0, cond, dtype):
  """_forward_tile on all rows: (weights [in, out], layer inputs, stored
  activations, trunk output, [bottleneck, cond], condition activation,
  sigma, rgb)."""
  w = [_rnd(p.float(), dtype).t() for p in params[0::2]]
  b = [p.float() for p in params[1::2]]
  d = spec.depth
  augs, acts, h = [], [], x0
  for i in range(d):
    augs.append(h)
    a = _rnd(torch.relu(h @ w[i] + b[i]), dtype)
    acts.append(a)
    h = torch.cat([a, x0], dim=-1) if skip_after(spec, i) else a
  sigma = h @ w[d] + b[d]
  bn = _rnd(h @ w[d + 1] + b[d + 1], dtype)
  xcat = torch.cat([bn, cond], dim=-1)
  a_c = _rnd(torch.relu(xcat @ w[d + 2] + b[d + 2]), dtype)
  rgb = a_c @ w[d + 3] + b[d + 3]
  return w, augs, acts, h, xcat, a_c, sigma, rgb


def fused_nerf_mlp_reference(spec, params, x, cond, dtype):
  """Plain PyTorch version of K4: (raw rgb [N, num_rgb], sigma
  [N, num_sigma]), fp32.

  bf16 is emulated by rounding operands to bf16 and multiplying in fp32
  with TF32 off, so the products are exact and only the order of the sums
  differs from the kernel. Differentiable in params (torch autograd).
  """
  with _full_fp32():
    x0, c = _featurize(spec, x, cond, dtype)
    out = _forward(spec, params, x0, c, dtype)
  return out[7], out[6]


def _activations(spec, acts, bn, a_c):
  """{name: value} of the stored activations (forward_activations)."""
  out = {f"act{i}": a for i, a in enumerate(acts)}
  out.update(bn=bn, ac=a_c)
  return out


def fused_nerf_mlp_bwd_reference(spec, params, x, cond, drgb, dsigma, dtype,
                                 stored=None, at=None):
  """Plain PyTorch version of K5: the recompute and backward of
  samplenerfro_tpu/ops/pallas/mlp_kernel.py:268-317.

  Returns the flat fp32 [dW_0, db_0, ...] in nn.Linear's layout. ReLU masks
  come from the stored activations; each pre-activation cotangent is
  rounded to the compute type before its products, and each bias gradient
  sums the unrounded cotangent. stored, a dict, receives the recomputed
  activations as mlp_fwd's `acts` names them. at, such a dict (a kernel's
  `acts`), replaces the recomputed activations: the backward then runs at
  those values and ReLU masks, which replays the kernel's masks where a
  pre-activation at 0 rounds to the other side in another summation
  order.
  """
  rnd = lambda t: _rnd(t, dtype)
  d, width = spec.depth, spec.width
  gw, gb = [None] * (d + 4), [None] * (d + 4)
  with torch.no_grad(), _full_fp32():
    x0, c = _featurize(spec, x, cond, dtype)
    w, augs, acts, h, xcat, a_c, _, _ = _forward(spec, params, x0, c, dtype)
    if at is not None:
      acts = [at[f"act{i}"].float() for i in range(d)]
      augs = [x0] + [torch.cat([acts[i - 1], x0], dim=-1)
                     if skip_after(spec, i - 1) else acts[i - 1]
                     for i in range(1, d)]
      h = acts[d - 1]
      xcat = torch.cat([at["bn"].float(), c], dim=-1)
      a_c = at["ac"].float()
    if stored is not None:
      stored.update({k: v.to(dtype) for k, v in _activations(
          spec, acts, xcat[:, :width], a_c).items()})
    drgb, dsigma = drgb.float(), dsigma.float()
    drgb16 = rnd(drgb)
    gw[d + 3], gb[d + 3] = a_c.t() @ drgb16, drgb.sum(0)
    da_c = (drgb16 @ w[d + 3].t()) * (a_c > 0)
    da_c16 = rnd(da_c)
    gw[d + 2], gb[d + 2] = xcat.t() @ da_c16, da_c.sum(0)
    dbn = (da_c16 @ w[d + 2].t())[:, :width]
    dheads = torch.cat([dsigma, dbn], dim=-1)
    dheads16 = rnd(dheads)
    dw_heads = h.t() @ dheads16
    gw[d], gb[d] = dw_heads[:, :spec.num_sigma], dsigma.sum(0)
    gw[d + 1], gb[d + 1] = dw_heads[:, spec.num_sigma:], dbn.sum(0)
    dh = dheads16 @ torch.cat([w[d], w[d + 1]], dim=-1).t()
    for i in range(d - 1, -1, -1):
      dpre = dh * (acts[i] > 0)
      dpre16 = rnd(dpre)
      gw[i], gb[i] = augs[i].t() @ dpre16, dpre.sum(0)
      if i > 0:
        dh = (dpre16 @ w[i].t())[:, :width]
  return [g for pair in zip(gw, gb) for g in (pair[0].t().contiguous(),
                                              pair[1])]


def wide(spec):
  """Whether the kernels run this geometry's tiles at a quarter of the rows
  (csrc/mlp_common.cuh: Spec.wide): layers wider than 256, or features
  and condition past 128 columns together."""
  return (max(spec.width, spec.cond_width) > 256
          or feature_cols(spec.feat) + feature_cols(spec.cond) > 128)


def tile_rows(spec, dtype):
  """Rows of K4's and K5's row tile (csrc/mlp_common.cuh:Policy): 128 in
  bf16, 64 in fp32, a quarter of that for a wide geometry."""
  rows = 128 if dtype == torch.bfloat16 else 64
  return rows // 4 if wide(spec) else rows


def kernel_limits(spec):
  """The reasons the CUDA kernels refuse spec, empty when they take it."""
  out = []
  for name, w in (("width", spec.width), ("cond_width", spec.cond_width)):
    if w % 128 or not 128 <= w <= MAX_WIDTH:
      out.append(f"{name} {w} is not a multiple of 128 up to {MAX_WIDTH}")
  for name, k in (("features", spec.feat), ("condition", spec.cond)):
    if k > MAX_INPUTS:
      out.append(f"{k} {name} columns are more than {MAX_INPUTS}")
  if not 2 <= spec.depth <= MAX_DEPTH:
    out.append(f"depth {spec.depth} is not in 2 .. {MAX_DEPTH}")
  if spec.num_rgb + spec.num_sigma > OUT_COLS:
    out.append(f"{spec.num_rgb + spec.num_sigma} output channels are more "
               f"than {OUT_COLS}")
  return out


def _check(spec, x, cond, params, who):
  """Raise ValueError unless the kernels take these tensors."""
  dev = x.device
  rows = x.shape[0]
  fx, fc = (3, 3) if spec.pe is not None else (spec.feat, spec.cond)
  for name, t, shape in (("x", x, (rows, fx)), ("cond", cond, (rows, fc))):
    if t.device != dev or t.dtype != torch.float32:
      raise ValueError(f"{who}: {name} must be float32 on {dev}, got "
                       f"{t.dtype} on {t.device}")
    if tuple(t.shape) != shape or not t.is_contiguous():
      raise ValueError(f"{who}: {name} must be contiguous {shape}, got "
                       f"{tuple(t.shape)}")
  for (k, n), w, b in zip(layer_dims(spec), params[0::2], params[1::2]):
    if tuple(w.shape) != (n, k) or tuple(b.shape) != (n,):
      raise ValueError(f"{who}: a layer is {tuple(w.shape)}, expected "
                       f"{(n, k)}")
    if w.device != dev or b.device != dev:
      raise ValueError(f"{who}: weights on {w.device}, inputs on {dev}")
  limits = kernel_limits(spec)
  if limits:
    raise ValueError(f"{who}: the CUDA kernels take layer widths that are "
                     f"multiples of 128 up to {MAX_WIDTH}, at most "
                     f"{MAX_INPUTS} feature and condition columns each and "
                     f"a trunk of at most {MAX_DEPTH} layers: "
                     + "; ".join(limits))


def feature_cols(k):
  """The columns the kernels keep for k input features or condition
  values (csrc/mlp_common.cuh: Spec.fp, Spec.cp)."""
  return -(-k // IN_PAD) * IN_PAD


def _spec_args(spec, dtype):
  nweights = sum(k * n for k, n in layer_dims(spec))
  return (int(dtype == torch.bfloat16), spec.depth, spec.width, spec.skip,
          spec.feat, spec.cond, spec.cond_width, spec.num_rgb,
          spec.num_sigma, int(spec.pe is not None), nweights)


def _pack_for(spec, params, dtype, pack):
  """pack, or a fresh one; raises if a given pack does not fit."""
  if pack is None:
    return pack_params(params, dtype)
  dims = layer_dims(spec)
  slabs = sum(slab_counts(spec)) if warpgroup(spec, dtype) else 0
  want = (sum(k * n for k, n in dims),
          sum(wnk_row_len(k) * n for k, n in dims), sum(n for _, n in dims),
          slabs * SLAB_K * SLAB_N)
  got = tuple(t.numel() for t in pack)
  if (got != want or pack.wkn.dtype != dtype or pack.wnk.dtype != dtype
      or pack.bias.dtype != torch.float32 or pack.slabs.dtype != dtype
      or any(t.device != params[0].device for t in pack)):
    raise ValueError(f"a pack of {got} {pack.wkn.dtype} values on "
                     f"{pack.wkn.device} does not fit this MLP in {dtype}")
  return pack


def scratch_sections(spec):
  """[(name, first column, width)] of the values K5 stores for a row, in
  the order of csrc/mlp_bwd.cu:Sections: the inputs (x0, cond), the
  rounded cotangent (d16), the stored activations (act0.., bn, ac) and
  the rounded cotangents (dpre0.., dbn, dac)."""
  w, d, cw = spec.width, spec.depth, spec.cond_width
  widths = ([("x0", feature_cols(spec.feat)),
             ("cond", feature_cols(spec.cond)), ("d16", OUT_COLS)]
            + [(f"act{i}", w) for i in range(d)]
            + [("bn", w), ("ac", cw)] + [(f"dpre{i}", w) for i in range(d)]
            + [("dbn", w), ("dac", cw)])
  out, col = [], 0
  for name, width in widths:
    out.append((name, col, width))
    col += width
  return out


def scratch_row_elems(spec):
  """Values K5 stores for a row."""
  return sum(width for _, _, width in scratch_sections(spec))


def stored_values(spec, stash, rows):
  """{name: [rows, width]} of what K5 stored for every row, from the
  `stash` of an mlp_bwd call whose super-tiles held each block's rows (on
  CPU tensors: the plain version's activations)."""
  if "values" in stash:
    return stash["values"]
  scratch, blocks, sr = stash["scratch"], stash["blocks"], stash["super_rows"]
  bounds = [rows * b // blocks for b in range(blocks + 1)]
  if max(hi - lo for lo, hi in zip(bounds, bounds[1:])) > sr:
    raise ValueError("the call's super-tiles did not hold a block's rows")
  return {name: torch.cat([
      scratch[b, sr * col:sr * col + (hi - lo) * width].view(hi - lo, width)
      for b, (lo, hi) in enumerate(zip(bounds, bounds[1:]))])
          for name, col, width in scratch_sections(spec)}


def default_super_rows(spec, dtype):
  """mlp_bwd's super-tile rows: SUPER_ROWS_WARPGROUP for the warpgroup
  engine, else SUPER_ROWS."""
  return SUPER_ROWS_WARPGROUP if warpgroup(spec, dtype) else SUPER_ROWS


def _dtype_of(dtype):
  if dtype not in (torch.float32, torch.bfloat16):
    raise ValueError(f"the fused MLP computes in float32 or bfloat16, not "
                     f"{dtype}")
  return dtype


def forward_activations(spec):
  """[(name, first column, width)] of the activations K4 writes for a row
  with `acts` (csrc/mlp_fwd.cu): the trunk's, the bottleneck's, the
  condition layer's, named as stored_values names them."""
  w = spec.width
  return ([(f"act{i}", i * w, w) for i in range(spec.depth)]
          + [("bn", spec.depth * w, w),
             ("ac", (spec.depth + 1) * w, spec.cond_width)])


def mlp_fwd(spec, params, x, cond, dtype, pack=None, acts=None):
  """K4: (raw rgb [N, num_rgb], sigma [N, num_sigma]) in fp32.

  Args:
    spec: MlpSpec.
    params: the NerfMLP's flat [W_0, b_0, ...] (mlp_params).
    x: [N, feat] features, or [N, 3] raw points when spec.pe is set.
    cond: [N, cond] view encodings, or [N, 3] raw view directions.
    dtype: compute type, torch.float32 or torch.bfloat16.
    pack: pack_params(params, dtype) when the caller has it, else made
      here (CUDA only; the plain version reads params).
    acts: a dict (CUDA only) that receives {name: [N, width]} of every
      stored activation, in the compute type (forward_activations).
  """
  dtype = _dtype_of(dtype)
  dev = x.device
  if dev.type == "cpu":
    if acts is None:
      return fused_nerf_mlp_reference(spec, params, x, cond, dtype)
    with _full_fp32():
      x0, c = _featurize(spec, x, cond, dtype)
      _, _, stored, _, xcat, a_c, sigma, rgb = _forward(spec, params, x0, c,
                                                        dtype)
    acts.update({k: v.detach().to(dtype) for k, v in _activations(
        spec, stored, xcat[:, :spec.width], a_c).items()})
    return rgb, sigma
  if dev.type != "cuda":
    raise ValueError(f"mlp_fwd runs on CUDA or CPU tensors, not {dev}")
  _check(spec, x, cond, params, "mlp_fwd")
  wkn, wnk, bias, slabs = _pack_for(spec, params, dtype, pack)
  rows, out_dim = x.shape[0], spec.num_rgb + spec.num_sigma
  out = torch.empty((rows, out_dim), dtype=torch.float32, device=dev)
  stored = None
  if acts is not None:
    per_row = (spec.depth + 1) * spec.width + spec.cond_width
    stored = torch.empty((rows, per_row), dtype=dtype, device=dev)
  lib = _library("mlp_fwd")
  with torch.cuda.device(dev):
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.mlp_fwd_launch(x.data_ptr(), cond.data_ptr(), wkn.data_ptr(),
                             wnk.data_ptr(), wnk.numel(),
                             _ptr(slabs), slabs.numel() // (SLAB_K * SLAB_N),
                             bias.data_ptr(), out.data_ptr(),
                             stored.data_ptr() if stored is not None else None,
                             rows, *_spec_args(spec, dtype), stream)
  if err != 0:
    raise RuntimeError(f"mlp_fwd: kernel launch failed with CUDA error "
                       f"{err}")
  mlp_fwd.launches += 1
  if acts is not None:
    acts.update({name: stored[:, col:col + width]
                 for name, col, width in forward_activations(spec)})
  return out[:, :spec.num_rgb], out[:, spec.num_rgb:]


mlp_fwd.launches = 0


def mlp_bwd(spec, params, x, cond, drgb, dsigma, dtype, pack=None,
            super_rows=None, stash=None):
  """K5: the flat fp32 [dW_0, db_0, ...] (nn.Linear layout) from the
  cotangents of mlp_fwd's outputs; arguments as mlp_fwd. super_rows, a
  multiple of the tile's rows, sizes the super-tiles over which each
  block sums its weight gradients before adding them into its partial.
  stash, a dict, receives the call's scratch, blocks and super_rows
  (for stored_values; on CPU tensors, the plain version's activations)."""
  dtype = _dtype_of(dtype)
  dev = x.device
  if dev.type == "cpu":
    stored = None
    if stash is not None:
      stored = stash.setdefault("values", {})
    return fused_nerf_mlp_bwd_reference(spec, params, x, cond, drgb, dsigma,
                                        dtype, stored=stored)
  if dev.type != "cuda":
    raise ValueError(f"mlp_bwd runs on CUDA or CPU tensors, not {dev}")
  _check(spec, x, cond, params, "mlp_bwd")
  rows = x.shape[0]
  dout = torch.cat([drgb, dsigma], dim=-1).float().contiguous()
  if tuple(dout.shape) != (rows, spec.num_rgb + spec.num_sigma):
    raise ValueError(f"mlp_bwd: cotangents of shape {tuple(drgb.shape)} "
                     f"and {tuple(dsigma.shape)} do not fit {rows} rows")
  tile = tile_rows(spec, dtype)
  if super_rows is None:
    super_rows = default_super_rows(spec, dtype)
  if super_rows <= 0 or super_rows % tile:
    raise ValueError(f"mlp_bwd: super_rows must be a positive multiple of "
                     f"{tile}, got {super_rows}")
  wkn, wnk, bias, slabs = _pack_for(spec, params, dtype, pack)
  count = wkn.numel() + bias.numel()
  if rows == 0:
    return unpack_grads(spec, torch.zeros((count,), dtype=torch.float32,
                                          device=dev))
  blocks = min(torch.cuda.get_device_properties(dev).multi_processor_count,
               math.ceil(rows / tile))
  # A block's rows, rounded up to tiles, if fewer than a super-tile.
  super_rows = min(super_rows, -(-math.ceil(rows / blocks) // tile) * tile)
  scratch = torch.empty((blocks, super_rows * scratch_row_elems(spec)),
                        dtype=dtype, device=dev)
  partial = torch.empty((blocks, count), dtype=torch.float32, device=dev)
  grads = torch.empty((count,), dtype=torch.float32, device=dev)
  lib = _library("mlp_bwd")
  with torch.cuda.device(dev):
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.mlp_bwd_launch(
        x.data_ptr(), cond.data_ptr(), dout.data_ptr(), wkn.data_ptr(),
        wnk.data_ptr(), _ptr(slabs), slabs.numel() // (SLAB_K * SLAB_N),
        bias.data_ptr(), scratch.data_ptr(),
        partial.data_ptr(), grads.data_ptr(), rows, blocks, super_rows,
        *_spec_args(spec, dtype), wnk.numel(), stream)
  if err != 0:
    raise RuntimeError(f"mlp_bwd: kernel launch failed with CUDA error "
                       f"{err}")
  if stash is not None:
    stash.update(scratch=scratch, blocks=blocks, super_rows=super_rows)
  mlp_bwd.launches += 1
  return unpack_grads(spec, grads)


mlp_bwd.launches = 0


class FusedNerfMLP(torch.autograd.Function):
  """K4 forward, K5 backward; gradients for the weights only."""

  @staticmethod
  def forward(ctx, spec, dtype, x, cond, *params):
    if x.requires_grad or cond.requires_grad:
      raise ValueError("the fused MLP gives no input gradients: its inputs "
                       "must not require grad (the radiance stage's come "
                       "from the frozen path sampler)")
    ctx.spec, ctx.dtype = spec, dtype
    ctx.save_for_backward(x, cond, *params)
    # The kernels' operands, packed once for K4 and K5 of this step (the
    # plain versions on CPU tensors read params and ignore it).
    ctx.pack = pack_params(params, dtype)
    return mlp_fwd(spec, list(params), x, cond, dtype, pack=ctx.pack)

  @staticmethod
  def backward(ctx, drgb, dsigma):
    x, cond, *params = ctx.saved_tensors
    grads = mlp_bwd(ctx.spec, params, x, cond, drgb, dsigma, ctx.dtype,
                    pack=ctx.pack)
    ctx.pack = None
    return (None, None, None, None, *grads)


def fused_nerf_mlp(mlp, x, cond, *, dtype, pe=None):
  """The fused NerfMLP apply: (raw rgb [N, num_rgb], sigma [N, num_sigma]).

  Args:
    mlp: a port NerfMLP (models/mlp.py) with a view condition.
    x: [N, feat] point features, or with pe [N, 3] raw points.
    cond: [N, cond] view encodings, or with pe [N, 3] raw view directions.
    dtype: compute type, torch.float32 or torch.bfloat16.
    pe: None, or (pts_deg, dirs_deg) to encode the raw inputs in the
      kernel with the non-legacy positional encoding.

  Differentiable in the MLP's parameters only (K5); x and cond must not
  require grad.
  """
  spec = mlp_spec(mlp, pe)
  return FusedNerfMLP.apply(spec, dtype, x.contiguous(), cond.contiguous(),
                            *mlp_params(mlp))


def _ptr(t):
  """A tensor's address for a kernel, None for an empty one."""
  return t.data_ptr() if t.numel() else None


def _library(name):
  lib = cuda_build.load(name, TRIAL_DEFINES)
  fn = getattr(lib, f"{name}_launch")
  if fn.restype is not ctypes.c_int or not fn.argtypes:
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    spec = [ci] * 10 + [cl]
    if name == "mlp_fwd":
      fn.argtypes = ([vp] * 4 + [cl, vp, cl] + [vp] * 3 + [cl] + spec
                     + [vp])
    else:
      fn.argtypes = ([vp] * 6 + [cl] + [vp] * 4 + [cl, ci, ci] + spec
                     + [cl, vp])
    fn.restype = ci
  return lib
