"""Where the fused MLP's bf16 kernels round apart from their plain versions.

K4 and K5 (csrc/mlp_fwd.cu, csrc/mlp_bwd.cu) multiply exact bf16 products
and sum them in fp32, as the plain versions (ops/mlp_kernel.py) do, but in
another order: on tensor cores, the warpgroup engine keeps each product's
running sum in wgmma's accumulator, the mma.sync engine (wide tiles) sums
each k16 step from zero and adds it in fp32. Every stored activation and
cotangent is then rounded to bf16, so a sum that lands on the other side
of a bf16 rounding boundary stores the other neighbour (a flip), which
every later layer of that row carries. The forward recomputes the outputs
whose sum lands near a rounding midpoint in the plain version's k order,
which removes most of its flips; the cotangents keep the tensor core's.
K5 recomputes K4's forward through the same code, so it differentiates
K4's activations bit for bit (F2 = 0); held against the plain backward
taken at those activations (fused_nerf_mlp_bwd_reference(at=)) it stays
inside its tolerance, while free-running the forward's remaining flips
and the cotangents' move it past.

stage_report compares K5's stored values (mlp_kernel.stored_values) with
the plain version's, stage by stage, and both with a float64 twin of the
plain version fed each side's own bf16 operands: how far each side rounds
from exact sums, and how far the two chains have drifted apart. Then each
layer's weight gradient, in units of the K5 bf16 tolerance.

    python -m samplenerfro_torch.debug.mlp_rounding [--rows=196608]
    python -m samplenerfro_torch.debug.mlp_rounding --digests

The first runs that report at the ship width on random samples, with
K4-bf16's error against its plain version, K5-bf16's ratio to its
tolerance free-running and at K4's activations, their times and the F2
count (forward_disagreement). --digests prints sha256 digests of K4 in
fp32 (fed and pe) at the render's fine-call rows (1,572,864) and of K5 in
fp32 at the train fine call's, on seeded inputs; it uses only mlp_fwd and
mlp_bwd, so a copy of this file run in an older checkout gives that
tree's digests. Both need a CUDA card.
"""

import argparse
import hashlib

import numpy as np
import torch

from samplenerfro_torch.models import mlp as mlp_modules
from samplenerfro_torch.ops import math as math_ops
from samplenerfro_torch.ops import mlp_kernel

# K5-bf16's tolerance: 2e-3 of each plain tensor's largest |value|
# (chip_smoke.py, tests/test_torch_cuda.py).
K5_BF16_SCALE = 2e-3
# The render's fine call: 8192 rays x 192 samples.
RENDER_ROWS = 1572864


def stage_out(spec, w, b, src, name, acc):
  """One stage of K5's walk (forward then back) computed from src's
  stored bf16 values (stored_values' names) with products summed in
  `acc` (float32: the plain version's arithmetic; float64: its twin),
  rounded to bf16 where the kernel rounds. w: [in, out] weights."""
  d, width, nr = spec.depth, spec.width, spec.num_rgb
  r16 = lambda t: t.to(torch.bfloat16).to(acc)
  g = lambda key: src[key].to(acc)
  x0 = g("x0")[:, :spec.feat]
  if name.startswith("act"):
    i = int(name[3:])
    a = x0 if i == 0 else g(f"act{i - 1}")
    if i > 0 and mlp_kernel.skip_after(spec, i - 1):
      a = torch.cat([a, x0], -1)
    return r16(torch.relu(a @ w[i] + b[i]))
  if name == "bn":
    return r16(g(f"act{d - 1}") @ w[d + 1] + b[d + 1])
  if name == "ac":
    a = torch.cat([g("bn"), g("cond")[:, :spec.cond]], -1)
    return r16(torch.relu(a @ w[d + 2] + b[d + 2]))
  d16 = g("d16")
  if name == "dac":
    return r16((d16[:, :nr] @ w[d + 3].t()) * (g("ac") > 0))
  if name == "dbn":
    return r16((g("dac") @ w[d + 2].t())[:, :width])
  i = int(name[4:])
  if i == d - 1:
    heads = torch.cat([d16[:, nr:nr + spec.num_sigma], g("dbn")], -1)
    dh = heads @ torch.cat([w[d], w[d + 1]], -1).t()
  else:
    dh = (g(f"dpre{i + 1}") @ w[i + 1].t())[:, :width]
  return r16(dh * (g(f"act{i}") > 0))


def stage_dw(spec, src, acc):
  """Every layer's dW ([in, out]) from src's stored bf16 values, summed in
  `acc`."""
  d, nr, ns = spec.depth, spec.num_rgb, spec.num_sigma
  g = lambda key: src[key].to(acc)
  x0 = g("x0")[:, :spec.feat]
  out = []
  for i in range(d):
    a = x0 if i == 0 else g(f"act{i - 1}")
    if i > 0 and mlp_kernel.skip_after(spec, i - 1):
      a = torch.cat([a, x0], -1)
    out.append(a.t() @ g(f"dpre{i}"))
  h, d16 = g(f"act{d - 1}"), g("d16")
  out.append(h.t() @ d16[:, nr:nr + ns])
  out.append(h.t() @ g("dbn"))
  out.append(torch.cat([g("bn"), g("cond")[:, :spec.cond]], -1).t()
             @ g("dac"))
  out.append(g("ac").t() @ d16[:, :nr])
  return out


def plain_stages(spec, params, inputs):
  """The plain version's stored values, from `inputs` ({x0, cond, d16}
  as K5 stores them), in fp32 without TF32."""
  w = [p.to(torch.bfloat16).float().t() for p in params[0::2]]
  b = [p.float() for p in params[1::2]]
  plain = dict(inputs)
  with mlp_kernel._full_fp32():
    for name in stage_names(spec):
      plain[name] = stage_out(spec, w, b, plain, name,
                              torch.float32).to(torch.bfloat16)
  return plain


def stage_names(spec):
  d = spec.depth
  return ([f"act{i}" for i in range(d)] + ["bn", "ac", "dac", "dbn"]
          + [f"dpre{i}" for i in range(d - 1, -1, -1)])


def stage_report(spec, params, x, c, drgb, dsigma, scale=K5_BF16_SCALE,
                 log=print):
  """K5 in bf16 against its plain version stage by stage, and both against
  the float64 twin fed the same bf16 operands; then each dW's error in
  units of scale * max |plain dW|. Returns the worst ratio of each
  comparison ("kernel-plain", "kernel-twin", "plain-twin",
  "twin(kernel)-twin(plain)")."""
  n = x.shape[0]
  stash = {}
  got = mlp_kernel.mlp_bwd(spec, params, x, c, drgb, dsigma, torch.bfloat16,
                           super_rows=-(-n // 128) * 128, stash=stash)
  kern = mlp_kernel.stored_values(spec, stash, n)
  del stash
  plain = plain_stages(spec, params,
                       {k: kern[k] for k in ("x0", "cond", "d16")})
  w64 = [p.to(torch.bfloat16).double().t() for p in params[0::2]]
  b64 = [p.double() for p in params[1::2]]
  lines = []
  for name in stage_names(spec):
    k64 = stage_out(spec, w64, b64, kern, name, torch.float64)
    p64 = stage_out(spec, w64, b64, plain, name, torch.float64)
    share = lambda a, z: float((a.double() != z.double()).float().mean())
    lines.append(f"{name} {share(kern[name], plain[name]):.2e}/"
                 f"{share(kern[name], k64):.2e}/{share(plain[name], p64):.2e}")
    del k64, p64
  log("  bf16 stages, share of elements whose bf16 value differs: kernel "
      "against plain / kernel against the float64 twin on the kernel's "
      "inputs / plain against the twin on the plain's inputs: "
      + ", ".join(lines))
  with mlp_kernel._full_fp32():
    want = [t.t() for t in mlp_kernel.fused_nerf_mlp_bwd_reference(
        spec, params, x, c, drgb, dsigma, torch.bfloat16)[0::2]]
  k64 = stage_dw(spec, kern, torch.float64)
  p64 = stage_dw(spec, plain, torch.float64)
  keys = ("kernel-plain", "kernel-twin", "plain-twin",
          "twin(kernel)-twin(plain)")
  worst, lines = dict.fromkeys(keys, 0.0), []
  for l, (kw, pw, kt, pt) in enumerate(zip([t.t() for t in got[0::2]], want,
                                           k64, p64)):
    tol = scale * float(pw.abs().max())
    ratios = [float((a.double() - z.double()).abs().max()) / tol
              for a, z in ((kw, pw), (kw, kt), (pw, pt), (kt, pt))]
    for key, v in zip(keys, ratios):
      worst[key] = max(worst[key], v)
    lines.append(f"{l}: " + "/".join(f"{v:.3f}" for v in ratios))
  log("  bf16 dW in units of the K5 tolerance, per layer: kernel against "
      "plain / kernel against the float64 twin on the kernel's operands / "
      "plain against the twin on its own / the two twins: "
      + ", ".join(lines))
  log(f"  bf16 dW worst: {worst}")
  return worst


def forward_disagreement(spec, params, x, c, drgb, dsigma, dtype):
  """Per stored activation (mlp_kernel.forward_activations' names), the
  count of elements where K4's forward and K5's recompute store different
  values, at the same rows: {name: count}."""
  acts = {}
  mlp_kernel.mlp_fwd(spec, params, x, c, dtype, acts=acts)
  stash, n = {}, x.shape[0]
  mlp_kernel.mlp_bwd(spec, params, x, c, drgb, dsigma, dtype,
                     super_rows=-(-n // 128) * 128, stash=stash)
  stored = mlp_kernel.stored_values(spec, stash, n)
  return {name: int((acts[name] != stored[name]).sum())
          for name, _, _ in mlp_kernel.forward_activations(spec)}


def k5_ratio(got, want, scale=K5_BF16_SCALE):
  """The worst of |got - want| / (scale * max |want|) over the tensors."""
  return max(float((g - w).abs().max()) / (scale * float(w.abs().max()))
             for g, w in zip(got, want))


def _ms(fn, reps=5):
  fn()
  times = []
  for _ in range(reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    times.append(start.elapsed_time(end))
  return float(np.median(times))


def ship_mlp(seed, dev):
  """The ship NerfMLP (8 x 256, skip 4, 63 + 27 inputs) with weights from
  seed: (spec, params on dev)."""
  mlp = mlp_modules.NerfMLP(63, 27, net_depth=8, net_width=256, skip_layer=4,
                            generator=torch.Generator().manual_seed(seed))
  params = [t.detach().to(dev) for t in mlp_kernel.mlp_params(mlp)]
  return mlp_kernel.mlp_spec(mlp), params


def samples(rows, seed, dev):
  """Raw points in [-1.5, 1.5]^3, unit view directions and cotangents of
  std 1e-3, from seed: (pts, dirs, drgb, dsigma) on dev."""
  rng = np.random.RandomState(seed + 1)
  pts = rng.uniform(-1.5, 1.5, (rows, 3)).astype(np.float32)
  dirs = rng.randn(rows, 3).astype(np.float32)
  dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
  drgb = 1e-3 * rng.randn(rows, 3).astype(np.float32)
  dsigma = 1e-3 * rng.randn(rows, 1).astype(np.float32)
  return tuple(torch.from_numpy(a).to(dev) for a in (pts, dirs, drgb,
                                                       dsigma))


def digest(tensors):
  h = hashlib.sha256()
  for t in tensors:
    h.update(t.detach().contiguous().cpu().numpy().tobytes())
  return h.hexdigest()[:16]


def fp32_digests(seed, dev, rows=196608, render_rows=RENDER_ROWS):
  """{name: sha256} of K4 fp32 fed and pe at render_rows and of K5 fp32 at
  rows, the ship MLP on seeded samples."""
  spec, params = ship_mlp(seed, dev)
  spec_pe = spec._replace(pe=(10, 4))
  f32 = torch.float32
  pts, dirs, _, _ = samples(render_rows, seed, dev)
  x = math_ops.pe_cols(pts, 10).contiguous()
  c = math_ops.pe_cols(dirs, 4).contiguous()
  out = {"K4 fp32 fed": digest(mlp_kernel.mlp_fwd(spec, params, x, c, f32)),
         "K4 fp32 pe": digest(mlp_kernel.mlp_fwd(spec_pe, params, pts, dirs,
                                                 f32))}
  del x, c
  pts, dirs, drgb, dsigma = samples(rows, seed, dev)
  x = math_ops.pe_cols(pts, 10).contiguous()
  c = math_ops.pe_cols(dirs, 4).contiguous()
  out["K5 fp32"] = digest(mlp_kernel.mlp_bwd(spec, params, x, c, drgb,
                                             dsigma, f32))
  return out


def main():
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--rows", type=int, default=196608,
                 help="MLP rows (the ship train batch's fine call: 1024 "
                 "rays x 192 samples)")
  p.add_argument("--seed", type=int, default=0)
  p.add_argument("--digests", action="store_true",
                 help="print the fp32 arms' digests instead")
  ns = p.parse_args()
  if not torch.cuda.is_available():
    raise SystemExit("mlp_rounding: needs a CUDA card")
  dev = torch.device("cuda")
  card = torch.cuda.get_device_name(0)
  if ns.digests:
    for name, value in fp32_digests(ns.seed, dev, ns.rows).items():
      print(f"digest {name}: {value} ({card})", flush=True)
    return
  spec, params = ship_mlp(ns.seed, dev)
  pts, dirs, drgb, dsigma = samples(ns.rows, ns.seed, dev)
  x = math_ops.pe_cols(pts, 10).contiguous()
  c = math_ops.pe_cols(dirs, 4).contiguous()
  bf16 = torch.bfloat16
  want4 = torch.cat(mlp_kernel.fused_nerf_mlp_reference(spec, params, x, c,
                                                        bf16), -1)
  want5 = mlp_kernel.fused_nerf_mlp_bwd_reference(spec, params, x, c, drgb,
                                                  dsigma, bf16)
  pack = mlp_kernel.pack_params(params, bf16)
  acts = {}
  err = (torch.cat(mlp_kernel.mlp_fwd(spec, params, x, c, bf16, acts=acts),
                   -1) - want4).abs()
  ms4 = _ms(lambda: mlp_kernel.mlp_fwd(spec, params, x, c, bf16, pack=pack))
  got = mlp_kernel.mlp_bwd(spec, params, x, c, drgb, dsigma, bf16)
  ratio = k5_ratio(got, want5)
  forced = k5_ratio(got, mlp_kernel.fused_nerf_mlp_bwd_reference(
      spec, params, x, c, drgb, dsigma, bf16, at=acts))
  del acts
  ms5 = _ms(lambda: mlp_kernel.mlp_bwd(spec, params, x, c, drgb, dsigma,
                                       bf16, pack=pack))
  f2 = forward_disagreement(spec, params, x, c, drgb, dsigma, bf16)
  print(f"K4-bf16 max abs err {float(err.max()):.3e}, mean "
        f"{float(err.mean()):.3e}, {ms4:.4f} ms; K5-bf16 at {ratio:.3f} of "
        f"its tolerance free-running, {forced:.3f} at K4's activations, "
        f"{ms5:.4f} ms; F2 {sum(f2.values())} {f2} ({ns.rows} rows, {card})",
        flush=True)
  stage_report(spec, params, x, c, drgb, dsigma)


if __name__ == "__main__":
  main()
