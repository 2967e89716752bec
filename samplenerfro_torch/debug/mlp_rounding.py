"""Where the fused MLP's bf16 kernels round apart from their plain versions.

K4 and K5 (csrc/mlp_fwd.cu, csrc/mlp_bwd.cu) multiply exact bf16 products
and sum them in fp32, as the plain versions (ops/mlp_kernel.py) do, but in
another order, and on tensor cores each mma step rounds its own sum. Every
stored activation and cotangent is then rounded to bf16, so a sum that
lands on the other side of a bf16 rounding boundary stores the other
neighbour (a flip), which every later layer of that row carries.

stage_report compares K5's stored values (mlp_kernel.stored_values) with
the plain version's, stage by stage, and both with a float64 twin of the
plain version fed each side's own bf16 operands: how far each side rounds
from exact sums, and how far the two chains have drifted apart. Then each
layer's weight gradient, in units of the K5 bf16 tolerance.

    python -m samplenerfro_torch.debug.mlp_rounding [--rows=196608]

runs that report for the shipped kernels and for their rounding trials
(mlp_kernel.TRIAL_DEFINES): K4's bf16 forward on tensor cores, tensor-core
products that keep their running sum inside the tensor core, and K5's
recompute on tensor cores, at the ship width on random samples; with
K4-bf16's and K5-bf16's errors against their plain versions and their
times. It needs a CUDA card. forward_disagreement counts where K4's
stored activations and K5's recompute differ.
"""

import argparse

import numpy as np
import torch

from samplenerfro_torch.models import mlp as mlp_modules
from samplenerfro_torch.ops import math as math_ops
from samplenerfro_torch.ops import mlp_kernel

# K5-bf16's tolerance: 2e-3 of each plain tensor's largest |value|
# (chip_smoke.py, tests/test_torch_cuda.py).
K5_BF16_SCALE = 2e-3
K4_TENSOR = "FUSED_MLP_K4_TENSOR_FORWARD=1"
TRIALS = (
    ("shipped", ()),
    ("K4-bf16 on tensor cores (the earlier K4)", (K4_TENSOR,)),
    ("tensor-core running sums",
     (K4_TENSOR, "FUSED_MLP_MMA_RUNNING_SUM=1")),
    ("K5 recompute on tensor cores",
     (K4_TENSOR, "FUSED_MLP_K5_TENSOR_FORWARD=1")),
    ("all on tensor cores, running sums",
     (K4_TENSOR, "FUSED_MLP_K5_TENSOR_FORWARD=1",
      "FUSED_MLP_MMA_RUNNING_SUM=1")),
)


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


def forward_disagreement(spec, params, x, c, drgb, dsigma, dtype,
                         k4_defines=()):
  """Per stored activation (mlp_kernel.forward_activations' names), the
  count of elements where K4's forward (built with k4_defines) and K5's
  recompute store different values, at the same rows: {name: count}."""
  saved = mlp_kernel.TRIAL_DEFINES
  acts = {}
  try:
    mlp_kernel.TRIAL_DEFINES = tuple(k4_defines)
    mlp_kernel.mlp_fwd(spec, params, x, c, dtype, acts=acts)
  finally:
    mlp_kernel.TRIAL_DEFINES = saved
  stash, n = {}, x.shape[0]
  mlp_kernel.mlp_bwd(spec, params, x, c, drgb, dsigma, dtype,
                     super_rows=-(-n // 128) * 128, stash=stash)
  stored = mlp_kernel.stored_values(spec, stash, n)
  return {name: int((acts[name] != stored[name]).sum())
          for name, _, _ in mlp_kernel.forward_activations(spec)}


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


def main():
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--rows", type=int, default=196608,
                 help="MLP rows (the ship train batch's fine call: 1024 "
                 "rays x 192 samples)")
  p.add_argument("--seed", type=int, default=0)
  ns = p.parse_args()
  if not torch.cuda.is_available():
    raise SystemExit("mlp_rounding: needs a CUDA card")
  dev = torch.device("cuda")
  mlp = mlp_modules.NerfMLP(63, 27, net_depth=8, net_width=256, skip_layer=4,
                            generator=torch.Generator().manual_seed(ns.seed))
  params = [t.detach().to(dev) for t in mlp_kernel.mlp_params(mlp)]
  spec = mlp_kernel.mlp_spec(mlp)
  rng = np.random.RandomState(ns.seed + 1)
  pts = rng.uniform(-1.5, 1.5, (ns.rows, 3)).astype(np.float32)
  dirs = rng.randn(ns.rows, 3).astype(np.float32)
  dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
  x = math_ops.pe_cols(torch.from_numpy(pts).to(dev), 10).contiguous()
  c = math_ops.pe_cols(torch.from_numpy(dirs).to(dev), 4).contiguous()
  drgb = torch.from_numpy(1e-3 * rng.randn(ns.rows, 3).astype(np.float32))
  dsigma = torch.from_numpy(1e-3 * rng.randn(ns.rows, 1).astype(np.float32))
  drgb, dsigma = drgb.to(dev), dsigma.to(dev)
  bf16 = torch.bfloat16
  want4 = torch.cat(mlp_kernel.fused_nerf_mlp_reference(spec, params, x, c,
                                                        bf16), -1)
  want5 = mlp_kernel.fused_nerf_mlp_bwd_reference(spec, params, x, c, drgb,
                                                  dsigma, bf16)
  pack = mlp_kernel.pack_params(params, bf16)
  saved = mlp_kernel.TRIAL_DEFINES
  try:
    for what, defines in TRIALS:
      mlp_kernel.TRIAL_DEFINES = defines
      err = (torch.cat(mlp_kernel.mlp_fwd(spec, params, x, c, bf16), -1)
             - want4).abs()
      ms4 = _ms(lambda: mlp_kernel.mlp_fwd(spec, params, x, c, bf16,
                                           pack=pack))
      got = mlp_kernel.mlp_bwd(spec, params, x, c, drgb, dsigma, bf16)
      ratio = max(float((g - w).abs().max()) / (K5_BF16_SCALE
                                                * float(w.abs().max()))
                  for g, w in zip(got, want5))
      ms5 = _ms(lambda: mlp_kernel.mlp_bwd(spec, params, x, c, drgb, dsigma,
                                           bf16, pack=pack))
      print(f"{what} {list(defines)}: K4-bf16 max abs err "
            f"{float(err.max()):.3e}, mean {float(err.mean()):.3e}, "
            f"{ms4:.4f} ms; K5-bf16 at {ratio:.3f} of its tolerance, "
            f"{ms5:.4f} ms ({ns.rows} rows, {torch.cuda.get_device_name(0)})",
            flush=True)
      stage_report(spec, params, x, c, drgb, dsigma)
  finally:
    mlp_kernel.TRIAL_DEFINES = saved


if __name__ == "__main__":
  main()
