"""Train steps and a render of the port, run alike under ranks and alone.

    RANK=r WORLD_SIZE=W MASTER_ADDR=127.0.0.1 MASTER_PORT=<port> \\
        python -m samplenerfro_torch.debug.dist_worker <spec.pt> <out>

(or under torchrun) runs the spec's runs as rank r of W, each rank taking
its rows of every global batch, and writes what it saw to <out>.<r>;
`run(spec)` in a process without ranks runs the same spec on the whole
batches: the single-process step of the concatenated batch that the W
ranks must reproduce (parallel/mesh.py). tests/test_torch_parallel.py
drives it on the CPU over gloo, and chip_smoke.py's phase 15 on the card
(two gloo ranks on one card; NCCL takes one rank a device).

The spec is a dict, written with torch.save by the caller:
  "device", "backend": the ranks' device ("cpu", "cuda") and backend (None:
    NCCL on CUDA, gloo on the CPU);
  "args": the flags (a dict), which each run may override;
  "scene": {"values", "ndim", "nmin", "nmax", "bindings"} (an IOR grid),
    or {"ship": seed}: debug/march_parity.ship_model's 512^3 scene;
  "seed", "weights": the initial weights, drawn from seed, then replaced
    by "weights" ({name: tensor}) when given (a run's own "weights" win);
  "runs": a list of
    {"name", "kind": "train", "k", "noise_seed", "args": {...},
     "steps": [{"host": a global host batch (train/loop.step_batch's),
                "alpha", "count" (the update's learning-rate count),
                "jitter"}]}: the steps, K a dispatch
                (train/step.make_train_step_multi), from fresh weights
                and Adam state; with "record_states" the output carries
                the weights and Adam state before each window, and a
                run given "force_states" (such a list) loads them before
                each window: each of its windows then starts where the
                recorded run's did (a gradient near 0 that rounds apart
                becomes a +-lr Adam update, and the next steps would
                compare different weights);
    {"name", "kind": "render", "view": Rays of [h, w, C] numpy, "jitter",
     "chunk", "chunks_per_dispatch"}: one view through eval's render
     function (utils/render.render_image), from fresh weights;
    {"name", "kind": "forward", "args", "host", "alpha", "jitter"}: the
     model's final level on this rank's rows of the host batch's rays,
     not randomized, from fresh weights.

A rank other than 0 hands over replicated leaves (REPLICATED_BATCH_KEYS)
that differ from rank 0's, reversed along their first axis, as its own
RandomState draws differ in train/loop.py: the broadcast must give it
rank 0's. The output of a run: "stats" (each step's Stats as floats),
"grads" (every parameter's gradient after each window: summed over the
ranks and clipped), "state" (parameters and Adam moments after the run),
"launches" (the K1/K2/K3/head-off wrappers' counts) for a train run;
"rgb", "distance", "acc" and "launches" for a render; "rgb", "rows" (this
rank's [lo, hi)) and "launches" for a forward; each with its "seconds"
(host clock, the device synchronised).
"""

import argparse
import copy
import dataclasses
import sys
import time

import numpy as np
import torch

from samplenerfro_torch.data import prefetch
from samplenerfro_torch.data.rays import namedtuple_map
from samplenerfro_torch.eval import make_render_fn
from samplenerfro_torch.models import nerf
from samplenerfro_torch.ops import eikonal_vjp
from samplenerfro_torch.ops import march_kernel
from samplenerfro_torch.parallel import mesh
from samplenerfro_torch.train import loop
from samplenerfro_torch.train import step as step_lib
from samplenerfro_torch.utils import render as render_lib

_COUNTED = (march_kernel.march_lean, march_kernel.march_full,
            eikonal_vjp.march_bwd, march_kernel.march_full_plain)


def launches():
  """The K1, K2, K3 and head-off wrappers' launch counts."""
  return tuple(f.launches for f in _COUNTED)


def zero_launches():
  for f in _COUNTED:
    f.launches = 0


def build_scene(spec, device):
  """(ndim, nmin, nmax, grid, bindings) of the spec's scene."""
  scene = spec["scene"]
  if "ship" in scene:
    from samplenerfro_torch.debug import march_parity
    return march_parity.ship_model(device, scene["ship"])[2]
  return (scene["ndim"], scene["nmin"], scene["nmax"], scene["values"],
          scene.get("bindings"))


def _model(spec, scene, run, device):
  """The run's model: its args, weights drawn from the spec's seed, then
  the run's or the spec's "weights" when given."""
  args = argparse.Namespace(**{**spec["args"], **run.get("args", {})})
  ndim, nmin, nmax, grid, bindings = scene
  model = nerf.construct_nerf(args, ndim, nmin, nmax, grid, bindings,
                              device=device, seed=spec.get("seed", 0))
  weights = run.get("weights", spec.get("weights"))
  if weights is not None:
    with torch.no_grad():
      for name, value in weights.items():
        model.get_parameter(name).copy_(value)
  return args, model


def local_host(host):
  """This rank's part of a global host batch: its rows of RAY_KEYS; on a
  rank other than 0, replicated leaves of its own (reversed)."""
  out = {}
  for key, value in host.items():
    if key in mesh.RAY_KEYS:
      lo, hi = mesh.local_rows(np.asarray(value[0] if key == "rays"
                                          else value).shape[0])
      out[key] = (namedtuple_map(lambda r: r[lo:hi], value)
                  if key == "rays" else value[lo:hi])
    elif (key in mesh.REPLICATED_BATCH_KEYS and mesh.rank() != 0
          and value is not None):
      out[key] = (namedtuple_map(lambda r: np.ascontiguousarray(r[::-1]),
                                 value)
                  if isinstance(value, tuple) else
                  np.ascontiguousarray(value[::-1]))
    else:
      out[key] = value
  return out


def _state(model, optimizer):
  out = {f"param {n}": p.detach().cpu().clone()
         for n, p in model.named_parameters()}
  for i, st in optimizer.state_dict()["state"].items():
    out.update({f"adam {i} {n}": torch.as_tensor(t).cpu().clone()
                for n, t in st.items()})
  return out


def train_run(spec, scene, run, device):
  args, model = _model(spec, scene, run, device)
  optimizer, _, _ = step_lib.create_optimizer(model, args)
  mesh.broadcast_module_state(model, optimizer)
  generator = torch.Generator(device=device).manual_seed(run["noise_seed"])
  step = step_lib.make_train_step_multi(model, optimizer, args, run["k"],
                                        generator)
  stats, grads, states = [], [], []
  zero_launches()
  steps = run["steps"]
  for i, w0 in enumerate(range(0, len(steps), run["k"])):
    if run.get("force_states") is not None:
      forced = run["force_states"][i]
      model.load_state_dict(forced["model"], strict=False)
      optimizer.load_state_dict(forced["optimizer"])
    if run.get("record_states"):
      states.append({
          "model": {n: t.detach().clone() for n, t in
                    model.state_dict().items() if n != mesh.GRID_BUFFER},
          "optimizer": copy.deepcopy(optimizer.state_dict())})
    window = [loop.step_batch(
        local_host(s["host"]), s["alpha"],
        step_lib.learning_rates(optimizer, s["count"]), s["jitter"], args)
              for s in steps[w0:w0 + run["k"]]]
    batch = prefetch.to_device(prefetch.stack(window), device)
    mesh.broadcast_replicated(batch)
    stats += [dataclasses.asdict(s) for s in step(batch).per_step()]
    grads.append({n: p.grad.detach().cpu().clone()
                  for n, p in model.named_parameters() if p.grad is not None})
  return {"stats": stats, "grads": grads, "state": _state(model, optimizer),
          "states": states, "launches": launches()}


def forward_run(spec, scene, run, device):
  _, model = _model(spec, scene, run, device)
  mesh.broadcast_module_state(model)
  rays = run["host"]["rays"]
  lo, hi = mesh.local_rows(np.asarray(rays[0]).shape[0])
  rays = prefetch.to_device(namedtuple_map(lambda r: r[lo:hi], rays), device)
  zero_launches()
  with torch.no_grad():
    ret, _ = model(rays, run["jitter"], randomized=False,
                   annealed_alpha=run["alpha"])
  return {"rgb": ret[-1][0].cpu(), "rows": (lo, hi), "launches": launches()}


def render_run(spec, scene, run, device):
  _, model = _model(spec, scene, run, device)
  mesh.broadcast_module_state(model)
  zero_launches()
  rgb, distance, acc = render_lib.render_image(
      make_render_fn(model, run["jitter"]), run["view"], False,
      chunk=run["chunk"], device=device,
      chunks_per_dispatch=run.get("chunks_per_dispatch", 1))
  return {"rgb": rgb, "distance": distance, "acc": acc,
          "launches": launches()}


_RUNS = {"train": train_run, "render": render_run, "forward": forward_run}


def _sync(device):
  if device.type == "cuda":
    torch.cuda.synchronize(device)


def run(spec, device=None, scene=None):
  """Every run of the spec on `device` (the spec's when None), as this
  process's rank if it has one; returns {run name: its output}. `scene`,
  when given, stands for build_scene's."""
  device = torch.device(spec["device"] if device is None else device)
  if scene is None:
    scene = build_scene(spec, device)
  out = {}
  for r in spec["runs"]:
    _sync(device)
    t0 = time.time()
    out[r["name"]] = _RUNS[r["kind"]](spec, scene, r, device)
    _sync(device)
    out[r["name"]]["seconds"] = time.time() - t0
  return out


def main(argv=None):
  argv = sys.argv[1:] if argv is None else argv
  if len(argv) != 2:
    raise SystemExit(__doc__.split("\n\n")[1])
  spec = torch.load(argv[0], weights_only=False)
  with mesh.process_group(spec["device"], spec.get("backend")) as device:
    out = run(spec, device)
    out["rank"], out["world"] = mesh.rank(), mesh.world()
    torch.save(out, f"{argv[1]}.{mesh.rank()}")
    mesh.barrier()
  return 0


if __name__ == "__main__":
  sys.exit(main())
