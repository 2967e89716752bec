"""A run with the timed path broken underneath comes out not correct,
held to the real cells' limits; so does the control.

The tiny cells run the port's CPU path (its plain versions) in fp32, where
a sound run reads far under every limit (test_portbench_reference), with
one fault planted at a time: a step that leaves the state as it was, half
of each batch left out (the mean over the rest), an answer altered where
it is produced; and, in the timed window alone (where the card replays a
CUDA graph), a window that leaves the state as it was and one that reads
the batch of the window before it, as a graph whose static batch is not
copied in would. The cells run on one chip, so there is no exchange
between chips to leave out. The control is the reference one precision
below the configuration's, in the program's place."""

import os

import pytest
import torch

from portbench import harness
from portbench.cells import render as render_cell
from portbench.cells import train as train_cell
from portbench.reference import model as ref_model
from portbench.tests import tiny
from portbench.traffic import capture
from portbench.traffic import weights as weights_lib


def _state_unchanged(monkeypatch):
  from samplenerfro_torch.train import step
  monkeypatch.setattr(step.Adam, "step", lambda self, lrs: None)


def _half_batch(monkeypatch):
  from samplenerfro_torch.train import step
  loss_fn = step.loss_fn

  def half(model, batch, args, generator=None):
    n = batch["pixels"].shape[0] // 2
    batch = dict(batch, pixels=batch["pixels"][:n],
                 rays=type(batch["rays"])(*[r[:n] for r in batch["rays"]]))
    return loss_fn(model, batch, args, generator)
  monkeypatch.setattr(step, "loss_fn", half)


# The tiny cells' set-up makes three calls of the K-step run (step 1,
# steps 2-3, one window); the timed window's calls come after them.
SETUP_CALLS = 3


def _timed_calls(monkeypatch, fault):
  """Plants fault(run, batch, state) around every call of the K-step run
  after the set-up's."""
  from samplenerfro_torch.train import step
  call = step.MultiStep.__call__

  def faulty(self, batch):
    self.calls = getattr(self, "calls", 0) + 1
    if self.calls <= SETUP_CALLS:
      self.last_batch = batch
      return call(self, batch)
    return fault(self, batch, lambda b: call(self, b))
  monkeypatch.setattr(step.MultiStep, "__call__", faulty)


def _window_state_unchanged(monkeypatch):
  def fault(run, batch, call):
    opt = run.optimizer
    tensors = [p for g in opt.param_groups for p in g["params"]]
    tensors += [opt.state[p][k] for p in list(tensors)
                for k in ("exp_avg", "exp_avg_sq")] + opt.counts
    kept = [t.detach().clone() for t in tensors]
    out = call(batch)
    with torch.no_grad():
      for t, k in zip(tensors, kept):
        t.copy_(k)
    return out
  _timed_calls(monkeypatch, fault)


def _window_stale_batch(monkeypatch):
  _timed_calls(monkeypatch, lambda run, batch, call: call(run.last_batch))


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _window_state_unchanged,
                                   _window_stale_batch])
def test_train_faults_fail(tmp_path, monkeypatch, fault):
  fault(monkeypatch)
  result, checks = tiny.run(tmp_path, "train_all")
  assert not result["correct"], checks


def _altered_answer(monkeypatch):
  from samplenerfro_torch import eval as eval_lib
  make = eval_lib.make_render_fn

  def altered(model, jitter):
    fn = make(model, jitter)

    def render_fn(rays):
      rgb, *rest = fn(rays)
      return (rgb + 0.05, *rest)
    return render_fn
  monkeypatch.setattr(eval_lib, "make_render_fn", altered)


def _half_chunk(monkeypatch):
  from samplenerfro_torch import eval as eval_lib
  make = eval_lib.make_render_fn

  def halved(model, jitter):
    fn = make(model, jitter)

    def render_fn(rays):
      n = rays.origins.shape[0]
      out = fn(type(rays)(*[r[:n // 2] for r in rays]))
      return tuple(torch.cat([o, torch.zeros((n - n // 2,) + o.shape[1:])])
                   for o in out[:3])
    return render_fn
  monkeypatch.setattr(eval_lib, "make_render_fn", halved)


@pytest.mark.parametrize("fault", [_altered_answer, _half_chunk])
def test_render_faults_fail(tmp_path, monkeypatch, fault):
  fault(monkeypatch)
  result, checks = tiny.run(tmp_path, "render", seconds=0.2)
  assert not result["correct"], checks


def _limits(cell):
  return harness.load_json(os.path.join(harness.PKG, "workloads",
                                        cell + ".json"))["limits"]


@pytest.mark.parametrize("mix", ["train_all", "train_radiance"])
def test_train_control_fails(tmp_path, mix):
  cfg = tiny.tiny_config()
  m = harness.load_json(os.path.join(harness.PKG, "traffic", mix + ".json"))
  data_dir = capture.write_capture(cfg, str(tmp_path / "scene"), 3)
  raw = capture.raw_grid(cfg, "cpu")
  w = weights_lib.make(ref_model.param_shapes(cfg), 3, "cpu", 1e-2)
  got = train_cell.reference_run(
      cfg, m["stage"], data_dir, raw, w, 3, int(m["resume_step"]) + 1,
      int(m["check_steps"]), "cpu",
      variants=[("reference", ref_model.Prec(), None),
                ("control", ref_model.control_prec(cfg), None)])
  got = train_cell.numbers_of(got["control"][0], None, got["reference"])
  limits = _limits(tiny.BASE[mix])
  assert any(got[k] > lim for k, lim in limits.items() if k in got), got


def test_render_control_fails():
  cfg = tiny.tiny_config()
  f = cfg["flags"]
  raw = capture.raw_grid(cfg, "cpu")
  w = weights_lib.make(ref_model.param_shapes(cfg), 3, "cpu", 1e-2)
  from samplenerfro_torch.models import nerf
  jitter = nerf.make_jitter(f["num_coarse_samples"], f["num_path_samples"],
                            torch.Generator().manual_seed(9))
  pose = capture.test_poses(cfg, 3, 2)[:1]
  ref = render_cell.reference_views(cfg, raw, w, pose, jitter, "cpu")[0]
  ctl = render_cell.reference_views(
      cfg, raw, w, pose, jitter, "cpu",
      prec=ref_model.control_prec(cfg, render=True))[0]
  got = render_cell.compare(ctl, ref, f["far"] - f["near"])
  limits = _limits("ship.render")
  assert any(got[k] > lim for k, lim in limits.items()), got
