"""K steps through train/step.make_train_step_multi against K sequential
train_step calls on the CPU, each on its own step's batch
(loop.step_batch), bit for bit: parameters, Adam moments and counts,
every per-step Stats field; radiance and 'all', K in {1, 3}, randomized
with seeded generators. The rest of the dispatch's tests, and the
helpers used here, are in tests/test_torch_dispatch.py.
"""

import pytest
import torch

from samplenerfro_torch.data import prefetch
from samplenerfro_torch.models import nerf as t_nerf
from samplenerfro_torch.train import loop as t_loop
from samplenerfro_torch.train import step as t_step
from tests.test_torch_dispatch import (_args, _assert_equal_state,
                                       _host_batch, _model, _state, _windows)


@pytest.mark.parametrize("stage", ["radiance", "all"])
@pytest.mark.parametrize("k", [1, 3])
def test_multi_step_equals_sequential_steps(stage, k):
  """6 steps from step 5 (alpha > 0 and changing): K a dispatch through
  make_train_step_multi on loop.host_window's stacked batches, against
  train_step called step by step on each step's loop.step_batch; bit for
  bit."""
  args = _args(stage)
  first, last = 5, 10
  seq, multi = _model(args), _model(args)
  opt_s, _, _ = t_step.create_optimizer(seq, args)
  opt_m, _, _ = t_step.create_optimizer(multi, args)
  gen_s = torch.Generator().manual_seed(3)
  gen_m = torch.Generator().manual_seed(3)
  jit_s = torch.Generator().manual_seed(4)
  jit_m = torch.Generator().manual_seed(4)

  seq_stats = []
  for step in range(first, last + 1):
    jitter = t_nerf.make_jitter(args.num_coarse_samples,
                                args.num_path_samples, jit_s)
    batch = prefetch.to_device(t_loop.step_batch(
        _host_batch(step), t_loop.annealed_alpha(step, args),
        t_step.learning_rates(opt_s, step - 1), jitter, args), "cpu")
    seq_stats.append(t_step.train_step(seq, opt_s, batch, args,
                                       gen_s).as_floats())

  dataset = iter([_host_batch(s) for s in range(first, last + 1)])
  run = t_step.make_train_step_multi(multi, opt_m, args, k, gen_m)
  got = []
  for w0, w1 in _windows(first, last, k):
    batch = prefetch.to_device(
        t_loop.host_window(dataset, w0, w1, args, opt_m, jit_m), "cpu")
    stats = run(batch)
    assert stats.loss.shape == (w1 - w0 + 1,)
    got += stats.per_step()
  assert got == seq_stats
  _assert_equal_state(_state(seq, opt_s), _state(multi, opt_m))
  counts = {int(s["step"]) for s in opt_m.state_dict()["state"].values()}
  assert counts == {last - first + 1}
