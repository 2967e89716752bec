"""The train step's share (%) of the card's peak: the operations a step
needs (portbench/counts/nerf.train_step_ops: each class at its own peak,
nothing recomputed, the elementwise work between the products not
counted) over the traced window's time per step."""

from portbench.counts import nerf as counts


def read(ctx):
  if not ctx.trace.ops or not ctx.steps:
    return None
  per_step = ctx.trace.window_s / ctx.steps
  return 100.0 * counts.ideal_seconds(ctx.step_ops) / per_step
