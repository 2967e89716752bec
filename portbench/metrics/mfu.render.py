"""The render's share (%) of the card's peak: the operations its rays need
(portbench/counts/nerf.render_ops: the march with the head, the MLPs in
fp32) over the traced window's time."""

from portbench.counts import nerf as counts


def read(ctx):
  if not ctx.trace.ops or not ctx.rays:
    return None
  ops = {c: n * ctx.rays for c, n in ctx.ops_per_ray.items()}
  return 100.0 * counts.ideal_seconds(ops) / ctx.trace.window_s
