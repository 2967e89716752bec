"""Share (%) of the traced window in which no operation ran on the card:
one minus the union of the trace's device intervals over the window."""

from portbench import trace as trace_lib


def read(ctx):
  if not ctx.trace.ops:
    return None
  return 100.0 * (1.0 - trace_lib.busy_s(ctx.trace) / ctx.trace.window_s)
