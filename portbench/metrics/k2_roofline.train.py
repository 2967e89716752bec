"""K2's share (%) of its roofline: the least time of one 'all' batch's
march with the so3 head (portbench/counts/nerf.k2) over the device time of
one march_so3_kernel launch in the trace."""

from portbench import trace as trace_lib


def read(ctx):
  secs, launches = trace_lib.kernel_time(ctx.trace,
                                         lambda n: "march_so3_kernel" in n)
  if not launches:
    return None
  return 100.0 * ctx.bounds["k2"][0] / 1e3 / (secs / launches)
