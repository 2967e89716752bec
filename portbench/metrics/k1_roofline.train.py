"""K1's share (%) of its roofline: the least time of one radiance batch's
lean march (portbench/counts/nerf.k1) over the device time of one
march_lean_kernel launch in the trace (its recorded launches)."""

from portbench import trace as trace_lib


def read(ctx):
  secs, launches = trace_lib.kernel_time(ctx.trace,
                                         lambda n: "march_lean_kernel" in n)
  if not launches:
    return None
  return 100.0 * ctx.bounds["k1"][0] / 1e3 / (secs / launches)
