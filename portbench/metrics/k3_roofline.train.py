"""K3's share (%) of its roofline: the least time of one 'all' batch's
reverse sweep (portbench/counts/nerf.k3) over one call's device time, the
sum over its kernels (k3_pieces, k3_jacobians, k3_sweep, k3_params,
k3_reduce) of each one's time per recorded launch."""

import re

from portbench import trace as trace_lib

KERNELS = ("k3_pieces", "k3_jacobians", "k3_sweep", "k3_params", "k3_reduce")


def read(ctx):
  call = 0.0
  for k in KERNELS:
    pat = re.compile(r"(^|[\s:])" + k + r"\b")
    secs, launches = trace_lib.kernel_time(ctx.trace,
                                           lambda n: bool(pat.search(n)))
    if not launches:
      return None
    call += secs / launches
  return 100.0 * ctx.bounds["k3"][0] / 1e3 / call
