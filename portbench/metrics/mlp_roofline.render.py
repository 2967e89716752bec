"""The MLPs' share (%) of their roofline in rendering: the least time of
the rays' fp32 NerfMLP and background-MLP products (portbench/counts/
nerf.mlp_bound, per chunk) over the trace's matrix-product (cuBLAS)
kernel time per chunk."""

from portbench import trace as trace_lib


def read(ctx):
  secs, launches = trace_lib.kernel_time(ctx.trace, trace_lib.is_gemm)
  if not launches or not ctx.rays:
    return None
  return 100.0 * ctx.bounds["mlp"][0] / 1e3 / (secs * ctx.chunk / ctx.rays)
