"""The MLPs' share (%) of their roofline: the least time of a step's
NerfMLP and background-MLP products, forward and backward, each at its
precision's peak (portbench/counts/nerf.mlp_bound) over the trace's
matrix-product (cuBLAS) kernel time per step."""

from portbench import trace as trace_lib


def read(ctx):
  secs, launches = trace_lib.kernel_time(ctx.trace, trace_lib.is_gemm)
  if not launches or not ctx.steps:
    return None
  return 100.0 * ctx.bounds["mlp"][0] / 1e3 / (secs / ctx.steps)
