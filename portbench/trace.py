"""Reading a torch.profiler trace of a traced window.

Device operations are the trace's CUDA events (kernels, copies, sets;
a CUDA graph's replay records each of its kernels), the benchmark's spans
its `pb:<name>` annotations on the host. Times are microseconds on the
profiler's clock.
"""

import dataclasses

SPAN_PREFIX = "pb:"
NAME_CHARS = 120


@dataclasses.dataclass
class Trace:
  """What a traced window recorded: device ops (name, start, end), the
  benchmark's host spans (name, start, end), the window (start, end)."""
  ops: list
  spans: list
  window: tuple

  @property
  def window_s(self):
    return (self.window[1] - self.window[0]) / 1e6


def from_profile(prof):
  """A Trace of a profiler run whose work sits in one `pb:traced` span."""
  from torch.autograd import DeviceType
  ops, spans = [], []
  for e in prof.events():
    tr = e.time_range
    if e.name.startswith(SPAN_PREFIX):
      if e.device_type == DeviceType.CPU:
        spans.append((e.name[len(SPAN_PREFIX):], tr.start, tr.end))
      continue
    if (e.device_type == DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)):
      ops.append((e.name, tr.start, tr.end))
  window = [s for s in spans if s[0] == "traced"]
  if not window:
    raise RuntimeError("the profile holds no pb:traced span")
  lo, hi = window[0][1], window[0][2]
  ops = [(n, max(a, lo), min(b, hi)) for n, a, b in ops if b > lo and a < hi]
  return Trace(sorted(ops, key=lambda o: o[1]), spans, (lo, hi))


def busy_intervals(trace):
  """The union of the device ops' intervals, sorted and disjoint."""
  merged = []
  for _, a, b in trace.ops:
    if merged and a <= merged[-1][1]:
      merged[-1][1] = max(merged[-1][1], b)
    else:
      merged.append([a, b])
  return merged


def busy_s(trace):
  return sum(b - a for a, b in busy_intervals(trace)) / 1e6


def idle_gaps(trace):
  """(start, end) of each stretch of the window with no device op."""
  gaps, at = [], trace.window[0]
  for a, b in busy_intervals(trace):
    if a > at:
      gaps.append((at, a))
    at = max(at, b)
  if trace.window[1] > at:
    gaps.append((at, trace.window[1]))
  return gaps


def host_label(trace, t):
  """The innermost benchmark span open at time t ('traced' if none)."""
  best = None
  for name, a, b in trace.spans:
    if a <= t < b and (best is None or b - a < best[2] - best[1]):
      best = (name, a, b)
  return best[0] if best else "outside"


def kernel_time(trace, match):
  """(seconds, launches) of the ops whose name `match` accepts."""
  hits = [(a, b) for n, a, b in trace.ops if match(n)]
  return sum(b - a for a, b in hits) / 1e6, len(hits)


def breakdown(trace, top=10):
  """The device ops that took most time (by name) and the longest idle
  gaps (by what the host was doing when each began)."""
  by_name = {}
  for n, a, b in trace.ops:
    key = n[:NAME_CHARS]
    by_name[key] = by_name.get(key, 0.0) + (b - a) / 1e6
  ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
  gaps = sorted(idle_gaps(trace), key=lambda g: g[0] - g[1])[:top]
  return {"device_ops": [[n, s] for n, s in ops],
          "idle_gaps": [[host_label(trace, a), (b - a) / 1e6]
                        for a, b in gaps]}


def is_gemm(name):
  """A cuBLAS or CUTLASS matrix-product kernel."""
  low = name.lower()
  return any(k in low for k in ("gemm", "nvjet", "cutlass", "xmma",
                                "cublas"))
