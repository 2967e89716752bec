"""Milliseconds the train loop waited a window for its batch: the
benchmark's span around each next() on data/prefetch.device_prefetch's
iterator, averaged over the timed window's windows."""


def read(ctx):
  return ctx.input_wait_ms
