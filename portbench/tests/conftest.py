"""The benchmark's CPU tests: they need no card; a test that does is
marked `cuda` and skips without one."""


def pytest_configure(config):
  config.addinivalue_line(
      "markers", "cuda: runs on the card; skips without a CUDA device")
