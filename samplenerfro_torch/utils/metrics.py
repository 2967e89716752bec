"""Image metrics. Counterpart of samplenerfro_tpu/utils/metrics.py:13-15;
SSIM is not ported yet."""

import math


def compute_psnr(mse):
  """PSNR for unit-range images from an MSE value."""
  return -10.0 * math.log(float(mse)) / math.log(10.0)
