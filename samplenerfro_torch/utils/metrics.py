"""Image metrics. Counterpart of samplenerfro_tpu/utils/metrics.py: PSNR,
and SSIM as tf.image.ssim computes it (an 11-tap Gaussian window of sigma
1.5, applied separably with "valid" convolutions)."""

import math

import torch
import torch.nn.functional as F


def compute_psnr(mse):
  """PSNR for unit-range images from an MSE value."""
  return -10.0 * math.log(float(mse)) / math.log(10.0)


def compute_ssim(img0, img1, max_val, filter_size=11, filter_sigma=1.5,
                 k1=0.01, k2=0.03, return_map=False):
  """SSIM of two [..., H, W, C] images (tensors or numpy arrays), in fp32.

  Returns:
    The mean SSIM over the last three axes, a tensor of the leading
    shape, or with return_map the [..., H - filter_size + 1,
    W - filter_size + 1, C] map.
  """
  img0 = torch.as_tensor(img0, dtype=torch.float32)
  img1 = torch.as_tensor(img1, dtype=torch.float32, device=img0.device)
  hw = filter_size // 2
  shift = (2 * hw - filter_size + 1) / 2
  f_i = ((torch.arange(filter_size, dtype=torch.float32, device=img0.device)
          - hw + shift) / filter_sigma)**2
  filt = torch.exp(-0.5 * f_i)
  filt = filt / filt.sum()
  # A convolution flips its kernel; conv2d correlates.
  filt = filt.flip(0)

  lead, (h, w, c) = img0.shape[:-3], img0.shape[-3:]

  def filt_fn(z):
    """Along W, then along H, each channel of each image on its own."""
    z = z.movedim(-1, -3).reshape(-1, 1, h, w)
    z = F.conv2d(z, filt.reshape(1, 1, 1, -1))
    z = F.conv2d(z, filt.reshape(1, 1, -1, 1))
    return z.reshape(*lead, c, *z.shape[-2:]).movedim(-3, -1)

  mu0 = filt_fn(img0)
  mu1 = filt_fn(img1)
  mu00 = mu0 * mu0
  mu11 = mu1 * mu1
  mu01 = mu0 * mu1
  sigma00 = filt_fn(img0**2) - mu00
  sigma11 = filt_fn(img1**2) - mu11
  sigma01 = filt_fn(img0 * img1) - mu01

  sigma00 = torch.clamp(sigma00, min=0.0)
  sigma11 = torch.clamp(sigma11, min=0.0)
  sigma01 = torch.sign(sigma01) * torch.minimum(
      torch.sqrt(sigma00 * sigma11), sigma01.abs())

  c1 = (k1 * max_val)**2
  c2 = (k2 * max_val)**2
  numer = (2 * mu01 + c1) * (2 * sigma01 + c2)
  denom = (mu00 + mu11 + c1) * (sigma00 + sigma11 + c2)
  ssim_map = numer / denom
  return ssim_map if return_map else ssim_map.mean(dim=(-3, -2, -1))
