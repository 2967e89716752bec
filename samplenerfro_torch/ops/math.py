"""Safe math helpers and positional encoding.

Counterpart of samplenerfro_tpu/ops/math.py:16-69.
"""

import math

import torch


def safe_l2_norm(x, eps=1e-6):
  """L2 norm along the last axis, floored at sqrt(eps)."""
  return torch.sqrt(torch.clamp((x**2).sum(dim=-1, keepdim=True), min=eps))


def safe_l2_normalize(x, eps=1e-6):
  return x / safe_l2_norm(x, eps)


def safe_log(x, eps=1e-6):
  return torch.log(torch.clamp(x, min=eps))


def pos_enc(x, min_deg, max_deg, legacy_posenc_order=False, amp=1.0):
  """Concatenate x with sinusoidal features at scales 2^[min_deg, max_deg).

  Returns [..., D + 2*D*(max_deg-min_deg)], in the JAX package's feature
  order (interleaved per degree when legacy_posenc_order).
  """
  if min_deg == max_deg:
    return x
  scales = torch.tensor([2.0**i for i in range(min_deg, max_deg)],
                        dtype=x.dtype, device=x.device)
  lead = list(x.shape[:-1])
  if legacy_posenc_order:
    xb = x[..., None, :] * scales[:, None]
    four_feat = torch.sin(torch.stack([xb, xb + 0.5 * math.pi], dim=-2))
    four_feat = four_feat.reshape(lead + [-1])
  else:
    xb = (x[..., None, :] * scales[:, None]).reshape(lead + [-1])
    four_feat = torch.sin(torch.cat([xb, xb + 0.5 * math.pi], dim=-1))
  return torch.cat([x, amp * four_feat], dim=-1)
