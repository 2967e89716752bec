"""Safe math helpers and positional encoding.

Counterpart of samplenerfro_tpu/ops/math.py:16-106 and 133-150, and of
the fused MLP's encoding (pe_cols).
"""

import functools
import math

import numpy as np
import torch


def safe_l2_norm(x, eps=1e-6):
  """L2 norm along the last axis, floored at sqrt(eps)."""
  return torch.sqrt(torch.clamp((x**2).sum(dim=-1, keepdim=True), min=eps))


def safe_l2_normalize(x, eps=1e-6):
  return x / safe_l2_norm(x, eps)


def safe_log(x, eps=1e-6):
  return torch.log(torch.clamp(x, min=eps))


def _safe_trig(x, fn, t=100 * math.pi):
  return fn(torch.where(x.abs() < t, x, torch.remainder(x, t)))


def safe_sin(x):
  """sin with range reduction past 100 pi (samplenerfro_tpu/ops/math.py:
  38-48)."""
  return _safe_trig(x, torch.sin)


def safe_cos(x):
  return _safe_trig(x, torch.cos)


def pos_enc(x, min_deg, max_deg, legacy_posenc_order=False, amp=1.0):
  """Concatenate x with sinusoidal features at scales 2^[min_deg, max_deg).

  Returns [..., D + 2*D*(max_deg-min_deg)], in the JAX package's feature
  order (interleaved per degree when legacy_posenc_order).
  """
  if min_deg == max_deg:
    return x
  scales = pe_scales(min_deg, max_deg, x.dtype, x.device)
  lead = list(x.shape[:-1])
  if legacy_posenc_order:
    xb = x[..., None, :] * scales[:, None]
    four_feat = torch.sin(torch.stack([xb, xb + 0.5 * math.pi], dim=-2))
    four_feat = four_feat.reshape(lead + [-1])
  else:
    xb = (x[..., None, :] * scales[:, None]).reshape(lead + [-1])
    four_feat = torch.sin(torch.cat([xb, xb + 0.5 * math.pi], dim=-1))
  return torch.cat([x, amp * four_feat], dim=-1)


@functools.lru_cache(maxsize=None)
def constant(values, dtype, device):
  """The tensor of a tuple of numbers on `device`, made once per device by
  the first (eager) call: a CUDA graph cannot capture the copy from the
  host that makes it. Callers must not write to it."""
  return torch.tensor(values, dtype=dtype, device=device)


def pe_scales(min_deg, max_deg, dtype, device):
  """The [2^min_deg, ..., 2^(max_deg-1)] of pos_enc on `device`."""
  return constant(tuple(2.0**i for i in range(min_deg, max_deg)), dtype,
                  device)


def pe_cols(p, deg):
  """The fused MLP's in-kernel encoding of [..., 3] (K4/K5 with pe):
  [p, sin(xb), sin(xb + pi/2)], xb degree-major and xyz-minor at scales
  2^0 .. 2^(deg-1), the layout of
  samplenerfro_tpu/ops/pallas/mlp_kernel.py:_pe_cols. That is the
  non-legacy pos_enc from degree 0, bit for bit."""
  return pos_enc(p, 0, deg)


def cosine_easing_window(min_freq_log2, max_freq_log2, num_bands, alpha):
  """Nerfies frequency-annealing window (samplenerfro_tpu/ops/math.py:82-88).

  alpha may be a Python float or a 0-d tensor; the result is a [num_bands]
  float32 tensor on alpha's device, differentiable in alpha.
  """
  if max_freq_log2 is None:
    max_freq_log2 = num_bands - 1.0
  alpha = torch.as_tensor(alpha, dtype=torch.float32)
  bands = torch.linspace(min_freq_log2, max_freq_log2, num_bands,
                         dtype=torch.float32, device=alpha.device)
  x = torch.clamp(alpha - bands, 0.0, 1.0)
  return 0.5 * (1 + torch.cos(math.pi * x + math.pi))


def annealed_pos_enc(x, min_deg, max_deg, alpha, amp=1.0):
  """Cosine-annealed positional encoding; does not prepend x.

  Per degree d the features are [sin(x*2^d)*w_d, sin(x*2^d + pi/2)*w_d]
  (samplenerfro_tpu/ops/math.py:91-106). The second half is
  sin(xb + pi/2), not cos(xb): at arguments of up to 1.5*2^9 rad the two
  differ by ulps, which is enough to flip the so3 MLP's ReLU masks.
  """
  if min_deg == max_deg:
    return x
  scales = pe_scales(min_deg, max_deg, x.dtype, x.device)
  xb = x[..., None, :] * scales[:, None]
  window = cosine_easing_window(min_deg, max_deg - 1, max_deg - min_deg,
                                alpha).to(x.device)[:, None]
  four_feat = torch.cat([torch.sin(xb) * window,
                         torch.sin(xb + 0.5 * math.pi) * window], dim=-1)
  return amp * four_feat.reshape(list(x.shape[:-1]) + [-1])


def learning_rate_decay(step, lr_init, lr_final, max_steps, lr_delay_steps=0,
                        lr_delay_mult=1, lr_start_steps=0):
  """Log-lerp decay with warm-up and optional delayed start, as a float.

  samplenerfro_tpu/ops/math.py:133-150, evaluated in float32 on the host
  (the JAX version computes in float32 under jit).
  """
  f32 = np.float32
  step = f32(step)
  if lr_delay_steps > 0:
    delay_rate = f32(lr_delay_mult) + (f32(1) - f32(lr_delay_mult)) * np.sin(
        f32(0.5 * np.pi) * np.clip(step / f32(lr_delay_steps), f32(0),
                                   f32(1)))
  else:
    delay_rate = f32(1.0)
  start_rate = np.clip(step - f32(lr_start_steps), f32(0), f32(1))
  t = np.clip(np.maximum(step - f32(lr_start_steps), f32(0))
              / f32(max_steps - lr_start_steps), f32(0), f32(1))
  log_lerp = np.exp(np.log(f32(lr_init)) * (f32(1) - t)
                    + np.log(f32(lr_final)) * t)
  return float(f32(start_rate * delay_rate * log_lerp))
