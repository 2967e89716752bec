"""Radiance MLPs as nn.Linear stacks.

Counterpart of samplenerfro_tpu/models/mlp.py. `layers[i]` is the JAX
module's `Dense_i`: the trunk, then (NerfMLP) the sigma head, the
bottleneck, the condition layers and the RGB head, in that order, so the
weight converter (models/convert.py) maps index to index. NerfMLP computes
in fp32 or, for training with `mlp_dtype=bfloat16`, in bf16 with fp32
parameters and fp32 outputs, as flax's `Dense(dtype=bfloat16,
param_dtype=float32)` does (samplenerfro_tpu/models/mlp.py:41-64).
"""

import torch
import torch.nn.functional as F
from torch import nn


def _init_linear(layer, generator):
  """Glorot-uniform weight and zero bias, as the JAX package's Dense init."""
  nn.init.xavier_uniform_(layer.weight, generator=generator)
  nn.init.zeros_(layer.bias)


class NerfMLP(nn.Module):
  """JaxNeRF trunk with density and view-conditioned RGB heads."""

  def __init__(self, in_dim, cond_dim=None, net_depth=8, net_width=256,
               net_depth_condition=1, net_width_condition=128,
               net_activation=torch.relu, skip_layer=4, num_rgb_channels=3,
               num_sigma_channels=1, generator=None):
    super().__init__()
    self.net_depth = net_depth
    self.skip_layer = skip_layer
    self.net_activation = net_activation
    self.has_condition = cond_dim is not None
    layers, width = [], in_dim
    for i in range(net_depth):
      layers.append(nn.Linear(width, net_width))
      width = net_width + (in_dim if i % skip_layer == 0 and i > 0 else 0)
    layers.append(nn.Linear(width, num_sigma_channels))
    if self.has_condition:
      layers.append(nn.Linear(width, net_width))
      width = net_width + cond_dim
      for _ in range(net_depth_condition):
        layers.append(nn.Linear(width, net_width_condition))
        width = net_width_condition
    layers.append(nn.Linear(width, num_rgb_channels))
    self.layers = nn.ModuleList(layers)
    for layer in self.layers:
      _init_linear(layer, generator)

  def forward(self, x, condition=None, dtype=torch.float32):
    """x [B, S, F], condition [B, S, C] -> (raw_rgb [B, S, 3], raw_sigma [B, S, 1]).

    `dtype` is the compute type: inputs, weights and biases are cast to it
    and every layer's output rounds to it; the outputs return as fp32.
    """
    lead = x.shape[:-1]
    x = x.reshape(-1, x.shape[-1]).to(dtype)

    def dense(i, h):
      layer = self.layers[i]
      return F.linear(h, layer.weight.to(dtype), layer.bias.to(dtype))

    inputs = x
    for i in range(self.net_depth):
      x = self.net_activation(dense(i, x))
      if i % self.skip_layer == 0 and i > 0:
        x = torch.cat([x, inputs], dim=-1)
    raw_sigma = dense(self.net_depth, x)
    k = self.net_depth + 1
    if condition is not None:
      bottleneck = dense(k, x)
      k += 1
      cond = condition.reshape(-1, condition.shape[-1]).to(dtype)
      x = torch.cat([bottleneck, cond], dim=-1)
      for i in range(k, len(self.layers) - 1):
        x = self.net_activation(dense(i, x))
    raw_rgb = dense(len(self.layers) - 1, x)
    return (raw_rgb.float().reshape(*lead, -1),
            raw_sigma.float().reshape(*lead, -1))


class MLP(nn.Module):
  """Generic skip-MLP without a condition tail (the background envmap head)."""

  def __init__(self, in_dim, net_depth=4, net_width=128,
               net_activation=torch.relu, skip_layer=2, num_out_channels=3,
               generator=None):
    super().__init__()
    self.net_depth = net_depth
    self.skip_layer = skip_layer
    self.net_activation = net_activation
    layers, width = [], in_dim
    for i in range(net_depth):
      layers.append(nn.Linear(width, net_width))
      width = net_width + (in_dim if i % skip_layer == 0 and i > 0 else 0)
    layers.append(nn.Linear(width, num_out_channels))
    self.layers = nn.ModuleList(layers)
    for layer in self.layers:
      _init_linear(layer, generator)

  def forward(self, x):
    lead = x.shape[:-1]
    x = x.reshape(-1, x.shape[-1])
    inputs = x
    for i in range(self.net_depth):
      x = self.net_activation(self.layers[i](x))
      if i % self.skip_layer == 0 and i > 0:
        x = torch.cat([x, inputs], dim=-1)
    return self.layers[-1](x).reshape(*lead, -1)
