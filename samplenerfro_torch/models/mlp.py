"""Radiance MLPs as nn.Linear stacks, fp32.

Counterpart of samplenerfro_tpu/models/mlp.py. `layers[i]` is the JAX
module's `Dense_i`: the trunk, then (NerfMLP) the sigma head, the
bottleneck, the condition layers and the RGB head, in that order, so the
weight converter (models/convert.py) maps index to index.
"""

import torch
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

  def forward(self, x, condition=None):
    """x [B, S, F], condition [B, S, C] -> (raw_rgb [B, S, 3], raw_sigma [B, S, 1])."""
    lead = x.shape[:-1]
    x = x.reshape(-1, x.shape[-1])
    inputs = x
    for i in range(self.net_depth):
      x = self.net_activation(self.layers[i](x))
      if i % self.skip_layer == 0 and i > 0:
        x = torch.cat([x, inputs], dim=-1)
    raw_sigma = self.layers[self.net_depth](x)
    k = self.net_depth + 1
    if condition is not None:
      bottleneck = self.layers[k](x)
      k += 1
      x = torch.cat([bottleneck, condition.reshape(-1, condition.shape[-1])],
                    dim=-1)
      for layer in self.layers[k:-1]:
        x = self.net_activation(layer(x))
    raw_rgb = self.layers[-1](x)
    return (raw_rgb.reshape(*lead, -1), raw_sigma.reshape(*lead, -1))


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
