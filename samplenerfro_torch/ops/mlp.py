"""The so3 head's skip-MLP, fp32.

Counterpart of samplenerfro_tpu/ops/mlp.py: `Dense_0..Dense_{depth-1}` with
ReLU, the inputs concatenated after every `skip_layer`-th hidden layer
(after Dense_2 at the shipped depth 4), then `Dense_out`. Hidden kernels
are xavier-uniform and biases zero; the output kernel is normal with
`output_init_std` (1e-5 for the shipped residual head).

The march kernels (ops/march_kernel.py, ops/eikonal_vjp.py) take the
weights as a flat list, `params()`: [W_0, b_0, ..., W_out, b_out] with
each W in nn.Linear's [out, in] layout. `apply_params` is the functional
form both the module and the plain march versions use.
"""

import torch
import torch.nn.functional as F
from torch import nn


def apply_params(params, x, skip_layer=2):
  """Skip-MLP of flat params [W_0, b_0, ..., W_out, b_out] on [..., in]."""
  lead = x.shape[:-1]
  x = x.reshape(-1, x.shape[-1])
  inputs = x
  depth = len(params) // 2 - 1
  for i in range(depth):
    x = torch.relu(F.linear(x, params[2 * i], params[2 * i + 1]))
    if i % skip_layer == 0 and i > 0:
      x = torch.cat([x, inputs], dim=-1)
  x = F.linear(x, params[-2], params[-1])
  return x.reshape(*lead, x.shape[-1])


class So3MLP(nn.Module):
  """The path sampler's residual-gradient MLP (VoxMLP's so3 head)."""

  def __init__(self, in_dim, net_depth=4, net_width=128, skip_layer=2,
               num_out_channels=3, output_init_std=1e-5, generator=None):
    super().__init__()
    self.skip_layer = skip_layer
    self.layers = nn.ModuleDict()
    dim = in_dim
    for i in range(net_depth):
      layer = nn.Linear(dim, net_width)
      nn.init.xavier_uniform_(layer.weight, generator=generator)
      nn.init.zeros_(layer.bias)
      self.layers[f"Dense_{i}"] = layer
      dim = net_width + (in_dim if i % skip_layer == 0 and i > 0 else 0)
    out = nn.Linear(dim, num_out_channels)
    if output_init_std is None:
      nn.init.xavier_uniform_(out.weight, generator=generator)
    else:
      nn.init.normal_(out.weight, std=output_init_std, generator=generator)
    nn.init.zeros_(out.bias)
    self.layers["Dense_out"] = out

  def params(self):
    """[W_0, b_0, ..., W_out, b_out] in layer order."""
    out = []
    for layer in self.layers.values():
      out += [layer.weight, layer.bias]
    return out

  def forward(self, x):
    return apply_params(self.params(), x, self.skip_layer)
