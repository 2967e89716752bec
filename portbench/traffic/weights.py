"""The model's weights, made on the device from the seed.

One uniform draw on the device's generator covers every leaf, sliced and
scaled leaf by leaf: weights at Glorot's uniform range, biases within
+-0.05, the so3 head's output layer (weights and biases) at a standard deviation of so3_std
(a head whose rotations bend the paths as a trained one does).
"""

import math

import torch


def make(shapes, seed, device, so3_std):
  """{leaf name: float32 tensor on `device`} for the leaves `shapes`."""
  sizes = [math.prod(s) for s in shapes.values()]
  gen = torch.Generator(device=device).manual_seed(int(seed) + 17)
  u = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
  out, at = {}, 0
  for (name, shape), n in zip(shapes.items(), sizes):
    if "so3_mlp.layers.Dense_out" in name:
      lim = so3_std * math.sqrt(3.0)
    elif name.endswith(".bias"):
      lim = 0.05
    else:
      lim = math.sqrt(6.0 / (shape[0] + shape[1]))
    out[name] = (u[at:at + n] * lim).reshape(shape)
    at += n
  return out
