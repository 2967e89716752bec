"""PyTorch/CUDA port of samplenerfro_tpu for NVIDIA Hopper GPUs.

The package mirrors the JAX package's layout (ops/, models/, data/, utils/)
and imports nothing of it. Entry points run on the GPU unless the caller
asks for the CPU explicitly.
"""

import torch


def resolve_device(device=None):
  """The torch.device a port entry point runs on.

  No request means CUDA. A CUDA request on a machine without CUDA raises
  instead of running silently on the CPU; pass "cpu" to run there.
  """
  dev = torch.device("cuda" if device is None else device)
  if dev.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError(
        "samplenerfro_torch runs on a CUDA device by default and none is "
        "available; pass device='cpu' (--device=cpu) to run the plain "
        "PyTorch versions of the kernels on the CPU.")
  return dev
