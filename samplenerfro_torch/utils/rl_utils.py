"""Prioritized replay buffer and hemisphere action-space helpers.

Counterpart of samplenerfro_tpu/utils/rl_utils.py:19-122, on tensors:
prioritized experience replay over (position, distance, n, grad n)
tuples, a hemisphere action basis and a local-frame transform. No entry
point calls them, in either package. The JAX buffer draws its batches from
numpy's global state; `ReplayBuffer.sample` here draws from the
np.random.RandomState it is given, so the same seed gives the same draws.
"""

import math

import numpy as np
import torch

from samplenerfro_torch.ops import math as math_ops


class ReplayBuffer:
  """Prioritized experience replay (alpha 0.6, beta annealed 0.4 -> 1)."""

  def __init__(self, buffer_size, batch_size, total_episode):
    self.buffer_size = buffer_size
    self.batch_size = batch_size
    self.buffer_counter = 0
    self.batch_indices = None
    self.is_exceed_buffer_size = False
    self.episode = 0
    self.total_episode = total_episode

    self.ray_position_buffer = np.zeros((buffer_size, 3), dtype=np.float32)
    self.ray_distance_buffer = np.zeros((buffer_size, 1), dtype=np.float32)
    self.index_data_buffer = np.zeros((buffer_size, 1), dtype=np.float32)
    self.index_grad_buffer = np.zeros((buffer_size, 3), dtype=np.float32)
    self.priority_buffer = np.zeros((buffer_size, 1), dtype=np.float32)

  def add(self, experience, experience_size):
    """Append (pos, dist, n, grad, td_error) tuples, ring-buffer style."""
    for i in range(experience_size):
      if (not self.is_exceed_buffer_size
          and self.buffer_counter == self.buffer_size):
        self.is_exceed_buffer_size = True
      self.buffer_counter = self.buffer_counter % self.buffer_size
      self.ray_position_buffer[self.buffer_counter] = experience[0][i]
      self.ray_distance_buffer[self.buffer_counter] = experience[1][i]
      self.index_data_buffer[self.buffer_counter] = experience[2][i]
      self.index_grad_buffer[self.buffer_counter] = experience[3][i]
      self.priority_buffer[self.buffer_counter] = (
          np.abs(experience[4][i]) + 1e-4)
      self.buffer_counter += 1

  def _batch(self, indices):
    return tuple(torch.from_numpy(buf[indices]) for buf in (
        self.ray_position_buffer, self.ray_distance_buffer,
        self.index_data_buffer, self.index_grad_buffer))

  def sample(self, rng):
    """A priority-weighted batch drawn from `rng` (np.random.RandomState)
    and its importance weights: (pos, dist, n, grad, weights) tensors."""
    proba = self.priority_buffer[:, 0]**0.6
    proba = proba / np.sum(proba)
    if self.is_exceed_buffer_size:
      batch_indices = rng.choice(self.buffer_size, self.batch_size, p=proba)
    else:
      batch_indices = rng.choice(
          self.buffer_counter, self.batch_size,
          p=proba[:self.buffer_counter], replace=True)
    weight_batch = torch.from_numpy(np.asarray(
        (1.0 / (self.buffer_size * self.priority_buffer[batch_indices]))
        ** (0.4 + self.episode / self.total_episode * 0.6), np.float32))
    weight_batch = weight_batch / weight_batch.max()
    self.batch_indices = batch_indices
    return self._batch(batch_indices) + (weight_batch,)

  def peek(self):
    """Re-read the last sampled batch."""
    return self._batch(self.batch_indices)

  def update(self, td_error):
    self.priority_buffer[self.batch_indices] = np.abs(td_error) + 1e-4


def square_to_hemisphere(r1, r2, exp=0.0):
  """Unit square -> hemisphere (exp 0 cosine-, exp 1 uniform-weighted)."""
  cos_phi = torch.cos(2.0 * math.pi * r1)
  sin_phi = torch.sin(2.0 * math.pi * r1)
  cos_theta = (1.0 - r2)**(1.0 / (exp + 1.0))
  sin_theta = torch.sqrt(1.0 - cos_theta * cos_theta)
  return torch.cat([sin_theta * cos_phi, sin_theta * sin_phi, cos_theta],
                   dim=-1)


def compute_action_space(square_size, shrink=0.0):
  """square_size^2 hemisphere directions on a stratified lattice."""
  y, x = torch.meshgrid(torch.linspace(0, 1 - shrink, square_size + 1),
                        torch.linspace(0, 1, square_size + 1), indexing="ij")
  r = torch.stack([x, y], dim=-1)
  r = 0.5 * (r[1:, 1:] + r[:-1, :-1])
  r = r.reshape(-1, 2)
  return square_to_hemisphere(r[:, 0:1], r[:, 1:2], exp=1.0)


def local_axis(from_here, to_there, dataset="blender", eps=1e-6):
  """The actions from_here [A, 3] in the local frame of each direction
  to_there [B, S, 3]: [B, S, A, 3], carrying no gradient."""
  w = math_ops.safe_l2_normalize(to_there)[:, :, None]
  if dataset == "blender":
    up = torch.tensor([0, eps, 1], dtype=w.dtype, device=w.device)[None]
  elif dataset == "opencv":
    up = torch.tensor([0, 1, eps], dtype=w.dtype, device=w.device)[None]
  else:
    raise ValueError(dataset)
  v = math_ops.safe_l2_normalize(torch.cross(w, up.expand_as(w), dim=-1))
  u = math_ops.safe_l2_normalize(torch.cross(w, v, dim=-1))
  return (from_here[None, None, :, 0:1] * u
          + from_here[None, None, :, 1:2] * v
          + from_here[None, None, :, 2:3] * w).detach()
