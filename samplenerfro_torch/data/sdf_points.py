"""Threaded SDF point sampler for IOR-field pretraining experiments.

Counterpart of samplenerfro_tpu/data/sdf_points.py: a daemon thread
fills a queue with batches of 3D points labelled with IOR 1.33 inside the
proxy mesh <data_dir>/mesh.obj and 1.0 outside. Half of a batch is
uniform in a +-3 cube, half near the surface (surface samples plus
N(0, 0.01) noise), and up to a quarter of guaranteed-inside points is
appended. The draws come from an explicit np.random.RandomState, with
the same calls in the same order as the JAX sampler makes them on numpy's
global state, and the mesh queries from the port's tools/sdf.SDF. No
entry point trains on it, in either package.
"""

import os
import queue
import threading

import numpy as np

from samplenerfro_torch.parallel import mesh as mesh_lib
from samplenerfro_torch.tools import objio
from samplenerfro_torch.tools import sdf as sdflib


class Dataset(threading.Thread):
  """Iterator of {"samples": [B, 3], "labels": [B, 1]} float32 batches."""

  def __init__(self, args, rng):
    super().__init__(daemon=True)
    self.queue = queue.Queue(3)
    mesh = objio.load(os.path.join(args.data_dir, "mesh.obj"))
    self.extents = mesh.extents
    self.bounds = mesh.bounds
    self.sdf = sdflib.SDF(mesh.vertices, mesh.faces)
    # This rank's share (samplenerfro_tpu/data/sdf_points.py:34).
    self.batch_size = mesh_lib.per_rank(args.batch_size, "batch_size")
    self.rng = rng
    self.start()

  def __iter__(self):
    return self

  def __next__(self):
    return self.queue.get()

  def run(self):
    while True:
      self.queue.put(self._next_batch())

  def _next_batch(self):
    num_samples = self.batch_size // 4
    extent = 3
    rand_sample = (self.rng.rand(self.batch_size // 2, 3) * extent * 2.0
                   - extent)
    near_sample = self.sdf.sample_surface(num_samples * 2).astype(np.float64)
    near_sample += self.rng.normal(scale=0.01, size=(num_samples * 2, 3))
    points = (self.rng.random_sample((num_samples, 3)) * self.extents
              + self.bounds[0])
    contained = self.sdf.contains(points)
    surf_sample = points[contained][:num_samples]
    ns = surf_sample.shape[0]
    samples = np.concatenate(
        [rand_sample[:(self.batch_size // 2 - ns)], near_sample], axis=0)
    labels = self.sdf.contains(samples)[..., None]
    labels = np.concatenate(
        [labels.astype(np.float32), np.ones((ns, 1))], axis=0)
    return {
        "samples": np.concatenate([samples, surf_sample], axis=0).astype(
            np.float32),
        "labels": np.where(labels > 0.5, 1.33, 1.0).astype(np.float32),
    }
