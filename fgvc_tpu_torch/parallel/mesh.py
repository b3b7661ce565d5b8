"""The data-parallel layout of a global batch (fgvc_tpu/parallel/mesh.py).

The JAX package shards a global batch over a 'data' mesh axis: one
jax.Array whose leading dimension is split over the devices, so a
permutation of it is a plain gather.  In the port each process holds its own
slice of the global batch (rank r holds rows r*b .. (r+1)*b - 1, b = B /
world), so:

* `shard_batch` / `local_slice` give this process's slice of a global
  batch (what jax.device_put with the 'data' sharding gives each device);
* `batch_shuffle` / `batch_unshuffle` (the MoCo shuffle-BN of the
  reference, _batch_shuffle_ddp) gather the slices, apply one permutation
  every process draws alike, and keep this process's slice; the inverse
  restores the original order.  With one process they are gathers by the
  permutation, as in JAX.  `perm` may be given (a test hands JAX's, whose
  random bits are not torch's).
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from fgvc_tpu_torch.parallel.dist import all_gather_rows, process_info


def local_slice(x, rank: Optional[int] = None, world: Optional[int] = None):
    """Rows rank*b .. (rank+1)*b - 1 of a global batch (array or tensor),
    b = len(x) / world (check_train_ported refuses a global batch that
    does not divide); the process group's rank and world by default."""
    if rank is None or world is None:
        rank, world = process_info()
    b = x.shape[0] // world
    return x[rank * b:(rank + 1) * b]


def shard_batch(batch: Mapping, rank: Optional[int] = None, world: Optional[int] = None):
    """This process's slice of every array of a global batch."""
    return {k: local_slice(v, rank, world) for k, v in batch.items()}


def batch_shuffle(x: torch.Tensor, generator: Optional[torch.Generator] = None,
                  perm=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(this process's slice of the shuffled global batch, unshuffle index).
    `x` is this process's slice; the permutation of the global batch is
    `perm`, else torch.randperm from `generator`, which every process must
    seed alike."""
    full = all_gather_rows(x)
    n = full.shape[0]
    if perm is None:
        perm = torch.randperm(n, generator=generator)
    perm = torch.as_tensor(np.array(perm), dtype=torch.long).to(x.device)
    inv = torch.argsort(perm)
    return local_slice(full.index_select(0, perm)), inv


def batch_unshuffle(x: torch.Tensor, unshuffle_idx: torch.Tensor) -> torch.Tensor:
    """The inverse of batch_shuffle: this process's slice of the global batch
    in its original order."""
    full = all_gather_rows(x)
    return local_slice(full.index_select(0, unshuffle_idx.to(x.device)))
