"""Sharded bucket-batch sampling (port of neurosis_tpu/data/sampler.py).

Parity: dataset/aspect/sampler.py:15-87. ``ShardedBatchSampler`` shards a
pre-built batch list over replicas with the ``indices[rank::num_replicas]``
stride, padded to a multiple of the replicas, with an epoch-seeded
shuffle: index for index JAX's (numpy's generator on both sides).

A replica is a node (JAX's process): node k takes whole batches
``[k::nodes]`` of the list every rank builds alike, and the node's ranks
split each batch's rows (``parallel/mesh.py``).
"""

from __future__ import annotations

import math
from typing import Iterator, Optional, Sequence

import numpy as np


class AspectBucketSampler:
    """Single-replica: just the dataset's same-bucket batch schedule."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __iter__(self) -> Iterator[list[int]]:
        return iter(self.dataset.get_batch_iterator())


class ShardedBatchSampler:
    """Rank-strided sharding of a list of pre-built batches (sampler.py:27-87)."""

    def __init__(self, batches: Sequence[list[int]], num_replicas: int = 1, rank: int = 0, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = False):
        if rank >= num_replicas or rank < 0:
            raise ValueError(f"invalid rank {rank} for {num_replicas} replicas")
        self.batches = list(batches)
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        n = len(self.batches)
        if self.drop_last and n % num_replicas:
            self.num_samples = math.ceil((n - num_replicas) / num_replicas)
        else:
            self.num_samples = math.ceil(n / num_replicas)
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.num_samples

    def __iter__(self) -> Iterator[list[int]]:
        n = len(self.batches)
        order = np.random.default_rng(self.seed + self.epoch).permutation(n).tolist() if self.shuffle \
            else list(range(n))
        if not self.drop_last:
            padding = self.total_size - len(order)
            if padding <= len(order):
                order += order[:padding]
            else:
                order += (order * math.ceil(padding / len(order)))[:padding]
        else:
            order = order[: self.total_size]
        assert len(order) == self.total_size
        order = order[self.rank: self.total_size: self.num_replicas]
        assert len(order) == self.num_samples
        return iter(self.batches[i] for i in order)


def shard_batches_for_host(dataset, num_replicas: Optional[int] = None, rank: Optional[int] = None,
                           shuffle: bool = True, seed: int = 0) -> ShardedBatchSampler:
    """This node's sampler: replicas are the nodes of the launcher's
    environment (``parallel.mesh.dist_env``) unless given."""
    if num_replicas is None or rank is None:
        from ..parallel.mesh import dist_env

        env = dist_env()
        num_replicas = env.nodes if num_replicas is None else num_replicas
        rank = env.node if rank is None else rank
    return ShardedBatchSampler(list(dataset.get_batch_iterator()), num_replicas=num_replicas, rank=rank,
                               shuffle=shuffle, seed=seed)
