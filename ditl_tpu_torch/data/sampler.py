"""Rank/world-size-aware index sharding with epoch-seeded shuffling: a copy
of the JAX package's ``data/sampler.py`` (on one card: rank 0 of 1).

- **Equal split**: every replica yields exactly ``ceil(N / num_replicas)``
  indices (``floor`` with ``drop_last``).
- **Padding**: when ``N % num_replicas != 0`` the index list is extended by
  repeating leading indices; ``drop_last`` truncates instead.
- **Interleaved assignment**: replica ``r`` takes ``indices[r::num_replicas]``.
- **Epoch-seeded shuffle**: permutation seeded by ``seed + epoch``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ShardedSampler"]


class ShardedSampler:
    def __init__(
        self,
        dataset_size: int,
        num_replicas: int,
        rank: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ):
        if not 0 <= rank < num_replicas:
            raise ValueError(f"rank {rank} out of range for {num_replicas} replicas")
        if dataset_size <= 0:
            raise ValueError("dataset_size must be positive")
        self.dataset_size = dataset_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        if drop_last and dataset_size % num_replicas:
            self.num_samples = dataset_size // num_replicas
        else:
            self.num_samples = -(-dataset_size // num_replicas)  # ceil
        self.total_size = self.num_samples * self.num_replicas

    def set_epoch(self, epoch: int) -> None:
        """Reseed the shuffle for a new epoch."""
        self.epoch = epoch

    def global_permutation(self) -> np.ndarray:
        """The full (padded/truncated) index order for this epoch."""
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            indices = rng.permutation(self.dataset_size)
        else:
            indices = np.arange(self.dataset_size)
        if not self.drop_last and self.total_size > len(indices):
            pad = self.total_size - len(indices)
            reps = -(-pad // len(indices))
            indices = np.concatenate([indices, np.tile(indices, reps)[:pad]])
        return indices[: self.total_size]

    def local_indices(self) -> np.ndarray:
        """This replica's shard: every ``num_replicas``-th index."""
        return self.global_permutation()[self.rank :: self.num_replicas]

    def __iter__(self):
        return iter(self.local_indices().tolist())

    def __len__(self) -> int:
        return self.num_samples
