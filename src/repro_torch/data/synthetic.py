"""Synthetic datasets.

This container is offline, so the paper's Fashion-MNIST experiment is
reproduced on a *synthetic class-clustered image dataset* with the same
cardinality and shape (28x28x1, 10 classes). Each class c has a random
prototype image P_c; samples are P_c + Gaussian noise + random shift. What
the paper's claim exercises — non-IID label skew across async clients — is
preserved exactly by this generator + the Dirichlet partitioner.

Also provides a synthetic LM token stream for the big-architecture training
paths (power-law unigram over the vocab so loss has learnable structure).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.data.partition import dirichlet_partition


@dataclasses.dataclass
class ClientDataset:
    """In-memory dataset for one federated client."""

    x: np.ndarray  # (n, ...) features
    y: np.ndarray  # (n,) int labels (or next tokens)
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    @property
    def size(self) -> int:
        return int(self.x.shape[0])

    def batch_indices(self, batch_size: int) -> np.ndarray:
        """One batch worth of sample indices (replacement iff n < batch)."""
        n = self.size
        return self._rng.choice(n, size=batch_size, replace=n < batch_size)

    def batch(self, batch_size: int):
        """Sample a random mini-batch (with replacement if n < batch_size)."""
        idx = self.batch_indices(batch_size)
        return self.x[idx], self.y[idx]

    def batches(self, batch_size: int, count: int):
        """``count`` stacked mini-batches, (count, B, ...), in ONE gather.

        Index draws are ``count`` sequential ``batch_indices`` calls, so
        the RNG stream — and therefore every batch — is bit-identical to
        ``count`` successive ``batch()`` calls; only the per-batch fancy
        indexing and stacking (the host-side cost at large N) collapses
        into a single vectorized gather + reshape.
        """
        idx = np.concatenate([self.batch_indices(batch_size)
                              for _ in range(count)])
        return (self.x[idx].reshape(count, batch_size, *self.x.shape[1:]),
                self.y[idx].reshape(count, batch_size, *self.y.shape[1:]))

    # -- checkpointing (engine resume) ----------------------------------
    def rng_state(self) -> np.ndarray:
        """(6,) uint64 snapshot of the batch-sampling stream."""
        from repro_torch.utils.rngstate import pack_pcg64
        return pack_pcg64([self._rng])[0]

    def set_rng_state(self, row: np.ndarray) -> None:
        """Restore ``rng_state``: the next batch draw continues the
        snapshotted stream exactly."""
        from repro_torch.utils.rngstate import unpack_pcg64
        self._rng = unpack_pcg64(np.asarray(row)[None])[0]


def synthetic_image_classes(num_samples: int, num_classes: int = 10,
                            shape=(28, 28, 1), noise: float = 0.35,
                            seed: int = 0):
    """Class-clustered images: per-class smooth prototype + noise."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(0.0, 1.0, size=(num_classes,) + tuple(shape)).astype(np.float32)
    # low-pass the prototypes so classes are "image-like" (local structure)
    for _ in range(2):
        protos = 0.5 * protos + 0.25 * (np.roll(protos, 1, axis=1) + np.roll(protos, -1, axis=1))
        protos = 0.5 * protos + 0.25 * (np.roll(protos, 1, axis=2) + np.roll(protos, -1, axis=2))
    y = rng.integers(0, num_classes, size=num_samples).astype(np.int32)
    x = protos[y] + noise * rng.normal(size=(num_samples,) + tuple(shape)).astype(np.float32)
    return x.astype(np.float32), y


def make_federated_image_dataset(num_clients: int = 30, samples_per_client: int = 1500,
                                 num_classes: int = 10, alpha: float = 0.3,
                                 noise: float = 0.35, seed: int = 0,
                                 test_fraction: float = 0.1):
    """Paper-experiment setup: 30 clients x 1500 samples, non-IID Dirichlet.

    Returns (clients: List[ClientDataset], (x_test, y_test)).
    """
    total = num_clients * samples_per_client
    n_test = int(total * test_fraction)
    x, y = synthetic_image_classes(total + n_test, num_classes=num_classes,
                                   noise=noise, seed=seed)
    x_test, y_test = x[total:], y[total:]
    x, y = x[:total], y[:total]
    parts = dirichlet_partition(y, num_clients, alpha=alpha, seed=seed + 1,
                                min_per_client=8)
    clients = []
    for i, idx in enumerate(parts):
        # equalize sizes to samples_per_client by resampling (paper: equal sizes)
        rng = np.random.default_rng(seed + 100 + i)
        if len(idx) >= samples_per_client:
            idx = idx[:samples_per_client]
        else:
            idx = np.concatenate([idx, rng.choice(idx, samples_per_client - len(idx))])
        clients.append(ClientDataset(x=x[idx], y=y[idx], seed=seed + 200 + i))
    return clients, (x_test, y_test)


def make_lm_token_stream(vocab_size: int, seq_len: int, num_sequences: int,
                         seed: int = 0, order: int = 2):
    """Synthetic token stream with learnable bigram structure.

    Tokens follow a sparse random bigram transition over a power-law
    unigram, so cross-entropy decreases materially under training.
    Returns tokens (num_sequences, seq_len+1) int32 — inputs are [:, :-1],
    labels are [:, 1:].
    """
    rng = np.random.default_rng(seed)
    v = int(vocab_size)
    # power-law unigram
    ranks = np.arange(1, v + 1)
    unigram = 1.0 / ranks ** 1.1
    unigram /= unigram.sum()
    # rng.choice(v, size, p=unigram) is cdf.searchsorted(rng.random(size),
    # "right") with this cdf: the same draws, without rebuilding the
    # vocabulary-long cdf at every step
    cdf = unigram.cumsum()
    cdf /= cdf[-1]

    def draw_unigram(n):
        return cdf.searchsorted(rng.random(n), side="right")

    # each token deterministically prefers a small successor set
    succ = rng.integers(0, v, size=(v, 4))
    toks = np.empty((num_sequences, seq_len + 1), dtype=np.int64)
    toks[:, 0] = draw_unigram(num_sequences)
    for t in range(seq_len):
        prev = toks[:, t]
        use_bigram = rng.random(num_sequences) < 0.8
        choice = succ[prev, rng.integers(0, 4, size=num_sequences)]
        rand = draw_unigram(num_sequences)
        toks[:, t + 1] = np.where(use_bigram, choice, rand)
    return toks.astype(np.int32)


def make_federated_lm_dataset(num_clients: int, vocab_size: int, seq_len: int,
                              sequences_per_client: int, seed: int = 0):
    """Per-client LM shards with heterogeneous token distributions."""
    clients: List[ClientDataset] = []
    for i in range(num_clients):
        # heterogeneity: each client's stream uses a shifted successor table
        toks = make_lm_token_stream(vocab_size, seq_len, sequences_per_client,
                                    seed=seed + 31 * i)
        clients.append(ClientDataset(x=toks[:, :-1], y=toks[:, 1:], seed=seed + i))
    return clients
