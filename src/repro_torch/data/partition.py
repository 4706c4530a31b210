"""Non-IID partitioners for federated datasets.

``dirichlet_partition`` is the standard label-skew generator (Hsu et al.
2019): client i's label distribution ~ Dir(alpha). Low alpha => extreme
heterogeneity (each client sees few classes), alpha -> inf => IID.
"""
from __future__ import annotations

import numpy as np


def dirichlet_partition(labels: np.ndarray, num_clients: int, alpha: float,
                        seed: int = 0, min_per_client: int = 1):
    """Partition indices of ``labels`` into ``num_clients`` non-IID shards.

    Returns a list of np.ndarray index arrays, one per client. Every sample
    is assigned to exactly one client; each client gets >= min_per_client.
    """
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    num_classes = int(labels.max()) + 1
    class_idx = [np.flatnonzero(labels == c) for c in range(num_classes)]
    for idx in class_idx:
        rng.shuffle(idx)

    while True:
        client_idx = [[] for _ in range(num_clients)]
        for c in range(num_classes):
            props = rng.dirichlet(np.full(num_clients, alpha))
            # split this class's indices proportionally
            counts = np.floor(props * len(class_idx[c])).astype(int)
            # distribute remainder to the largest proportions
            rem = len(class_idx[c]) - counts.sum()
            order = np.argsort(-props)
            for k in range(rem):
                counts[order[k % num_clients]] += 1
            start = 0
            for i in range(num_clients):
                client_idx[i].extend(class_idx[c][start:start + counts[i]])
                start += counts[i]
        sizes = np.array([len(ci) for ci in client_idx])
        if sizes.min() >= min_per_client:
            break
    out = []
    for ci in client_idx:
        arr = np.array(ci, dtype=np.int64)
        rng.shuffle(arr)
        out.append(arr)
    return out


def shard_partition(labels: np.ndarray, num_clients: int, shards_per_client: int = 2,
                    seed: int = 0):
    """McMahan-style pathological split: sort by label, deal out shards."""
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    order = np.argsort(labels, kind="stable")
    num_shards = num_clients * shards_per_client
    shards = np.array_split(order, num_shards)
    perm = rng.permutation(num_shards)
    out = []
    for i in range(num_clients):
        take = perm[i * shards_per_client:(i + 1) * shards_per_client]
        idx = np.concatenate([shards[s] for s in take])
        rng.shuffle(idx)
        out.append(idx.astype(np.int64))
    return out
