"""Traffic generators, frozen copies of the port's own.

Kept here so that a change to the program cannot move the yardstick:

* ``lm_token_stream``: ``repro_torch/data/synthetic.py::make_lm_token_stream``
* ``make_batches``: ``repro_torch/launch/train.py::make_batches`` (the LM
  case: no patches, no encoder frames)
* ``heterogeneous_speeds`` / ``LatencyModel``:
  ``repro_torch/sim/scenarios.py::LatencyModel.heterogeneous`` and its
  ``sample``
* ``arrival_schedule``: ``repro_torch/launch/train.py::arrival_schedule``

``portbench/tests/test_portbench_traffic.py`` holds each copy equal to its
original for one seed. Everything is host numpy, drawn from ``--seed``.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def lm_token_stream(vocab_size: int, seq_len: int, num_sequences: int,
                    seed: int = 0) -> np.ndarray:
    """Tokens with a sparse random bigram structure over a power-law
    unigram: (num_sequences, seq_len + 1) int32."""
    rng = np.random.default_rng(seed)
    v = int(vocab_size)
    ranks = np.arange(1, v + 1)
    unigram = 1.0 / ranks ** 1.1
    unigram /= unigram.sum()
    cdf = unigram.cumsum()
    cdf /= cdf[-1]

    def draw_unigram(n):
        return cdf.searchsorted(rng.random(n), side="right")

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


def make_batches(vocab_size: int, cohort: int, m: int, b: int, bp: int,
                 seq: int, rng: np.random.Generator) -> dict:
    """One round's batches: ``local`` leaves (C, M, b, S), ``probe`` leaves
    (C, bp, S), tokens and next-token labels."""
    def toks(lead):
        n = int(np.prod(lead))
        t = lm_token_stream(vocab_size, seq, n,
                            seed=int(rng.integers(1 << 30)))
        return t.reshape(*lead, seq + 1)

    local = toks((cohort, m, b))
    probe = toks((cohort, bp))
    return {
        "local": {"tokens": local[..., :seq], "labels": local[..., 1:seq + 1]},
        "probe": {"tokens": probe[..., :seq], "labels": probe[..., 1:seq + 1]},
    }


@dataclasses.dataclass
class LatencyModel:
    """Per-client round duration = speed_factor * lognormal + comm."""

    speed_factors: np.ndarray
    base_mean: float = 1.0
    sigma: float = 0.25
    comm: float = 0.1

    @staticmethod
    def heterogeneous(num_clients: int, max_slowdown: float = 10.0,
                      seed: int = 0) -> "LatencyModel":
        rng = np.random.default_rng(seed)
        f = np.exp(rng.uniform(0.0, np.log(max_slowdown), num_clients))
        return LatencyModel(speed_factors=np.sort(f))

    def sample(self, rng: np.random.Generator, client: int) -> float:
        dur = self.speed_factors[client] * rng.lognormal(
            mean=np.log(self.base_mean), sigma=self.sigma)
        return float(dur + self.comm)


def arrival_schedule(num_slots: int, k: int, latency: LatencyModel,
                     rounds: int, seed: int = 0) -> np.ndarray:
    """(rounds, num_slots) 0/1 masks: the K slots with the earliest
    completion times arrive each round; stragglers roll over."""
    rng = np.random.default_rng(seed)
    remaining = np.array([latency.sample(rng, i) for i in range(num_slots)])
    out = np.zeros((rounds, num_slots), np.float32)
    for r in range(rounds):
        order = np.argsort(remaining)
        arrive = order[:k]
        out[r, arrive] = 1.0
        t = remaining[arrive].max()
        remaining = remaining - t
        for i in arrive:
            remaining[i] = latency.sample(rng, i)
    return out
