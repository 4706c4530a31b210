"""Federated LM training with the cohort step, end to end (the JAX
package's ``examples/train_lm_federated.py``).

Each cohort slot is one FL client with its own non-IID synthetic token
stream; the arrival schedule follows the heterogeneous latency model, so
staleness really occurs; the server applies eq. 3/4/5 each round
(``core/cohort.py::make_cohort_step`` over ``Model.loss``).

The default is a CPU-sized decoder (~12M params). ``--model-dim`` and
``--layers`` scale it up; ``--rounds`` sets the duration.

Run:  PYTHONPATH=src python -m repro_torch.launch.train_lm_federated \\
          --rounds 20 [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import FLConfig, ModelConfig
from repro_torch.core import LatencyModel, init_cohort_state, make_cohort_step
from repro_torch.data.synthetic import make_lm_token_stream
from repro_torch.launch.train import arrival_schedule
from repro_torch.models.model import build_model
from repro_torch.utils import tree_count_params
from repro_torch.utils.device import DeviceLike, resolve_device


def make_config(model_dim: int = 256, layers: int = 4, vocab: int = 2048
                ) -> ModelConfig:
    """The example's decoder at ``--model-dim``, ``--layers``, ``--vocab``."""
    return ModelConfig(
        name="fl-lm", family="dense", num_layers=layers, d_model=model_dim,
        num_heads=max(2, model_dim // 64),
        num_kv_heads=max(2, model_dim // 128), d_ff=4 * model_dim,
        vocab_size=vocab)


def make_fl(buffer_k: int = 3, weighting: str = "paper") -> FLConfig:
    return FLConfig(buffer_size=buffer_k, local_steps=2, local_lr=5e-3,
                    weighting=weighting)


def round_batch(r: int, cohort: int, vocab: int, seq: int, batch: int,
                local_steps: int, arrival: np.ndarray,
                sizes: np.ndarray) -> Dict[str, Any]:
    """Round ``r``'s host batch: per-client non-IID token streams (a
    different bigram structure per slot and round)."""
    local, probe = [], []
    for c in range(cohort):
        t = make_lm_token_stream(vocab, seq, local_steps * batch + 2,
                                 seed=1000 * c + r)
        local.append(t[:local_steps * batch].reshape(local_steps, batch, -1))
        probe.append(t[-2:])
    local = np.stack(local)  # (C, M, b, S+1)
    probe = np.stack(probe)  # (C, 2, S+1)
    return {
        "local": {"tokens": local[..., :-1], "labels": local[..., 1:]},
        "probe": {"tokens": probe[..., :-1], "labels": probe[..., 1:]},
        "arrival": arrival,
        "data_sizes": sizes,
    }


def run(rounds: int = 20, cohort: int = 4, buffer_k: int = 3,
        model_dim: int = 256, layers: int = 4, vocab: int = 2048,
        seq: int = 128, batch: int = 4, weighting: str = "paper", *,
        device: DeviceLike = "cuda", init_params: Optional[Any] = None,
        log: Callable[[str], None] = print) -> List[Dict[str, float]]:
    """Train for ``rounds`` cohort rounds on ``device`` (the card unless the
    caller asks for the CPU; raises without one). ``init_params`` replaces
    the seeded init (tests pass the JAX init, converted). Returns the
    per-round log: ``probe_ce``, ``staleness_min``, ``arrivals``."""
    dev = resolve_device(device)
    cfg = make_config(model_dim, layers, vocab)
    model = build_model(cfg, dev)
    fl = make_fl(buffer_k, weighting)
    params = init_params if init_params is not None else model.init(
        torch.Generator(device="cpu").manual_seed(0))
    log(f"model params: {tree_count_params(params):,}")
    state = init_cohort_state(params, cohort)
    step = make_cohort_step(model.loss, fl, device=dev)

    latency = LatencyModel.heterogeneous(cohort, max_slowdown=6.0, seed=0)
    sched = arrival_schedule(cohort, buffer_k, latency, rounds)
    sizes = np.random.default_rng(0).integers(500, 2000, cohort).astype(
        np.float32)

    history = []
    for r in range(rounds):
        t0 = time.time()
        state, mets = step(state, round_batch(r, cohort, vocab, seq, batch,
                                              fl.local_steps, sched[r], sizes))
        rec = {"probe_ce": float(mets["fresh_loss_mean"]),
               "staleness_min": float(mets["staleness_min"]),
               "arrivals": int(sched[r].sum())}
        history.append(rec)
        log(f"round {r + 1:3d}: probe_ce={rec['probe_ce']:.4f} "
            f"S_min={rec['staleness_min']:.3f} arrivals={rec['arrivals']} "
            f"({time.time() - t0:.1f}s)")
    log(f"final version: {int(state.version)}")
    return history


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--cohort", type=int, default=4)
    ap.add_argument("--buffer-k", type=int, default=3)
    ap.add_argument("--model-dim", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--weighting", default="paper")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    run(args.rounds, args.cohort, args.buffer_k, args.model_dim, args.layers,
        args.vocab, args.seq, args.batch, args.weighting, device=args.device)


if __name__ == "__main__":
    main()
