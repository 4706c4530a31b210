"""Per-round simulation telemetry: a copy of the JAX package's
``sim/metrics.py`` (numpy only; ``tests/test_torch_obs.py`` pins it).

Pure-numpy summaries computed from a run's ``round_log`` (the engine and
the legacy loop emit the same schema, so these work on either). Three
views the paper's analysis needs:

* **staleness** — how stale the buffered updates actually were (τ in
  rounds and the eq.-3 degree S∈(0,1]);
* **participation** — which clients actually reach the buffer (fast
  devices dominate async FL; the Gini coefficient quantifies it);
* **weight entropy** — how concentrated each round's aggregation weights
  are (uniform FedBuff is log2(K) bits; contribution-aware weighting
  spends bits to discount stale/unhelpful updates).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def weight_entropy(weights: Sequence[float]) -> float:
    """Shannon entropy (bits) of one round's normalised |weights|."""
    w = np.abs(np.asarray(weights, np.float64))
    tot = w.sum()
    if tot <= 0:
        return 0.0
    p = w / tot
    p = p[p > 0]
    return float(-(p * np.log2(p)).sum())


def participation_counts(round_log: List[Dict], num_clients: int) -> np.ndarray:
    """(N,) how many buffered updates each client contributed."""
    counts = np.zeros(num_clients, np.int64)
    for log in round_log:
        for cid in log["clients"]:
            counts[cid] += 1
    return counts


def gini(values: np.ndarray) -> float:
    """Gini coefficient in [0, 1): 0 = perfectly even participation."""
    v = np.sort(np.asarray(values, np.float64))
    n = v.size
    if n == 0 or v.sum() == 0:
        return 0.0
    cum = np.cumsum(v)
    return float((n + 1 - 2 * (cum / cum[-1]).sum()) / n)


def per_round(round_log: List[Dict]) -> List[Dict]:
    """One telemetry dict per server round."""
    out = []
    for log in round_log:
        taus = np.asarray(log["tau"], np.float64)
        s = np.asarray(log["staleness_deg"], np.float64)
        out.append({
            "version": log["version"],
            "tau_mean": float(taus.mean()),
            "tau_max": float(taus.max()),
            "staleness_deg_min": float(s.min()),
            "staleness_deg_mean": float(s.mean()),
            "weight_entropy": weight_entropy(log["weights"]),
            "unique_clients": len(set(log["clients"])),
        })
    return out


def summarize(round_log: List[Dict], num_clients: int) -> Dict:
    """Whole-run roll-up of the per-round telemetry."""
    if not round_log:
        return {"rounds": 0}
    rows = per_round(round_log)
    counts = participation_counts(round_log, num_clients)
    ks = np.asarray([len(log["weights"]) for log in round_log], np.float64)
    return {
        "rounds": len(rows),
        "tau_mean": float(np.mean([r["tau_mean"] for r in rows])),
        "tau_max": int(max(r["tau_max"] for r in rows)),
        "staleness_deg_mean": float(np.mean(
            [r["staleness_deg_mean"] for r in rows])),
        "weight_entropy_mean": float(np.mean(
            [r["weight_entropy"] for r in rows])),
        "weight_entropy_uniform": float(np.log2(max(ks.max(), 1.0))),
        "participation_gini": gini(counts),
        "clients_never_heard": int((counts == 0).sum()),
        "uploads_per_client_mean": float(counts.mean()),
    }
