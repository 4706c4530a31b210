"""Engine-independent simulation types and helpers (numpy only).

A copy of the JAX package's ``sim/base.py``: the host-side types and
round-log helpers are framework-free, so both packages produce the same
round-log rows and eval history from the same fetched arrays. Kept free
of ``repro_torch.core`` imports so ``repro_torch.core.simulator`` can
re-export these at module level without an import cycle.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.sim.scenarios import ClientBehavior, LatencyModel, Scenario
from repro_torch.sim.traces import EventTrace


@dataclasses.dataclass
class SimResult:
    history: List[Dict]  # per-eval: {round, time, **metrics}
    server_rounds: int
    sim_time: float
    round_log: List[Dict]
    num_events: int = 0  # uploads processed (incl. dropped)
    num_launches: int = 0  # chunk dispatches issued (0 = runner doesn't count)
    trace: Optional[EventTrace] = None
    # the server's parameters after the last round (a nested dict of
    # tensors on the run's device)
    final_params: Optional[object] = None
    # an engine snapshot for resuming (``run_vectorized(capture_state=True)``)
    final_state: Optional[object] = None

    def rounds_to_target(self, metric: str, target: float) -> Optional[int]:
        for h in self.history:
            if h.get(metric, -np.inf) >= target:
                return h["round"]
        return None

    def time_to_target(self, metric: str, target: float) -> Optional[float]:
        for h in self.history:
            if h.get(metric, -np.inf) >= target:
                return h["time"]
        return None


def record_eval(history: List[Dict], eval_fn, version: int, now: float,
                params, eval_every: int, force: bool = False) -> None:
    """Append an eval row, shared by every runner (one cadence rule).

    Rows dedup on (round) unless time advanced: the trailing forced eval
    at run end must not duplicate the final row when
    ``total_rounds % eval_every == 0``.
    """
    if eval_fn is None or not (force or version % eval_every == 0):
        return
    if history and history[-1]["round"] == version \
            and history[-1]["time"] == now:
        return
    history.append({"round": version, "time": now, **eval_fn(params)})


def round_log_rows(v0: int, k: int, clients, taus, logs) -> List[Dict]:
    """Round-log rows for one launch chunk, shared by both engines.

    ``clients``/``taus`` are (S, K) per-round sequences (host lists for
    the event-walk engine, fetched device arrays for the population
    engine); ``logs`` holds the chunk's fetched info arrays (``weights``,
    ``staleness``, ``stat_effect``, ``sq_dists``, each (S, K)). Row ``j``
    documents server version ``v0 + j + 1`` — the version the round
    PRODUCED. Taus/clients are int-cast so device f32 staleness and host
    int lists serialize identically (``round_log_to_arrays`` round-trip).
    """
    rows: List[Dict] = []
    for j in range(len(clients)):
        rows.append({
            "version": v0 + j + 1,
            "weights": np.asarray(logs["weights"][j]).tolist(),
            "staleness_deg": np.asarray(logs["staleness"][j]).tolist(),
            "stat_effect": np.asarray(logs["stat_effect"][j]).tolist(),
            "sq_dists": np.asarray(logs["sq_dists"][j]).tolist(),
            "tau": [int(t) for t in taus[j]],
            "clients": [int(c) for c in clients[j]],
            "k": k,
        })
    return rows


def round_log_to_arrays(round_log: List[Dict]) -> Dict[str, np.ndarray]:
    """Engine round log (list of per-round dicts) -> dict of stacked arrays.

    The npz-friendly form ``checkpoint/ckpt.py`` stores: every per-slot
    field becomes a (T, K) array (f32 — the dtype the device produced, so
    the round-trip is bit-exact), ``clients`` (T, K) int64, ``version``
    (T,) int64. Requires the constant K the engine guarantees
    (K = buffer_size on every round).
    """
    if not round_log:
        return {"version": np.zeros((0,), np.int64)}
    ks = {r["k"] for r in round_log}
    if len(ks) != 1:
        raise ValueError(f"round log mixes buffer sizes {sorted(ks)}")
    out = {
        "version": np.asarray([r["version"] for r in round_log], np.int64),
        "k": np.asarray([r["k"] for r in round_log], np.int64),
        "clients": np.asarray([r["clients"] for r in round_log], np.int64),
        "tau": np.asarray([r["tau"] for r in round_log], np.int64),
    }
    for key in ("weights", "staleness_deg", "stat_effect", "sq_dists"):
        out[key] = np.asarray([r[key] for r in round_log], np.float32)
    return out


def round_log_from_arrays(arrays: Dict[str, np.ndarray]) -> List[Dict]:
    """Inverse of ``round_log_to_arrays``."""
    versions = np.asarray(arrays["version"])
    out: List[Dict] = []
    for j in range(len(versions)):
        out.append({
            "version": int(versions[j]),
            "weights": np.asarray(arrays["weights"][j]).tolist(),
            "staleness_deg": np.asarray(arrays["staleness_deg"][j]).tolist(),
            "stat_effect": np.asarray(arrays["stat_effect"][j]).tolist(),
            "sq_dists": np.asarray(arrays["sq_dists"][j]).tolist(),
            "tau": [int(t) for t in arrays["tau"][j]],
            "clients": [int(c) for c in arrays["clients"][j]],
            "k": int(arrays["k"][j]),
        })
    return out


def history_to_arrays(history: List[Dict]) -> Dict[str, np.ndarray]:
    """Eval history -> dict of (E,) arrays (uniform keys per run)."""
    if not history:
        return {"round": np.zeros((0,), np.int64)}
    keys = set(history[0])
    for h in history:
        if set(h) != keys:
            raise ValueError("history rows have differing keys; cannot stack")
    out: Dict[str, np.ndarray] = {
        "round": np.asarray([h["round"] for h in history], np.int64)}
    for key in sorted(keys - {"round"}):
        out[key] = np.asarray([h[key] for h in history], np.float64)
    return out


def history_from_arrays(arrays: Dict[str, np.ndarray]) -> List[Dict]:
    """Inverse of ``history_to_arrays``."""
    rounds = np.asarray(arrays["round"])
    out: List[Dict] = []
    for j in range(len(rounds)):
        row = {"round": int(rounds[j])}
        for key in sorted(k for k in arrays if k != "round"):
            row[key] = float(np.asarray(arrays[key])[j])
        out.append(row)
    return out


def make_batches(ds, batch_size: int, steps: int):
    """(M, B, ...) stacked local-step batches from a ClientDataset.

    One vectorized gather (``ClientDataset.batches``) with the same index
    stream as ``steps`` sequential ``.batch()`` calls, so every runner
    (legacy loop, vectorized engine, sync FedAvg) sees identical data.
    """
    return ds.batches(batch_size, steps)


def resolve_behavior(n: int, seed: int,
                     behavior: Optional[ClientBehavior] = None,
                     scenario: Optional[Scenario] = None,
                     latency: Optional[LatencyModel] = None,
                     trace: Optional[EventTrace] = None) -> ClientBehavior:
    """One rule for every runner: trace > behavior > scenario > latency.

    A replayed trace needs its scenario's *deterministic* parts back
    (diurnal gating etc.): an explicit ``scenario=``/``behavior=`` wins;
    otherwise the scenario name recorded in the trace is looked up in
    the registry. Unregistered composed scenarios must be re-passed
    explicitly alongside the trace.
    """
    if trace is not None:
        from repro_torch.sim.scenarios import registry
        if scenario is not None:
            sc = scenario
        elif behavior is not None:
            sc = behavior.scenario
        else:
            sc = registry().get(trace.scenario,
                                Scenario(name=trace.scenario or "replay"))
        return trace.replay_behavior(sc)
    if behavior is not None:
        return behavior
    if scenario is not None:
        return scenario.behavior(n, seed)
    latency = latency or LatencyModel.heterogeneous(n, seed=seed)
    return ClientBehavior.from_latency(latency, n, seed)
