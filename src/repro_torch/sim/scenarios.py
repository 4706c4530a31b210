"""Client-behavior scenarios for the simulation engine (DESIGN.md §4).

A ``Scenario`` is a declarative, composable description of how a federated
client population behaves — data heterogeneity (Dirichlet α wired to
``data/partition.py``), compute speed (lognormal tiers), availability
(diurnal phone-style duty cycles), upload loss (Bernoulli or trace-driven
dropouts), network (bandwidth-tiered upload latency), and adversarial
timing (straggler bursts). ``registry()`` exposes the named presets; any
field can be overridden with ``dataclasses.replace`` to compose new ones.

``ClientBehavior`` is the runtime object the engines consume. It holds one
seeded RNG stream **per client** so draw ``k`` for client ``i`` depends
only on ``(seed, i, k)`` — never on which protocol, engine, or buffer
size consumed it. That is what makes sync-vs-async (and paper-vs-FedBuff)
wall-clock comparisons fair: every run sees identical per-client
durations. Recorded draws round-trip through ``sim.traces`` so any
timeline can be replayed exactly.

The PCG64 streams here are host objects — O(N) Python state. This
module is a numpy-only copy of the JAX package's ``sim/scenarios.py``, so
both packages draw byte-identical client timelines from the same seed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.utils.rngstate import pack_pcg64, unpack_pcg64


# ---------------------------------------------------------------------------
# latency model (moved from core/simulator.py; core re-exports for compat)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LatencyModel:
    """Per-client round duration = speed_factor * lognormal + comm."""

    speed_factors: np.ndarray  # (N,) multiplicative slowness per client
    base_mean: float = 1.0
    sigma: float = 0.25
    comm: float = 0.1

    @staticmethod
    def heterogeneous(num_clients: int, max_slowdown: float = 10.0,
                      seed: int = 0, **kw) -> "LatencyModel":
        rng = np.random.default_rng(seed)
        # log-uniform speed factors in [1, max_slowdown]
        f = np.exp(rng.uniform(0.0, np.log(max_slowdown), num_clients))
        return LatencyModel(speed_factors=np.sort(f), **kw)

    def sample(self, rng: np.random.Generator, client: int) -> float:
        """Legacy shared-stream draw (kept for launch/train.py schedules)."""
        dur = self.speed_factors[client] * rng.lognormal(
            mean=np.log(self.base_mean), sigma=self.sigma)
        return float(dur + self.comm)


# ---------------------------------------------------------------------------
# scenario description
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Declarative client-population behavior; compose via ``replace``."""

    name: str
    description: str = ""
    # --- data heterogeneity (wired to data/partition.dirichlet_partition) --
    alpha: Optional[float] = 0.2  # Dirichlet label-skew; None => IID
    # --- compute: per-client speed = tier_speed * logU[1, max_slowdown] ----
    compute_tiers: Tuple[float, ...] = (1.0,)  # multiplicative tier slowness
    max_slowdown: float = 10.0  # log-uniform spread within a tier
    base_mean: float = 1.0  # lognormal location of one local round
    sigma: float = 0.25  # lognormal shape
    # --- network: upload latency, one tier per client ----------------------
    comm_tiers: Tuple[float, ...] = (0.1,)  # seconds added per upload
    # --- availability: phone-style diurnal duty cycle ----------------------
    diurnal: bool = False
    diurnal_period: float = 24.0  # sim-time length of one "day"
    diurnal_duty: float = 0.5  # fraction of the day a client is online
    # --- dropouts ----------------------------------------------------------
    dropout_p: float = 0.0  # Bernoulli(p) chance an upload is lost
    dropout_trace: Tuple[Tuple[int, int], ...] = ()  # exact (client, k) drops
    # --- adversarial timing ------------------------------------------------
    burst_every: float = 0.0  # 0 = off; else a burst starts each period
    burst_len: float = 2.0  # sim-time length of one burst
    burst_factor: float = 10.0  # duration multiplier inside a burst
    burst_frac: float = 0.25  # fraction of clients hit per burst

    # ------------------------------------------------------------------
    def behavior(self, num_clients: int, seed: int = 0) -> "ClientBehavior":
        return ClientBehavior(self, num_clients, seed)

    def make_dataset(self, num_clients: int, samples_per_client: int = 300,
                     seed: int = 0, noise: float = 1.0):
        """Federated image dataset with this scenario's label skew.

        ``alpha=None`` (IID) uses a huge Dirichlet α, which the partition
        test shows converges to uniform label histograms.
        """
        from repro_torch.data import make_federated_image_dataset
        alpha = 1e5 if self.alpha is None else self.alpha
        return make_federated_image_dataset(
            num_clients=num_clients, samples_per_client=samples_per_client,
            alpha=alpha, noise=noise, seed=seed)


# ---------------------------------------------------------------------------
# runtime behavior: per-client seeded streams (the fair-comparison RNG fix)
# ---------------------------------------------------------------------------


class ClientBehavior:
    """Samples one client population's timeline, one stream per client.

    The engines call, per upload attempt of client ``cid``:
      * ``next_start(cid, t)``   — availability gating (deterministic);
      * ``duration(cid, t)``     — compute + upload time (consumes draw k);
      * ``next_upload(cid)``     — atomically consume the next upload:
                                   its index k AND whether it is lost
                                   (separate drop stream, so dropout
                                   never shifts the duration draws).
    ``upload_index(cid)`` peeks the next index without consuming. All
    draws are recorded; ``drain_log()`` hands them to ``sim.traces``.
    """

    def __init__(self, scenario: Scenario, num_clients: int, seed: int = 0,
                 latency: Optional[LatencyModel] = None):
        self.scenario = scenario
        self.num_clients = int(num_clients)
        self.seed = int(seed)
        sc = scenario
        init = np.random.default_rng(seed)
        n = self.num_clients
        if latency is not None:  # honor an explicit legacy LatencyModel
            self.speed = np.asarray(latency.speed_factors, np.float64)
            self.base_mean = float(latency.base_mean)
            self.sigma = float(latency.sigma)
            self.comm = np.full(n, float(latency.comm))
        else:
            tiers = np.asarray(sc.compute_tiers, np.float64)
            tier_of = init.integers(0, len(tiers), size=n)
            spread = np.exp(init.uniform(0.0, np.log(max(sc.max_slowdown, 1.0 + 1e-9)), n))
            self.speed = np.sort(tiers[tier_of] * spread)
            self.base_mean = float(sc.base_mean)
            self.sigma = float(sc.sigma)
            comm_tiers = np.asarray(sc.comm_tiers, np.float64)
            self.comm = comm_tiers[init.integers(0, len(comm_tiers), size=n)]
        # diurnal phase offsets: where in the "day" each client wakes up
        self.phase = init.uniform(0.0, sc.diurnal_period, size=n)
        # one independent stream pair per client: durations / dropouts
        self._dur_rng = [np.random.default_rng(
            np.random.SeedSequence((self.seed, 101, cid))) for cid in range(n)]
        self._drop_rng = [np.random.default_rng(
            np.random.SeedSequence((self.seed, 202, cid))) for cid in range(n)]
        self._drop_trace = frozenset(tuple(e) for e in sc.dropout_trace)
        self._upload_idx = np.zeros(n, np.int64)  # k: next upload index
        self._durations: List[List[float]] = [[] for _ in range(n)]
        self._drops: List[Tuple[int, int]] = []
        # replay state (sim.traces.TraceBehavior wiring)
        self._replay_dur: Optional[List[List[float]]] = None
        self._replay_drops: Optional[frozenset] = None

    # -- construction helpers ------------------------------------------
    @staticmethod
    def from_latency(latency: LatencyModel, num_clients: int,
                     seed: int = 0) -> "ClientBehavior":
        """Plain lognormal population matching a legacy ``LatencyModel``."""
        sc = Scenario(name="latency-model", description="legacy LatencyModel")
        return ClientBehavior(sc, num_clients, seed, latency=latency)

    # -- availability ---------------------------------------------------
    def next_start(self, cid: int, t: float) -> float:
        """Earliest time >= t the client can start training (diurnal gate)."""
        sc = self.scenario
        if not sc.diurnal:
            return t
        period, on = sc.diurnal_period, sc.diurnal_duty * sc.diurnal_period
        local = (t - self.phase[cid]) % period
        if local < on:
            return t
        return t + (period - local)  # sleep until the next window opens

    # -- durations ------------------------------------------------------
    def duration(self, cid: int, t: float = 0.0) -> float:
        """One train+upload duration draw for client ``cid`` at time ``t``."""
        if self._replay_dur is not None:
            k = len(self._durations[cid])
            recorded = self._replay_dur[cid]
            if k >= len(recorded):
                raise RuntimeError(
                    f"trace exhausted: client {cid} has only {len(recorded)} "
                    f"recorded duration draws but draw {k} was requested — "
                    "record a longer run or lower total_rounds")
            dur = recorded[k]
        else:
            draw = self._dur_rng[cid].lognormal(
                mean=math.log(self.base_mean), sigma=self.sigma)
            dur = float(self.speed[cid] * draw * self._burst_mult(cid, t)
                        + self.comm[cid])
        self._durations[cid].append(dur)
        return dur

    def _burst_mult(self, cid: int, t: float) -> float:
        sc = self.scenario
        if sc.burst_every <= 0.0:
            return 1.0
        j = int(t // sc.burst_every)  # burst index
        if (t % sc.burst_every) >= sc.burst_len:
            return 1.0
        stride = max(1, int(round(1.0 / max(sc.burst_frac, 1e-9))))
        return sc.burst_factor if (cid + j) % stride == 0 else 1.0

    # -- uploads / dropouts ---------------------------------------------
    def upload_index(self, cid: int) -> int:
        """The index k of client ``cid``'s NEXT upload (peek, no advance).

        Dropped uploads consume an index too, so the stream k = 0, 1, ...
        identifies every upload attempt — the key ``sim.traces`` records
        drops and events under.
        """
        return int(self._upload_idx[cid])

    def next_upload(self, cid: int) -> Tuple[int, bool]:
        """Consume client ``cid``'s next upload: returns ``(k, dropped)``.

        The ONE public way the engines advance the upload stream — index
        sampling and the drop decision are atomic, so a caller can never
        read the index of one attempt and the drop verdict of another.
        """
        k = int(self._upload_idx[cid])
        self._upload_idx[cid] += 1
        if self._replay_drops is not None:
            hit = (cid, k) in self._replay_drops
        else:
            sc = self.scenario
            hit = (cid, k) in self._drop_trace
            if not hit and sc.dropout_p > 0.0:
                hit = bool(self._drop_rng[cid].random() < sc.dropout_p)
        if hit:
            self._drops.append((cid, k))
        return k, hit

    # -- trace wiring ---------------------------------------------------
    def drain_log(self) -> Dict:
        """Recorded draws, in per-client order (see sim.traces)."""
        return {"durations": [list(d) for d in self._durations],
                "drops": sorted(self._drops)}

    # -- checkpointing (engine resume; DESIGN.md §7) --------------------
    def get_state(self) -> Dict[str, np.ndarray]:
        """Snapshot the mutable stream state as plain arrays.

        Captures exactly what a resumed engine needs to continue the
        per-client streams where they left off: the upload indices, the
        per-client draw COUNTS (replay-mode behaviors index recorded
        durations by count), and the raw PCG64 generator states of the
        duration and dropout streams. The recorded-draw log itself is
        NOT captured — ``drain_log`` after a resume only covers the
        post-resume draws, which is why ``run_vectorized`` refuses
        ``record_trace`` on a resumed run.
        """
        return {
            "upload_idx": self._upload_idx.copy(),
            "draw_counts": np.asarray([len(d) for d in self._durations],
                                      np.int64),
            "dur_rng": pack_pcg64(self._dur_rng),
            "drop_rng": pack_pcg64(self._drop_rng),
        }

    def set_state(self, state: Dict[str, np.ndarray]) -> None:
        """Restore ``get_state``; the next draw of every stream matches
        what the snapshotted behavior would have drawn next."""
        n = self.num_clients
        upload_idx = np.asarray(state["upload_idx"], np.int64)
        if len(upload_idx) != n:
            raise ValueError(f"state has {len(upload_idx)} clients, "
                             f"behavior has {n}")
        self._upload_idx = upload_idx.copy()
        self._dur_rng = unpack_pcg64(state["dur_rng"])
        self._drop_rng = unpack_pcg64(state["drop_rng"])
        # placeholder entries so replay indexing (len of the draw log)
        # continues from the recorded count
        counts = np.asarray(state["draw_counts"], np.int64)
        self._durations = [[float("nan")] * int(c) for c in counts]
        self._drops = []


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Scenario] = {}


def register(sc: Scenario) -> Scenario:
    if sc.name in _REGISTRY:
        raise ValueError(f"scenario {sc.name!r} already registered")
    _REGISTRY[sc.name] = sc
    return sc


def registry() -> Dict[str, Scenario]:
    """Name -> Scenario for every registered preset (copy; mutate freely)."""
    return dict(_REGISTRY)


def get_scenario(name: str) -> Scenario:
    try:
        return _REGISTRY[name]
    except KeyError:
        known = ", ".join(sorted(_REGISTRY))
        raise KeyError(f"unknown scenario {name!r}; known: {known}") from None


def _deterministic_drop_trace(num_clients: int = 64,
                              every: int = 5) -> Tuple[Tuple[int, int], ...]:
    """Fixed replayable dropout schedule: every ``every``-th upload of every
    third client is lost (a stand-in for a real-device trace file)."""
    return tuple((cid, k) for cid in range(0, num_clients, 3)
                 for k in range(every - 1, 50, every))


register(Scenario(
    name="iid-uniform",
    description="IID data, homogeneous devices, reliable network — the "
                "no-heterogeneity control where all weightings coincide.",
    alpha=None, max_slowdown=1.0, sigma=0.1))
register(Scenario(
    name="paper-fig1",
    description="The paper's §5 setting: Dirichlet α=0.2 label skew, "
                "10x log-uniform device speeds, all clients participating.",
    alpha=0.2, max_slowdown=10.0))
register(Scenario(
    name="dirichlet-mild",
    description="Mild label skew (α=1.0) with the paper's 10x speed spread.",
    alpha=1.0, max_slowdown=10.0))
register(Scenario(
    name="dirichlet-extreme",
    description="Extreme label skew (α=0.1): each client sees ~1-2 classes.",
    alpha=0.1, max_slowdown=10.0))
register(Scenario(
    name="compute-tiers",
    description="Three device tiers (flagship 1x / mid 4x / low-end 16x) "
                "with modest in-tier spread — FLGo-style system skew.",
    alpha=0.3, compute_tiers=(1.0, 4.0, 16.0), max_slowdown=2.0))
register(Scenario(
    name="diurnal-phones",
    description="Phones on a day/night duty cycle: each client trains only "
                "during its ~half of the day (staggered phases).",
    alpha=0.3, max_slowdown=4.0, diurnal=True,
    diurnal_period=24.0, diurnal_duty=0.5))
register(Scenario(
    name="dropout-bernoulli",
    description="Every upload lost independently with p=0.15 (flaky radio).",
    alpha=0.3, max_slowdown=4.0, dropout_p=0.15))
register(Scenario(
    name="dropout-trace",
    description="Trace-driven dropouts: a fixed replayable (client, upload) "
                "loss schedule, identical on every run.",
    alpha=0.3, max_slowdown=4.0,
    dropout_trace=_deterministic_drop_trace()))
register(Scenario(
    name="bandwidth-tiers",
    description="Upload latency tiers (fiber 0.05s / LTE 0.5s / 2G 2.5s): "
                "comm-bound stragglers instead of compute-bound ones.",
    alpha=0.3, max_slowdown=2.0, comm_tiers=(0.05, 0.5, 2.5)))
register(Scenario(
    name="straggler-burst",
    description="Adversarial timing: every 8 sim-seconds a 2s burst slows "
                "a rotating quarter of the fleet by 10x.",
    alpha=0.3, max_slowdown=2.0,
    burst_every=8.0, burst_len=2.0, burst_factor=10.0, burst_frac=0.25))
