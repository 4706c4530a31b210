"""Vectorized buffered-async FL simulation engine.

The FedBuff structure makes every server round exactly one window of K
uploads, and within a window no aggregation happens until the K-th
upload, so all K clients' local training depends only on state known at
the window start. Each round therefore runs as one K-client batch
(``core/round_body.py``) against a device-resident version ring:

    ring   version store of R = max_staleness + 1 padded flat parameter
           rows (``core/version_store.py``: f32, int8 or delta codec)
    bases  = decode(ring, base_slots)              # flat gather
    deltas = vmap(local_update)(unflatten(bases))  # K clients, one call
    losses = vmap(loss(params, probe_k))           # eq. 4 probes
    x', info = apply_server_round(...)             # eq. 3 + 4 + 5
    ring   = encode(ring, slot(t+1), x')           # flat write, in place

A client's upload timeline never depends on server state, so the host
walks the event heap ahead of the device: it collects up to
``rounds_per_launch`` windows, moves their stacked arrays to the device in
one transfer per array, and runs those S rounds back to back. Round infos
stay on the device; the whole run's round log is fetched ONCE at the end,
never with a per-round host sync. Launch chunks are clipped to eval
boundaries, so the eval cadence matches the JAX engine's. A registry and
a tracer (``obs/``) count the dispatches and host syncs and time the
round-lifecycle spans, as the JAX engine's do.

The host event walk (``collect_window``) is the JAX engine's, unchanged:
uploads in (time, client) heap order, dropped uploads re-pull and retrain,
bases older than the ring resync to the current model with staleness 0.

``capture_state=True`` snapshots the run (ring, params, event heap, every
host RNG stream, round log, history) as an ``EngineState``; passed back as
``init_state`` it resumes the run bit-identically. ``engine_state_to_tree``
gives the arrays ``checkpoint/ckpt.py`` writes, in the JAX engine's layout.

On a (data, model) mesh (``launch/multihost.py``; every rank runs this
function with the same arguments) each round runs through the sharded round
body: K/d clients a data row, the server pass on each rank's model slice,
the ring holding each rank's slice of every row (``shard_ring``). Every rank
walks the same seeded event heap, so the window metadata needs no
communication; each rank uploads the chunk inputs from its own copy; the
round log is replicated and read locally, and ``final_state`` gathers the
ring (``fetch_replicated``). With no mesh, or a 1 x 1 mesh, the program is
the single-device one, bit for bit.
"""
from __future__ import annotations

import heapq
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core.round_body import make_ring_round
from repro_torch.core.version_store import (
    build_ring,
    ring_shards,
    ring_state_to_host,
)
from repro_torch.sharding.collectives import fetch_replicated
from repro_torch.obs.metrics import MetricsRegistry, default_registry
from repro_torch.obs.trace import (
    NULL_TRACER,
    SPAN_APPLY,
    SPAN_CHECKPOINT,
    SPAN_COLLECT,
    SPAN_HOST_SYNC,
    Tracer,
)
from repro_torch.sim.base import (
    SimResult,
    history_from_arrays,
    history_to_arrays,
    record_eval,
    resolve_behavior,
    round_log_from_arrays,
    round_log_rows,
    round_log_to_arrays,
)
from repro_torch.sim.scenarios import ClientBehavior, LatencyModel, Scenario
from repro_torch.sim.traces import EventTrace
from repro_torch.utils.device import DeviceLike, resolve_device
from repro_torch.utils.tree import tree_map

_LOG_FIELDS = ("weights", "staleness", "stat_effect", "sq_dists")


def init_version_ring(init_params: Any, fl: FLConfig, *,
                      mesh: Optional[Any] = None, shard_ring: bool = True,
                      rows: Optional[Any] = None):
    """Build the device-resident version store (``core/version_store.py``)
    on the device of ``init_params``. Returns ``(spec, ring)``.

    Each of the R = max_staleness + 1 retained versions is one padded flat
    parameter vector, stored by the ``fl.ring_codec`` codec: the (R,
    n_padded) f32 matrix for ``f32``, a compressed NamedTuple for ``int8``
    and ``delta``. ``rows`` restores from a checkpointed host form
    (``version_store.ring_state_to_host``, written by either package); a
    codec or layout mismatch raises naming the codec and its layout.

    With a mesh whose ``model`` axis has size m > 1, ``shard_ring=True``
    keeps this rank's slice of every row (``R * n_padded / m`` values for
    f32); ``shard_ring=False`` keeps whole rows on every rank (the same
    round, the bit-parity reference).
    """
    return build_ring(init_params, fl, mesh=mesh, shard_ring=shard_ring,
                      rows=rows)


class EngineState(NamedTuple):
    """Host-side snapshot of a ``run_vectorized`` run at a round boundary.

    Everything a resumed run needs to be bit-identical to the
    uninterrupted one: the version ring and params, the host event heap,
    the per-client behavior RNG streams (``ClientBehavior.get_state``), the
    datasets' batch streams, and the round log and eval history so far.
    Serialise with ``engine_state_to_tree`` (arrays only, ``save_checkpoint``
    -able) and restore with ``engine_state_from_tree``.
    """

    version: int
    now: float
    num_events: int
    base_version: np.ndarray  # (n,) int64
    events: Tuple[Tuple[float, int], ...]  # pending (t, cid) uploads
    params: Any  # nested dict of numpy arrays
    ring: Any  # codec host state: (R, n_padded) f32 matrix for the f32
    # codec, a codec-stamped dict of arrays for int8/delta
    behavior: Dict[str, np.ndarray]
    dataset_rng: np.ndarray  # (n, 6) uint64 ClientDataset batch streams
    history: List[Dict]
    round_log: List[Dict]


def engine_state_to_tree(state: EngineState) -> Dict[str, Any]:
    """EngineState -> nested dict of plain arrays (``save_checkpoint``-able)."""
    ev = np.asarray(sorted(state.events), np.float64).reshape(-1, 2)
    return {
        "meta": {"version": np.int64(state.version),
                 "now": np.float64(state.now),
                 "num_events": np.int64(state.num_events)},
        "base_version": np.asarray(state.base_version, np.int64),
        "events": ev,
        "params": state.params,
        "ring": (dict(state.ring) if isinstance(state.ring, dict)
                 else np.asarray(state.ring, np.float32)),
        "behavior": dict(state.behavior),
        "dataset_rng": np.asarray(state.dataset_rng, np.uint64),
        "round_log": round_log_to_arrays(state.round_log),
        "history": history_to_arrays(state.history),
    }


def engine_state_from_tree(tree: Dict[str, Any]) -> EngineState:
    """Inverse of ``engine_state_to_tree``."""
    ev = np.asarray(tree["events"], np.float64).reshape(-1, 2)
    return EngineState(
        version=int(tree["meta"]["version"]),
        now=float(tree["meta"]["now"]),
        num_events=int(tree["meta"]["num_events"]),
        base_version=np.asarray(tree["base_version"], np.int64),
        events=tuple((float(t), int(c)) for t, c in ev),
        params=tree["params"],
        ring=(dict(tree["ring"]) if isinstance(tree["ring"], dict)
              else np.asarray(tree["ring"], np.float32)),
        behavior=dict(tree["behavior"]),
        dataset_rng=np.asarray(tree["dataset_rng"], np.uint64),
        history=history_from_arrays(tree["history"]),
        round_log=round_log_from_arrays(tree["round_log"]),
    )


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _make_chunk_step(loss_fn: Callable, fl: FLConfig, device: torch.device,
                     spec, mesh: Optional[Any] = None,
                     shard_ring: bool = True) -> Callable:
    """S whole server rounds (K local trainings + eq. 3/4/5 each) back to
    back on the shared round body; the ring advances on the device between
    rounds. Returns ``chunk_step(params, ring, base_slots, batches, probes,
    sizes, taus, new_slots) -> (params, ring, infos (S, fields, K))``."""
    ring_round = make_ring_round(loss_fn, fl, device, spec, mesh=mesh,
                                 shard_ring=shard_ring)

    def chunk_step(params, ring, base_slots, batches, probes, sizes, taus,
                   new_slots):
        infos = []
        for j, new_slot in enumerate(new_slots):
            params, ring, info = ring_round(
                params, ring, base_slots[j],
                tuple(b[j] for b in batches), tuple(p[j] for p in probes),
                sizes[j], taus[j], new_slot)
            infos.append(torch.stack([info[f] for f in _LOG_FIELDS]))
        return params, ring, torch.stack(infos)

    return chunk_step


def run_vectorized(loss_fn: Callable, init_params: Any, clients: Sequence,
                   fl: FLConfig, total_rounds: int,
                   eval_fn: Optional[Callable[[Any], Dict]] = None,
                   eval_every: int = 5,
                   latency: Optional[LatencyModel] = None,
                   seed: int = 0,
                   behavior: Optional[ClientBehavior] = None,
                   scenario: Optional[Scenario] = None,
                   trace: Optional[EventTrace] = None,
                   record_trace: bool = False,
                   rounds_per_launch: int = 8,
                   mesh: Optional[Any] = None,
                   shard_ring: bool = True,
                   init_state: Optional[EngineState] = None,
                   capture_state: bool = False,
                   registry: Optional[MetricsRegistry] = None,
                   tracer: Optional[Tracer] = None,
                   device: DeviceLike = "cuda") -> SimResult:
    """Simulate buffered-async FL on ``device`` (CUDA unless asked otherwise).

    Same contract as the JAX ``run_vectorized`` on one device; behavior
    precedence: ``trace`` (replay) > ``behavior`` > ``scenario`` >
    ``latency``; ``record_trace=True`` attaches the run's ``EventTrace``.
    ``init_params`` (a nested dict of tensors or arrays) is copied onto
    ``device``. ``SimResult.num_launches`` counts the launch chunks
    dispatched; ``SimResult.final_params`` holds the last round's params.

    Observability, as the JAX engine's: every chunk dispatch goes through
    one wrapper that counts ``engine_dispatches_total`` and observes its
    host-side time in ``engine_launch_seconds`` (no synchronise: the
    engine runs ahead of the device); each device-to-host fetch counts
    ``engine_host_syncs_total``. ``registry`` defaults to
    ``obs.default_registry()``; ``tracer`` (default off) records the spans
    ``collect_window``, ``apply``, ``host_sync`` and ``checkpoint``.

    ``capture_state=True`` attaches an ``EngineState`` snapshot to
    ``SimResult.final_state``; passing it back as ``init_state`` (same
    loss/clients/config/seed) resumes the run bit-identically to the
    uninterrupted one. ``total_rounds`` always counts from round 0, so a
    resume runs ``total_rounds - init_state.version`` more rounds.

    ``mesh`` (a ``DeviceMesh`` of ``launch/multihost.make_round_mesh`` on
    ``device``'s type) runs every round through the sharded substrate, and
    every rank calls this with the same arguments; ``shard_ring=False``
    keeps whole ring rows on every rank. The dispatch count does not change
    with the world. ``final_params`` are whole on every rank.
    """
    dev = resolve_device(device)
    if mesh is not None and mesh.device_type != dev.type:
        raise ValueError(f"mesh of {mesh.device_type!r} ranks, device "
                         f"{str(dev)!r}")
    n = len(clients)
    k = fl.buffer_size
    beh = resolve_behavior(n, seed, behavior, scenario, latency, trace)
    ring_depth = fl.max_staleness + 1
    reg = registry if registry is not None else default_registry()
    tr = tracer if tracer is not None else NULL_TRACER
    dispatches = reg.counter("engine_dispatches_total")
    launch_hist = reg.histogram("engine_launch_seconds")
    syncs = reg.counter("engine_host_syncs_total")
    dispatches_start = dispatches.value

    def chunk_step(*args):
        """Every dispatch of the round program goes through here."""
        t0 = time.perf_counter()
        dispatches.inc()
        out = raw_chunk_step(*args)
        launch_hist.observe(time.perf_counter() - t0)
        return out

    def to_device(tree):
        return tree_map(lambda v: torch.as_tensor(v).to(dev, copy=True), tree)

    if init_state is None:
        params = to_device(init_params)
        spec, ring = init_version_ring(params, fl, mesh=mesh,
                                       shard_ring=shard_ring)
        version = 0
        base_version = np.zeros(n, np.int64)
        now = 0.0
        history: List[Dict] = []
        round_log_prefix: List[Dict] = []
        num_events = 0
        # every client starts training at t=0 (availability-gated) from v0
        events = []
        for cid in range(n):
            start = beh.next_start(cid, 0.0)
            events.append((start + beh.duration(cid, start), cid))
        heapq.heapify(events)
    else:
        if record_trace:
            raise ValueError(
                "record_trace cannot resume from a checkpoint: the duration "
                "draws before the snapshot are not in the restored state")
        if len(init_state.base_version) != n:
            raise ValueError(
                f"checkpoint has {len(init_state.base_version)} clients, "
                f"this run has {n}")
        beh.set_state(init_state.behavior)
        for c, row in zip(clients, init_state.dataset_rng):
            c.set_rng_state(row)
        params = to_device(init_state.params)
        spec, ring = init_version_ring(params, fl, mesh=mesh,
                                       shard_ring=shard_ring,
                                       rows=init_state.ring)
        version = init_state.version
        base_version = np.asarray(init_state.base_version, np.int64).copy()
        now = init_state.now
        history = [dict(h) for h in init_state.history]
        if eval_fn and history and history[-1]["round"] == version \
                and version % eval_every:
            # the snapshot run's trailing FORCED eval: off the cadence, the
            # uninterrupted run never evaluates here, so drop it
            history.pop()
        round_log_prefix = [dict(r) for r in init_state.round_log]
        num_events = init_state.num_events
        events = [(float(t), int(c)) for t, c in init_state.events]
        heapq.heapify(events)
    raw_chunk_step = _make_chunk_step(loss_fn, fl, dev, spec, mesh,
                                      shard_ring)
    pending: List[Dict] = []  # per-chunk host metadata + device info handles
    event_log: List = []

    def maybe_eval(force=False):
        record_eval(history, eval_fn, version, now, params, eval_every,
                    force)

    def reschedule(cid, t):
        start = beh.next_start(cid, t)
        heapq.heappush(events, (start + beh.duration(cid, start), cid))

    def collect_window():
        """Pop exactly K accepted uploads; the host event loop runs ahead
        of the device, which is legal because upload times never depend
        on server state. Returns the stacked per-window arrays."""
        nonlocal num_events, now
        window: List = []  # (t, cid, base_version, tau)
        while len(window) < k:
            t, cid = heapq.heappop(events)
            num_events += 1
            # one atomic consume: the attempt's index AND its drop verdict
            upload_idx, lost = beh.next_upload(cid)
            if lost:
                # upload lost: client re-pulls the current model, retrains
                base_version[cid] = version
                reschedule(cid, t)
                continue
            bv = int(base_version[cid])
            if bv < version - fl.max_staleness:  # fell out of the ring
                bv = version  # resync: train from the current model, tau 0
                base_version[cid] = version
            window.append((t, cid, bv, version - bv))
            event_log.append((t, cid, upload_idx, version))
            if len(window) < k:
                # no aggregation yet: re-pull the CURRENT version and go
                base_version[cid] = version
                reschedule(cid, t)
        now = window[-1][0]  # the K-th upload triggers the aggregation
        # probes draw AFTER all train draws (the aggregation-time order)
        train = [clients[cid].batches(fl.batch_size, fl.local_steps)
                 for _, cid, _, _ in window]
        probes = [clients[cid].batch(fl.batch_size)
                  for _, cid, _, _ in window]  # eq.-4 probes, FIFO order
        return {
            "clients": [cid for _, cid, _, _ in window],
            "tau": [tau for _, _, _, tau in window],
            "t_trigger": window[-1][0],
            "cid_trigger": window[-1][1],
            "batches": tuple(np.stack([b[i] for b in train])
                             for i in range(2)),
            "probes": tuple(np.stack([p[i] for p in probes])
                            for i in range(2)),
            "base_slots": np.asarray([bv % ring_depth
                                      for _, _, bv, _ in window], np.int64),
            "sizes": np.asarray([clients[cid].size
                                 for _, cid, _, _ in window], np.float32),
        }

    if init_state is None:
        # a resumed run's earlier evals are in the restored history
        maybe_eval(force=True)
    while version < total_rounds:
        # ---- clip the launch chunk to the next eval boundary ------------
        horizon = total_rounds - version
        if eval_fn:
            horizon = min(horizon, eval_every - version % eval_every)
        s = min(rounds_per_launch, horizon)

        # ---- host: pre-compute S windows of events ----------------------
        windows = []
        with tr.span(SPAN_COLLECT, rounds=s, version=version):
            for _ in range(s):
                w = collect_window()
                version += 1
                # window clients re-pull: the K-th gets the NEW version
                base_version[w["cid_trigger"]] = version
                reschedule(w["cid_trigger"], w["t_trigger"])
                windows.append(w)

        # ---- device: the S rounds, inputs moved in one transfer each ----
        put = lambda a: _to_device(a, dev)  # noqa: E731
        with tr.span(SPAN_APPLY, rounds=s, version=version):
            params, ring, infos = chunk_step(
                params, ring,
                put(np.stack([w["base_slots"] for w in windows])),
                tuple(put(np.stack([w["batches"][i] for w in windows]))
                      for i in range(2)),
                tuple(put(np.stack([w["probes"][i] for w in windows]))
                      for i in range(2)),
                put(np.stack([w["sizes"] for w in windows])),
                put(np.asarray([w["tau"] for w in windows], np.float32)),
                [(version - s + j + 1) % ring_depth for j in range(s)])
        # keep only the round-log metadata; the batch arrays would
        # otherwise pin O(total_rounds * K * batch) host memory
        pending.append({"windows": [{"clients": w["clients"], "tau": w["tau"]}
                                    for w in windows],
                        "v_end": version, "infos": infos})
        maybe_eval()
    maybe_eval(force=True)

    # ---- single device->host fetch for the whole run's round log --------
    # (the info is replicated on every rank of a mesh: a local read)
    round_log: List[Dict] = list(round_log_prefix)
    with tr.span(SPAN_HOST_SYNC, what="round_log", launches=len(pending)):
        syncs.inc()
        fetched = (torch.cat([p["infos"] for p in pending]).cpu().numpy()
                   if pending else None)
    if pending:
        row = 0
        for meta in pending:
            windows = meta["windows"]
            chunk = fetched[row:row + len(windows)]
            row += len(windows)
            logs = {f: chunk[:, i] for i, f in enumerate(_LOG_FIELDS)}
            round_log.extend(round_log_rows(
                meta["v_end"] - len(windows), k,
                [w["clients"] for w in windows],
                [w["tau"] for w in windows], logs))
    trace_out = (EventTrace.from_behavior(beh, event_log)
                 if record_trace else None)
    final_state = None
    if capture_state:
        with tr.span(SPAN_CHECKPOINT, version=version):
            syncs.inc()
            final_state = EngineState(
                version=version, now=now, num_events=num_events,
                base_version=base_version.copy(),
                events=tuple(sorted(events)),
                params=fetch_replicated(params),
                ring=ring_state_to_host(fl, fetch_replicated(ring_shards(
                    fl, spec, ring, mesh, shard_ring))),
                behavior=beh.get_state(),
                dataset_rng=np.stack([c.rng_state() for c in clients]),
                history=[dict(h) for h in history],
                round_log=[dict(r) for r in round_log])
    return SimResult(history=history, server_rounds=version, sim_time=now,
                     round_log=round_log, num_events=num_events,
                     num_launches=int(dispatches.value - dispatches_start),
                     trace=trace_out, final_params=params,
                     final_state=final_state)
