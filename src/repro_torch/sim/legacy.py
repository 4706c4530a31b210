"""Legacy per-event simulator + synchronous FedAvg baseline.

``run_async_legacy`` is the JAX package's event-driven heapq loop: one
local update and one ``AsyncServer.receive`` per client upload. It is kept
as the semantic reference for the vectorized engine
(``tests/test_torch_legacy.py`` checks their round logs event for event),
as the JAX package keeps it. New code should use
``repro_torch.sim.engine.run_vectorized`` (the default behind
``repro_torch.core.run_async``).

Both runners draw client durations from ``ClientBehavior``'s per-client
seeded streams: draw ``k`` of client ``i`` is the same whichever protocol
consumes it, so sync-vs-async wall-clock comparisons are fair.

``run_sync`` supports partial participation via ``FLConfig.
clients_per_round`` (0 = all N): each round samples a uniform subset,
waits for its slowest member, and averages only those updates. The
selected clients train in ONE vmapped call.

Both run on CUDA unless ``device="cpu"`` and raise without a card.
"""
from __future__ import annotations

import functools
import heapq
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.func import vmap

from repro_torch.configs.base import FLConfig
from repro_torch.core.client import make_fresh_loss_fn, make_local_update_fn
from repro_torch.core.server import AsyncServer, SyncServer
from repro_torch.sim.base import (
    SimResult,
    make_batches,
    record_eval,
    resolve_behavior,
)
from repro_torch.sim.scenarios import ClientBehavior, LatencyModel, Scenario
from repro_torch.sim.traces import EventTrace
from repro_torch.utils.device import DeviceLike, resolve_device
from repro_torch.utils.tree import tree_map


@functools.lru_cache(maxsize=64)
def _local_update(loss_fn: Callable, local_steps: int, local_lr: float,
                  momentum: float) -> Callable:
    """One local-update function per (loss_fn, hyperparameters), reused
    across runs (the counterpart of the JAX package's jitted cache)."""
    return make_local_update_fn(loss_fn, local_steps, local_lr, momentum)


def run_async_legacy(loss_fn: Callable, init_params: Any, clients: Sequence,
                     fl: FLConfig, total_rounds: int,
                     eval_fn: Optional[Callable[[Any], Dict]] = None,
                     eval_every: int = 5,
                     latency: Optional[LatencyModel] = None,
                     seed: int = 0,
                     behavior: Optional[ClientBehavior] = None,
                     scenario: Optional[Scenario] = None,
                     trace: Optional[EventTrace] = None,
                     record_trace: bool = False,
                     device: DeviceLike = "cuda") -> SimResult:
    """Buffered-async FL, one local update per client event (the reference).

    ``SimResult.final_params`` holds the server's last params on ``device``.
    """
    dev = resolve_device(device)
    n = len(clients)
    beh = resolve_behavior(n, seed, behavior, scenario, latency, trace)
    local_update = _local_update(loss_fn, fl.local_steps, fl.local_lr,
                                 fl.local_momentum)
    server = AsyncServer(init_params, fl, make_fresh_loss_fn(loss_fn),
                         device=dev)

    # every client starts training at t=0 (availability-gated) from version 0
    base_version = {i: 0 for i in range(n)}
    events = []
    for cid in range(n):
        start = beh.next_start(cid, 0.0)
        events.append((start + beh.duration(cid, start), cid))
    heapq.heapify(events)
    history: List[Dict] = []
    event_log: List = []
    now = 0.0
    num_events = 0

    def maybe_eval(force=False):
        record_eval(history, eval_fn, server.version, now, server.params,
                    eval_every, force)

    def reschedule(cid, t):
        start = beh.next_start(cid, t)
        heapq.heappush(events, (start + beh.duration(cid, start), cid))

    maybe_eval(force=True)
    while server.version < total_rounds:
        now, cid = heapq.heappop(events)
        num_events += 1
        upload_idx, lost = beh.next_upload(cid)
        if lost:  # upload lost: re-pull current model, retrain
            base_version[cid] = server.version
            reschedule(cid, now)
            continue
        ds = clients[cid]
        batches = tree_map(lambda a: torch.from_numpy(a).to(dev),
                           make_batches(ds, fl.batch_size, fl.local_steps))
        base = server.history.get(base_version[cid])
        if base is None:  # fell out of the ring: resync (modelled as re-pull)
            base = server.params
            base_version[cid] = server.version
        event_log.append((now, cid, upload_idx, server.version))
        delta, _ = local_update(base, batches)
        fresh = (lambda d=ds: d.batch(fl.batch_size))
        advanced = server.receive(cid, delta, base_version[cid], ds.size,
                                  fresh_batch_fn=fresh)
        # client immediately pulls the newest model and restarts (async)
        base_version[cid] = server.version
        reschedule(cid, now)
        if advanced:
            maybe_eval()
    maybe_eval(force=True)
    trace_out = (EventTrace.from_behavior(beh, event_log)
                 if record_trace else None)
    return SimResult(history=history, server_rounds=server.version,
                     sim_time=now, round_log=server.round_log,
                     num_events=num_events, trace=trace_out,
                     final_params=server.params)


def run_sync(loss_fn: Callable, init_params: Any, clients: Sequence,
             fl: FLConfig, total_rounds: int,
             eval_fn: Optional[Callable[[Any], Dict]] = None,
             eval_every: int = 5,
             latency: Optional[LatencyModel] = None,
             seed: int = 0,
             behavior: Optional[ClientBehavior] = None,
             scenario: Optional[Scenario] = None,
             trace: Optional[EventTrace] = None,
             device: DeviceLike = "cuda") -> SimResult:
    """Synchronous FedAvg on ``device``: each round samples
    ``fl.clients_per_round`` clients (0 = all N) and waits for the slowest."""
    dev = resolve_device(device)
    n = len(clients)
    beh = resolve_behavior(n, seed, behavior, scenario, latency, trace)
    m = min(fl.clients_per_round, n) if fl.clients_per_round else n
    sel_rng = np.random.default_rng(np.random.SeedSequence((seed, 909)))
    local_update = make_local_update_fn(loss_fn, fl.local_steps, fl.local_lr,
                                        fl.local_momentum)
    # every selected client trains from the same global params
    clients_update = vmap(lambda base, batch: local_update(base, batch)[0],
                          in_dims=(None, 0))
    params = tree_map(lambda v: torch.as_tensor(v).to(dev, copy=True),
                      init_params)
    server = SyncServer(params, fl)
    history: List[Dict] = []
    now = 0.0
    for _ in range(total_rounds):
        sel = (np.sort(sel_rng.choice(n, size=m, replace=False))
               if m < n else np.arange(n))
        durations = [beh.duration(int(cid), now) for cid in sel]
        now += max(durations)  # wait for the slowest selected straggler
        batches = [make_batches(clients[cid], fl.batch_size, fl.local_steps)
                   for cid in sel]
        stacked = tuple(torch.from_numpy(np.stack([b[i] for b in batches]))
                        .to(dev) for i in range(2))
        deltas = clients_update(server.params, stacked)
        server.round(deltas, [clients[cid].size for cid in sel])
        if eval_fn and server.version % eval_every == 0:
            history.append({"round": server.version, "time": now,
                            **eval_fn(server.params)})
    if eval_fn:
        history.append({"round": server.version, "time": now,
                        **eval_fn(server.params)})
    return SimResult(history=history, server_rounds=server.version,
                     sim_time=now, round_log=[],
                     num_events=int(total_rounds * m),
                     final_params=server.params)
