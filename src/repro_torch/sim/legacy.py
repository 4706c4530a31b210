"""Synchronous FedAvg baseline (the FedAvg rows of Fig. 1).

``run_sync`` supports partial participation via ``FLConfig.
clients_per_round`` (0 = all N): each round samples a uniform subset,
waits for its slowest member, and averages only those updates. Client
durations come from ``ClientBehavior``'s per-client seeded streams, the
same draws the async engine consumes, so sync-vs-async wall-clock
comparisons are fair. The selected clients train in ONE vmapped call.

The JAX package's per-event ``run_async_legacy`` is not ported yet.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.func import vmap

from repro_torch.configs.base import FLConfig
from repro_torch.core.client import make_local_update_fn
from repro_torch.core.server import SyncServer
from repro_torch.sim.base import SimResult, make_batches, resolve_behavior
from repro_torch.sim.scenarios import ClientBehavior, LatencyModel, Scenario
from repro_torch.sim.traces import EventTrace
from repro_torch.utils.device import DeviceLike, resolve_device
from repro_torch.utils.tree import tree_map


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
