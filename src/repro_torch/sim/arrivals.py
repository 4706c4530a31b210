"""Continuous-arrival upload streams for the serving loop (DESIGN.md §8):
a copy of the JAX package's ``sim/arrivals.py`` (host code, numpy).

``TrafficGenerator`` turns a ``sim/`` scenario — the same per-client
seeded ``ClientBehavior`` timelines the simulation engines replay — into
an in-process traffic source for ``core/serving.py``: a heap of pending
(time, client) upload completions, realized one at a time into
``Upload`` messages carrying the client's local-step batches and eq.-4
probe. Because every duration/dropout draw comes from the per-client
streams, the arrival process is deterministic under a seed and identical
across protocols — the property the scenario registry was built around.

Client lifecycle per event:

    pop (t, cid) -> realize: consume the behavior's next upload
      * scenario dropout       -> lost in transit; re-pull + retrain
      * pending retry          -> re-offer the SAME upload (same base
                                  version — it got staler while waiting)
    offer to the controller -> settle:
      * admitted / dropped-stale -> re-pull the CURRENT version, train,
                                    next upload at t + duration
      * queue full             -> hold the upload, retry at
                                  t + retry_after (admission backpressure)

The re-pull after a stale drop mirrors the engine's ring-resync
semantics: the client's base fell out of the version window, so it
restarts from the current model rather than shipping unweightable work.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import FLConfig
from repro_torch.core.serving import Admission, REJECT_QUEUE_FULL, Upload
from repro_torch.sim.scenarios import ClientBehavior


def draw_upload(ds, cid: int, fl: FLConfig, *, base_version: int,
                t: float, seq: int = -1) -> Upload:
    """One local round: the client's next seeded batch draw as an Upload.

    THE shared draw (DESIGN.md §12): this in-process twin, the real
    socket clients (``transport/client.py``), and the loopback-parity
    journal replay (``launch/serve_fl.py --replay-journal``) all
    materialize uploads through it, so a client's seq-th upload is
    bit-identical everywhere. ``seq`` counts the client's dataset draw
    pairs (dropped-in-transit events consume NO draws).
    """
    batch = ds.batches(fl.batch_size, fl.local_steps)
    probe = ds.batch(fl.batch_size)
    return Upload(client_id=cid, base_version=int(base_version),
                  data_size=float(ds.size), batch=batch, probe=probe,
                  sent_at=t, seq=seq)


class TrafficGenerator:
    """Scenario-driven arrival stream with retry/re-pull bookkeeping.

    Together with ``core.serving.serve_stream`` this is the
    deterministic in-process twin of the socket path: the same uploads
    a real client fleet would push through ``transport/`` arrive on the
    scenario's seeded sim clock instead — the CI path the loopback
    parity gate compares the transport against.
    """

    def __init__(self, clients: Sequence, behavior: ClientBehavior,
                 fl: FLConfig):
        self.clients = clients
        self.beh = behavior
        self.fl = fl
        n = len(clients)
        self.base_version = np.zeros(n, np.int64)
        self.upload_seq = np.zeros(n, np.int64)  # per-client draw index
        self.pending: Dict[int, Upload] = {}  # cid -> upload awaiting retry
        self.lost = 0  # scenario dropouts (upload never reached the server)
        self.retries = 0  # queue-full re-offers scheduled
        self._events: List[Tuple[float, int]] = []
        for cid in range(n):
            start = behavior.next_start(cid, 0.0)
            self._events.append(
                (start + behavior.duration(cid, start), cid))
        heapq.heapify(self._events)

    # -- event stream ----------------------------------------------------
    def empty(self) -> bool:
        return not self._events

    def pop(self) -> Tuple[float, int]:
        """Next (time, client) upload completion, global time order."""
        return heapq.heappop(self._events)

    def realize(self, cid: int, t: float, version: int) -> Optional[Upload]:
        """Materialize client ``cid``'s upload at time ``t``.

        Returns None when the scenario drops it in transit (the client
        immediately re-pulls and retrains). A pending queue-full retry is
        returned as-is — same payload, same base version, now staler.
        """
        retry = self.pending.pop(cid, None)
        if retry is not None:
            return retry
        _, dropped = self.beh.next_upload(cid)
        if dropped:
            self.lost += 1
            self.repull(cid, t, version)
            return None
        seq = int(self.upload_seq[cid])
        self.upload_seq[cid] += 1
        return draw_upload(self.clients[cid], cid, self.fl,
                           base_version=int(self.base_version[cid]),
                           t=t, seq=seq)

    def settle(self, cid: int, t: float, adm: Admission, version: int,
               upload: Upload) -> None:
        """Apply the admission outcome to the client's timeline."""
        if not adm.accepted and adm.reason == REJECT_QUEUE_FULL:
            # backpressure: hold the upload, re-offer after the hint
            self.pending[cid] = upload
            self.retries += 1
            heapq.heappush(self._events, (t + adm.retry_after, cid))
            return
        # admitted, or dropped as hopelessly stale: either way the client
        # re-pulls the current model and starts its next local round
        self.repull(cid, t, version)

    def repull(self, cid: int, t: float, version: int) -> None:
        self.base_version[cid] = version
        start = self.beh.next_start(cid, t)
        heapq.heappush(self._events,
                       (start + self.beh.duration(cid, start), cid))
