"""FL servers: the buffered-async ``AsyncServer`` and FedAvg's ``SyncServer``.

``AsyncServer`` implements the paper's contribution-aware buffered
aggregation with exact eq. 3 staleness (snapshot-based distances), plus the
baseline policies via ``FLConfig.weighting``, as the JAX package's
``core/server.py`` does. Each round runs through ``make_server_pass``
(``core/server_pass.py``): eq. 3 + 4 + 5 over the stacked K buffered
updates on the device, in the configured ``server_pass_mode`` (K1 in
``fused``/``auto`` mode on a card, K2 + K3 in ``batched``). The only
device-to-host transfer of a round is one ``.cpu()`` of the stacked (K,)
round-log fields.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core.aggregation import aggregate
from repro_torch.core.buffer import BufferEntry, UpdateBuffer, VersionHistory
from repro_torch.core.server_pass import make_server_pass
from repro_torch.utils.device import DeviceLike, resolve_device
from repro_torch.utils.tree import (
    tree_leaves,
    tree_map,
    tree_stack,
    tree_to_device,
)

# info fields read back each round, and their round-log keys
_LOG_FIELDS = (("weights", "weights"), ("staleness", "staleness_deg"),
               ("stat_effect", "stat_effect"), ("sq_dists", "sq_dists"))


class AsyncServer:
    """Buffered asynchronous server (FedBuff structure + CA weighting).

    Runs on CUDA unless ``device="cpu"``; ``init_params`` (a nested dict of
    tensors or arrays) is copied onto the device.
    """

    def __init__(self, init_params: Any, fl: FLConfig,
                 fresh_loss_fn: Optional[Callable[[Any, Any], torch.Tensor]],
                 device: DeviceLike = "cuda"):
        self.fl = fl
        self.device = resolve_device(device)
        self.params = tree_map(
            lambda v: torch.as_tensor(v).to(self.device, copy=True),
            init_params)
        self.version = 0
        self.buffer = UpdateBuffer(fl.buffer_size)
        # valid bases span version - max_staleness .. version: the current
        # snapshot plus max_staleness predecessors
        self.history = VersionHistory(fl.max_staleness + 1)
        self.history.put(0, self.params)
        self._pass = make_server_pass(fl, fresh_loss_fn, device=self.device)
        self._fresh_loss = fresh_loss_fn
        self.round_log: List[Dict] = []

    # ------------------------------------------------------------------
    def receive(self, client_id: int, delta: Any, base_version: int,
                data_size: int,
                fresh_batch_fn: Optional[Callable[[], Any]] = None) -> bool:
        """Buffer one upload; aggregate if K reached. Returns True if a new
        global version was produced. ``fresh_batch_fn`` is stored per entry
        and called at aggregation time (the P_i probe uses x^t, not the
        model version at upload time)."""
        e = BufferEntry(client_id=client_id, delta=delta,
                        base_version=base_version, data_size=data_size)
        e.fresh_batch_fn = fresh_batch_fn  # attach probe callback
        self.buffer.add(e)
        if self.buffer.ready():
            self._do_aggregate()
            return True
        return False

    # ------------------------------------------------------------------
    def _gather_probes(self, entries):
        """Probe batches for the eq. 4 fresh-loss term.

        Returns (probes, mask, losses): batches of one shape stack into one
        (K, ...) tree for the vmapped probe inside the pass (``losses`` is
        None); batches of differing shapes fall back to K separate loss
        calls whose device scalars are stacked (the pass then skips its own
        probe). Probe callbacks run on the host (they fetch client data);
        batches only move host to device.
        """
        if self._fresh_loss is None:
            return None, None, None
        raw = [e.fresh_batch_fn() if getattr(e, "fresh_batch_fn", None)
               else None for e in entries]
        proto = next((b for b in raw if b is not None), None)
        if proto is None:
            return None, None, None
        mask = torch.tensor([0.0 if b is None else 1.0 for b in raw],
                            dtype=torch.float32, device=self.device)
        batches = [proto if b is None else b for b in raw]

        def layout(b):  # shapes only: no host-to-device transfer
            return tree_map(lambda x: tuple(np.shape(x)), b)

        if all(layout(b) == layout(proto) for b in batches):
            probes = tree_map(lambda *xs: torch.as_tensor(np.stack(xs))
                              .to(self.device), *batches)
            return probes, mask, None
        losses = torch.stack([self._fresh_loss(self.params,
                                               tree_to_device(b, self.device))
                              for b in batches]).to(torch.float32)
        return None, mask, torch.where(mask > 0, losses, 1.0)

    def _do_aggregate(self) -> None:
        entries = self.buffer.drain()
        k = len(entries)

        bases, taus = [], []
        for e in entries:
            base = self.history.get(e.base_version)
            if base is None:  # older than the ring: treat as max-stale
                base = self.history.get(self.history.oldest())
            bases.append(base)
            taus.append(self.version - e.base_version)

        probes, probe_mask, losses = self._gather_probes(entries)
        new_params, info = self._pass(
            self.params,
            tree_stack([e.delta for e in entries]),
            tree_stack(bases),
            probes, probe_mask,
            torch.tensor([e.data_size for e in entries], dtype=torch.float32,
                         device=self.device),
            torch.tensor(taus, dtype=torch.float32, device=self.device),
            losses)
        self.params = new_params
        self.version += 1
        self.history.put(self.version, self.params)

        # the round's single device-to-host transfer
        log = torch.stack([info[f] for f, _ in _LOG_FIELDS]).cpu().numpy()
        self.round_log.append({
            "version": self.version,
            **{key: log[i].tolist() for i, (_, key) in enumerate(_LOG_FIELDS)},
            "tau": taus,
            "clients": [e.client_id for e in entries],
            "k": k,
        })


class SyncServer:
    """FedAvg: waits for all selected clients, size-weighted average."""

    def __init__(self, init_params: Any, fl: FLConfig):
        self.fl = fl
        self.params = init_params
        self.version = 0

    def round(self, deltas_stacked: Any, data_sizes: List[int]) -> None:
        """Apply one round from the selected clients' stacked (K, ...) deltas."""
        k = len(data_sizes)
        device = tree_leaves(deltas_stacked)[0].device
        w = torch.as_tensor(data_sizes, dtype=torch.float32, device=device)
        w = w * k / torch.sum(w)  # size-weighted, mean-1 normalised
        self.params, _ = aggregate(self.params, deltas_stacked, w,
                                   self.fl.global_lr, k)
        self.version += 1
