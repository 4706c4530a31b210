"""The paper's round body, engine entry shape.

    bases   (K, ...) tree         stale base snapshots the clients pulled
    batch   (K, M, b, ...)        M local-step batches per client
    probe   (K, bp, ...)          eq. 4 fresh-loss probe batches
    ------------------------------------------------------------------
    deltas = vmap(local_update)(bases, batch)           K clients, one call
    losses = vmap(loss(params, probe_k))                eq. 4
    x', info = apply_server_round(flat(params), ...)    eq. 3 + 5

Every client trains from the base it pulled, so the upload delta is the
local-update delta. ``make_ring_round`` wraps the body in the version-store
gather/write of ``sim/engine.py`` (``core/version_store.py``: f32, int8 or
delta rows). The cohort and streaming entry shapes are not ported yet.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import vmap

from repro_torch.configs.base import FLConfig
from repro_torch.core.client import make_local_update_fn
from repro_torch.core.server_pass import (
    FlatSpec,
    apply_server_round,
    flatten_stacked,
    flatten_tree,
    resolve_mode,
    unflatten_like,
    unflatten_stacked,
)
from repro_torch.core.version_store import resolve_codec
from repro_torch.utils.device import DeviceLike


def make_round_body(loss_fn: Callable, fl: FLConfig, device: DeviceLike,
                    spec: FlatSpec) -> Callable:
    """Build the round body for tensors on ``device`` with params laid out
    as ``spec`` (``make_flat_spec``; the layout never changes in a run).

    Returns ``body(params, x, bases_flat, batch, probe, data_sizes, taus,
    sq_dists=None) -> (new_params, new_x, info)``: ``x`` is the (n_padded,)
    flat vector of ``params``, bases come in as the (K, n_padded) flat rows
    the version ring stores, and the flat new-params vector ``new_x`` goes
    back out, so the ring never leaves flat space. ``sq_dists`` carries
    eq. 3 distances a compressed ring codec computed (see
    ``apply_server_round``).
    """
    local_update = make_local_update_fn(loss_fn, fl.local_steps, fl.local_lr,
                                        fl.local_momentum)
    mode = resolve_mode(fl.server_pass_mode, device)
    clients_update = vmap(lambda base, batch: local_update(base, batch)[0])
    low_precision = any(dt != torch.float32 for dt in spec.dtypes)

    def body(params, x, bases_flat, batch, probe, data_sizes, taus,
             sq_dists=None):
        deltas = clients_update(unflatten_stacked(spec, bases_flat), batch)
        losses = vmap(lambda pb: loss_fn(params, pb)[0])(probe)
        new_x, info = apply_server_round(
            x, bases_flat, flatten_stacked(spec, deltas),
            losses.to(torch.float32), data_sizes, taus, fl, mode=mode,
            sq_dists=sq_dists)
        new_params = unflatten_like(spec, new_x)
        # the ring row must hold the values clients receive: for f32
        # params new_x already does; lower precision re-flattens the cast
        # tree so a fresh (tau=0) client's eq. 3 distance stays exactly 0
        if low_precision:
            new_x = flatten_tree(spec, new_params)
        return new_params, new_x, info

    return body


def make_ring_round(loss_fn: Callable, fl: FLConfig, device: DeviceLike,
                    spec: FlatSpec) -> Callable:
    """The engine flavour: version-store gather -> round body -> store write.

    Returns ``ring_round(params, ring, slots, batch, probe, sizes, taus,
    new_slot) -> (new_params, ring, info)``. ``ring`` is the state of the
    ``FLConfig.ring_codec`` codec (``core/version_store.py``) on ``spec``'s
    layout: the raw (R, n_padded) f32 matrix for ``f32``, a codec
    NamedTuple otherwise. The new row is written IN PLACE, which saves a
    copy of the R rows each round; the gather copies, so the write never
    aliases a base in use. Compressed codecs also hand the server pass
    their own eq. 3 distances (K4 for int8 under a kernel mode, the sparse
    expansion for delta), so the K decoded rows feed only the K-client
    local update; f32's ``distance_sq`` is None and eq. 3 stays in the
    server pass.
    """
    body = make_round_body(loss_fn, fl, device, spec)
    codec = resolve_codec(fl)
    use_kernel = resolve_mode(fl.server_pass_mode, device) in ("batched",
                                                                "fused")

    def ring_round(params, ring, slots, batch, probe, sizes, taus, new_slot):
        x = flatten_tree(spec, params)
        bases = codec.decode(spec, ring, slots)  # (K, n_padded) flat rows
        dists = codec.distance_sq(spec, ring, slots, x, use_kernel=use_kernel)
        new_params, new_x, info = body(params, x, bases, batch, probe, sizes,
                                       taus, sq_dists=dists)
        ring = codec.encode(spec, ring, new_slot, new_x)
        return new_params, ring, info

    return ring_round
