"""The paper's round body, engine entry shape.

    bases   (K, ...) tree         stale base snapshots the clients pulled
    batch   (K, M, b, ...)        M local-step batches per client
    probe   (K, bp, ...)          eq. 4 fresh-loss probe batches
    ------------------------------------------------------------------
    deltas = vmap(local_update)(bases, batch)           K clients, one call
    losses = vmap(loss(params, probe_k))                eq. 4
    x', info = apply_server_round(flat(params), ...)    eq. 3 + 5

Every client trains from the base it pulled, so the upload delta is the
local-update delta. ``make_ring_round`` wraps the body in the f32
version-ring gather/write of ``sim/engine.py``. The cohort and streaming
entry shapes and the compressed ring codecs are not ported yet.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import vmap

from repro_torch.configs.base import FLConfig
from repro_torch.core.client import make_local_update_fn
from repro_torch.core.server_pass import (
    apply_server_round,
    flatten_stacked,
    flatten_tree,
    make_flat_spec,
    resolve_mode,
    unflatten_like,
    unflatten_stacked,
)
from repro_torch.utils.device import DeviceLike


def make_round_body(loss_fn: Callable, fl: FLConfig,
                    device: DeviceLike) -> Callable:
    """Build the round body for tensors on ``device``.

    Returns ``body(params, bases_flat, batch, probe, data_sizes, taus) ->
    (new_params, new_x, info)``: bases come in as the (K, n_padded) flat
    rows the version ring stores, and the (n_padded,) flat new-params
    vector ``new_x`` goes back out, so the ring never leaves flat space.
    """
    local_update = make_local_update_fn(loss_fn, fl.local_steps, fl.local_lr,
                                        fl.local_momentum)
    mode = resolve_mode(fl.server_pass_mode, device)
    clients_update = vmap(lambda base, batch: local_update(base, batch)[0])

    def body(params, bases_flat, batch, probe, data_sizes, taus):
        spec = make_flat_spec(params, fl.server_pass_block_n)
        deltas = clients_update(unflatten_stacked(spec, bases_flat), batch)
        losses = vmap(lambda pb: loss_fn(params, pb)[0])(probe)
        new_x, info = apply_server_round(
            flatten_tree(spec, params), bases_flat,
            flatten_stacked(spec, deltas), losses.to(torch.float32),
            data_sizes, taus, fl, mode=mode)
        new_params = unflatten_like(spec, new_x)
        # the ring row must hold the values clients receive: for f32
        # params new_x already does; lower precision re-flattens the cast
        # tree so a fresh (tau=0) client's eq. 3 distance stays exactly 0
        if any(dt != torch.float32 for dt in spec.dtypes):
            new_x = flatten_tree(spec, new_params)
        return new_params, new_x, info

    return body


def make_ring_round(loss_fn: Callable, fl: FLConfig,
                    device: DeviceLike) -> Callable:
    """The engine flavour: ring gather -> round body -> ring write.

    Returns ``ring_round(params, ring, slots, batch, probe, sizes, taus,
    new_slot) -> (new_params, ring, info)``. ``ring`` is the (R, n_padded)
    f32 version ring; the new row is written IN PLACE (``ring[new_slot] =
    new_x``), which saves a copy of the R rows each round. The gather
    ``ring[slots]`` copies, so the write never aliases a base in use.
    """
    if fl.ring_codec != "f32":
        raise NotImplementedError(
            f"ring_codec={fl.ring_codec!r}: only the f32 version ring is "
            "ported; the int8/delta codecs come with the version-store slice "
            "(ROADMAP.md, Slice B)")
    body = make_round_body(loss_fn, fl, device)

    def ring_round(params, ring, slots, batch, probe, sizes, taus, new_slot):
        bases = ring.index_select(0, slots)  # (K, n_padded) flat rows
        new_params, new_x, info = body(params, bases, batch, probe, sizes,
                                       taus)
        ring[new_slot] = new_x
        return new_params, ring, info

    return ring_round
