"""The paper's round body: one implementation for engine, cohort and
streaming server.

    bases   (K, ...) tree         stale base snapshots the clients pulled
    batch   (K, M, b, ...)        M local-step batches per client
    probe   (K, bp, ...)          eq. 4 fresh-loss probe batches
    ------------------------------------------------------------------
    deltas = vmap(local_update)(start, batch)           K clients, one call
    losses = vmap(loss(params, probe_k))                eq. 4
    x', info = apply_server_round(flat(params), ...)    eq. 3 + 5

Three entry shapes, as in the JAX package's ``core/round_body.py``:

* ``client_params=None`` (the engine): every client trains from the base
  it pulled, so the upload delta is the local-update delta.
  ``make_ring_round`` wraps the body in the version-store gather/write of
  ``sim/engine.py`` (``core/version_store.py``: f32, int8 or delta rows).
* ``client_params`` given (the cohort, ``core/cohort.py``): slots carry
  local progress across rounds (stragglers), so training starts from
  ``client_params`` and the upload delta is measured from the pulled base,
  ``Delta_i = base_i - end_i``; ``end_params`` comes back for the
  cohort's resync, and ``arrival_mask`` zeroes the stragglers.
* ``make_streaming_round_body`` (the serving loop and the distributed
  client): the K-buffer fills across sequential calls and only O(1) state
  is carried: a params-shaped running accumulator, the scalar weight
  buffer and the update-norm ring for eq. 3 distances. The per-upload
  weight runs the same ``core/weighting.py`` policy code as the exact
  paths (``s_min`` cap included), with the eq. 3 reference pinned to the
  current model. It reaches no kernel: its sums are over one client.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

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
from repro_torch.core.weighting import (
    contribution_weights,
    staleness_degree,
    statistical_effect,
)
from repro_torch.utils.device import DeviceLike
from repro_torch.utils.tree import tree_leaves, tree_map, tree_sub


def make_round_body(loss_fn: Callable, fl: FLConfig, device: DeviceLike,
                    spec: FlatSpec) -> Callable:
    """Build the round body for tensors on ``device`` with params laid out
    as ``spec`` (``make_flat_spec``; the layout never changes in a run).

    Returns ``body(params, x, bases_flat, batch, probe, data_sizes, taus,
    sq_dists=None, *, client_params=None, arrival_mask=None) ->
    (new_params, new_x or end_params, info)``: ``x`` is the (n_padded,)
    flat vector of ``params`` and bases come in as the (K, n_padded) flat
    rows the version ring stores. On the engine path (``client_params``
    None) the flat new-params vector ``new_x`` goes back out, so the ring
    never leaves flat space; ``sq_dists`` carries eq. 3 distances a
    compressed ring codec computed (see ``apply_server_round``). With
    ``client_params`` (the cohort; (K, ...) leaves) the K slots train from
    their current local state, upload ``base - end`` and hand back their
    ``end_params``; ``arrival_mask`` (K,) {0, 1} goes to the server pass.
    """
    local_update = make_local_update_fn(loss_fn, fl.local_steps, fl.local_lr,
                                        fl.local_momentum)
    mode = resolve_mode(fl.server_pass_mode, device)
    clients_update = vmap(lambda base, batch: local_update(base, batch)[0])
    low_precision = any(dt != torch.float32 for dt in spec.dtypes)

    def body(params, x, bases_flat, batch, probe, data_sizes, taus,
             sq_dists=None, *, client_params=None, arrival_mask=None):
        if client_params is None:
            deltas = clients_update(unflatten_stacked(spec, bases_flat), batch)
        else:
            # in-flight slots advance M steps from their CURRENT local state;
            # the upload is the cumulative delta from the pulled base
            end_params = tree_map(lambda c, d: (c - d).to(c.dtype),
                                  client_params,
                                  clients_update(client_params, batch))
            deltas = tree_sub(unflatten_stacked(spec, bases_flat), end_params)
        losses = vmap(lambda pb: loss_fn(params, pb)[0])(probe)
        new_x, info = apply_server_round(
            x, bases_flat, flatten_stacked(spec, deltas),
            losses.to(torch.float32), data_sizes, taus, fl,
            arrival_mask=arrival_mask, mode=mode, sq_dists=sq_dists)
        new_params = unflatten_like(spec, new_x)
        if client_params is not None:
            return new_params, end_params, info
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


# ---------------------------------------------------------------------------
# streaming entry shape (serving loop and distributed client)
# ---------------------------------------------------------------------------


class StreamingRoundBody(NamedTuple):
    """The O(1)-memory running-accumulator form of the round.
    ``contribute`` folds one buffered upload into the running state;
    ``apply`` completes eq. 5 once the buffer is full. The callers
    (``core/cohort.py::make_dist_step``, ``core/serving.py``) own only the
    state machine: all weighting arithmetic lives here and in
    ``core/weighting.py``.
    """

    contribute: Callable
    apply: Callable


def make_streaming_round_body(loss_fn: Callable,
                              fl: FLConfig) -> StreamingRoundBody:
    """Build the streaming form of the round (the JAX package's
    ``make_streaming_round_body``).

    One client at a time: the K-buffer fills across sequential calls and
    only O(1) state is carried: a params-shaped accumulator ``sum_i v_i *
    Delta_i`` in ``fl.accum_dtype``, the scalar weight buffer ``v_i``, and
    the (max_staleness,) update-norm ring that estimates eq. 3 squared
    distances (cross terms dropped; ring[0] is the newest update).

    The per-upload weight ``v_i`` is ``contribution_weights(...,
    normalize="none")`` on the (1,)-slot vectors, ``s_min`` cap included,
    with the eq. 3 reference pinned to 0.0 (the current model,
    ``staleness_degree(..., ref_sq_dist=0.0)``) because the buffer-wide
    ``min_j`` is unknown until the buffer is full. Whenever the buffer
    holds a fresh (tau=0) update that reference equals the true min and the
    weights match the exact path; with every update stale the cap engages
    earlier (DESIGN.md §6). ``apply`` finishes with
    ``contribution_weights``'s normalization: ``mean`` divides by
    ``sum v_i``, ``none`` by ``k_eff`` alone.

    ``contribute(params, accum, update_norm_ring, batch, probe, data_size,
    tau) -> (new_accum, v, fresh)`` and ``apply(params, accum, v_buf,
    count, update_norm_ring) -> (new_params, new_ring)``. Every result is a
    new tensor: neither function writes into its arguments. ``data_size``
    is an f32 scalar tensor; ``tau`` and ``count`` are ints or integer
    scalar tensors. Nothing reads a device value back to the host.
    """
    if fl.normalize not in ("mean", "none"):  # match contribution_weights
        raise ValueError(f"unknown normalize {fl.normalize!r}")
    local_update = make_local_update_fn(loss_fn, fl.local_steps, fl.local_lr,
                                        fl.local_momentum)

    def contribute(params, accum, update_norm_ring, batch, probe, data_size,
                   tau):
        dev = update_norm_ring.device
        delta, _ = local_update(params, batch)

        # eq. 4 probe of the CURRENT model
        fresh = loss_fn(params, probe)[0].to(torch.float32)
        p = statistical_effect(fresh[None], data_size.reshape(1))

        # eq. 3 distance via the scalar update-norm ring (cross terms
        # dropped): ||x^t - x^{t-tau}||^2 ~= sum of the last tau ||u||^2
        tau = torch.clamp(torch.as_tensor(tau, device=dev),
                          max=fl.max_staleness - 1)
        recent = torch.arange(fl.max_staleness, device=dev) < tau
        d = torch.sum(update_norm_ring * recent)

        # the exact policy code on this one slot (cap, poly, ...) with the
        # reference pinned to the current model; normalization is deferred
        # to apply, where the full v-buffer exists
        s = staleness_degree(d[None], ref_sq_dist=0.0)
        v = contribution_weights(fl.weighting, p, s,
                                 tau.reshape(1).to(torch.float32),
                                 s_min=fl.s_min, poly_a=fl.poly_a,
                                 hinge_a=fl.hinge_a, hinge_b=fl.hinge_b,
                                 normalize="none")[0]
        new_accum = tree_map(
            lambda a, dl: a + (v * dl.to(torch.float32)).to(a.dtype),
            accum, delta)
        return new_accum, v, fresh

    def apply(params, accum, v_buf, count, update_norm_ring):
        # eq. 5 on the running accumulator: x - eta_g/k_eff * sum w_i D_i
        # with w_i = v_i * k_eff / sum v_j ("mean") or w_i = v_i ("none")
        if fl.normalize == "mean":
            scale = fl.global_lr / torch.clamp(torch.sum(v_buf), min=1e-12)
        else:
            k_eff = torch.clamp(torch.as_tensor(
                count, device=v_buf.device).to(torch.float32), min=1.0)
            scale = fl.global_lr / k_eff
        upd = tree_map(lambda a: scale * a.to(torch.float32), accum)
        new_params = tree_map(lambda x, u: x - u.to(x.dtype), params, upd)
        unorm = torch.sum(torch.stack([torch.sum(torch.square(u))
                                       for u in tree_leaves(upd)]))
        new_ring = torch.cat([unorm[None], update_norm_ring[:-1]])
        return new_params, new_ring

    return StreamingRoundBody(contribute=contribute, apply=apply)
