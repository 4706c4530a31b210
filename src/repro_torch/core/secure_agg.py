"""Secure-aggregation compatibility layer (additive pairwise masking), the
JAX package's ``core/secure_agg.py``.

Buffered (K-client) asynchronous FL can be combined with secure
aggregation (paper §3), unlike fully async servers that see every update in
the clear. This module gives the Bonawitz-style additive-masking primitive
over parameter trees (nested dicts of tensors):

* every pair (i, j) of the K buffered clients derives a shared PRG seed;
  client i adds +PRG(seed_ij) for j > i and -PRG(seed_ij) for j < i to its
  (weighted) update, so the masks cancel in the server's sum;
* weights: S_i (eq. 3) is computed server-side from model versions and P_i
  (eq. 4) is one scalar upload, so the server can return w_i to each
  buffered client before upload; clients submit ``w_i * Delta_i + mask_i``
  and the server only sees the weighted sum (DESIGN.md §10).

The masks are ``jax.random`` draws reproduced bit for bit by
``utils/threefry.py`` (``fold_in``, ``split``, ``normal``), so a client
masking with the port and one masking with the JAX package cancel each
other. A key is a ``threefry.Key`` (``threefry.prng_key(seed)`` is
``jax.random.PRNGKey(seed)``); masks are drawn on the key's device and
moved to each leaf's. Dropout recovery (mask reconstruction for clients
that fail mid-round) is out of scope; the buffer re-queues their upload
next round.
"""
from __future__ import annotations

from typing import Any, List, Sequence

from repro_torch.utils import threefry
from repro_torch.utils.tree import (
    tree_add,
    tree_leaves,
    tree_map,
    tree_paths,
    tree_unflatten,
)


def _pair_seed(round_key: threefry.Key, i: int, j: int) -> threefry.Key:
    lo, hi = (i, j) if i < j else (j, i)
    return threefry.fold_in(threefry.fold_in(round_key, lo), hi)


def _mask_like(key: threefry.Key, params: Any, scale: float) -> Any:
    """One normal draw per leaf (``split`` over the leaves in
    ``jax.tree.flatten``'s order), times ``scale``, in the leaf's dtype."""
    leaves = tree_leaves(params)
    keys = threefry.split(key, len(leaves))
    masked = [(threefry.normal(keys[i], tuple(leaf.shape)) * scale)
              .to(device=leaf.device, dtype=leaf.dtype)
              for i, leaf in enumerate(leaves)]
    return tree_unflatten(tree_paths(params), masked)


def mask_update(round_key: threefry.Key, update: Any, client_id: int,
                cohort_ids: Sequence[int], scale: float = 1.0) -> Any:
    """Add the pairwise-cancelling mask for ``client_id`` to ``update``."""
    masked = update
    for other in cohort_ids:
        if other == client_id:
            continue
        m = _mask_like(_pair_seed(round_key, client_id, other), update, scale)
        sign = 1.0 if client_id < other else -1.0
        masked = tree_map(lambda u, mm: u + sign * mm, masked, m)
    return masked


def secure_sum(masked_updates: List[Any]) -> Any:
    """Server-side sum of masked updates == sum of raw updates.

    An empty cohort is a protocol error (the pairwise masks only cancel
    inside one complete K-buffer), so it raises instead of IndexError.
    """
    if not masked_updates:
        raise ValueError("secure_sum needs at least one masked update "
                         "(the buffer drained an empty cohort)")
    out = masked_updates[0]
    for u in masked_updates[1:]:
        out = tree_add(out, u)
    return out
