"""Partition rules of the sharded round substrate (the JAX package's
``sharding/specs.py``, its round-substrate part).

Mesh axes: ``data`` carries the K-client cohort slots, ``model`` the padded
flat parameter vector and the engine's flat version ring. A spec is one
mesh-axis name (or ``None``) per tensor dimension, trailing unmentioned
dimensions replicated, as JAX's ``PartitionSpec``: ``PartitionSpec`` here is
a frozen tuple of the same entries, so each rule compares entry by entry
with the JAX package's.

The port runs one process per rank with plain local tensors: a spec says
which contiguous slice of the global tensor a rank holds
(``sharding/collectives.py::put_with_sharding``) and over which group a fetch
gathers it (``fetch_replicated``). Nothing here needs a process group.

Not ported here: the language-model tensor-parallel rules (``param_pspecs``,
``cohort_state_pspecs``, ``dist_state_pspecs``, ``batch_pspecs``,
``cache_pspecs``); they come with LM training and the dry run (Slice F,
ROADMAP.md).
"""
from __future__ import annotations

from typing import Any, Optional

MODEL_AXIS = "model"
DATA_AXIS = "data"


class PartitionSpec(tuple):
    """One mesh-axis name or ``None`` per tensor dimension (JAX's form)."""

    __slots__ = ()

    def __new__(cls, *axes: Optional[str]):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_axis_size(mesh: Any, name: str) -> int:
    """Size of mesh axis ``name``: 1 when absent or ``mesh`` is None.

    Reads ``mesh.mesh_dim_names`` and the shape of ``mesh.mesh``, which a
    ``torch.distributed.device_mesh.DeviceMesh`` has.
    """
    if mesh is None:
        return 1
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape)))
    return int(sizes.get(name, 1))


def flat_param_pspec() -> PartitionSpec:
    """(Np,) padded flat parameter vector: partitioned over ``model``."""
    return P(MODEL_AXIS)


def flat_stacked_pspec() -> PartitionSpec:
    """(K, Np) stacked flat bases/deltas: K replicated, Np over ``model``."""
    return P(None, MODEL_AXIS)


def ring_pspec() -> PartitionSpec:
    """(R, Np) flat version ring: versions replicated, Np over ``model``,
    so a rank holds ``R * n_padded / model_shards`` floats of it."""
    return flat_stacked_pspec()


def ring_codes_pspec() -> PartitionSpec:
    """(R, Np) int8 codewords of the compressed ring: the f32 ring's layout."""
    return flat_stacked_pspec()


def ring_scales_pspec() -> PartitionSpec:
    """(R, Np // qblock) per-block scale/zero: blocks over ``model``.

    ``resolve_qblock`` makes the block divide the per-shard tile, so a rank
    holds exactly the (scale, zero) columns its codewords need.
    """
    return flat_stacked_pspec()


def kclient_pspec() -> PartitionSpec:
    """(K, ...) client-stacked leaves: K over ``data``, the rest replicated."""
    return P(DATA_AXIS)


def client_state_pspec() -> PartitionSpec:
    """(N,) per-client population state: N over ``data`` (the population
    engine's mesh branch, ``sim/population.py``)."""
    return P(DATA_AXIS)


def info_pspec() -> PartitionSpec:
    """(K,) per-round info (weights, sq_dists, ...): replicated.

    A contract, not only a layout: every rank holds the whole round log, so
    reading it needs no collective.
    """
    return P()
