"""The round's collectives and host <-> rank transfers on
``torch.distributed`` (the data movement of the JAX package's
``launch/multihost.py`` and of its partitioner, written out).

One process per rank and one device per rank; tensors stay plain local
tensors, and a rank holds its own contiguous slice of a sharded tensor
(``local_slice``; ``sharding/specs.py`` says which). Every collective of
the round goes through ``all_gather_cat``, so the round's reductions have
an order the port fixes and no backend chooses: the eq. 3 partial
distances meet over ``model`` in one all-gather and are summed in rank
order on every rank (``sum_in_rank_order``), so the bits do not depend on
the backend's allreduce. All other traffic of the round is exact data
movement: the bases a data row trains from (over ``model``), deltas and
probe losses (over ``data``), the new flat vector (over ``model``).
``top_k_across`` selects across ranks in ``jax.lax.top_k``'s order with one
all-gather of each rank's candidates (the delta ring's top-m over
``model``, the population window over ``data``).

Under gloo (the backend for ranks that share one card: NCCL refuses two
ranks on one device) a CUDA tensor goes through host memory explicitly.

IO is coordinator-gated: ``is_coordinator()`` (rank 0) guards checkpoint
writes and log sinks (``checkpoint/ckpt.py``, ``obs/sink.py``). Nothing
here starts a process group: ``launch/multihost.py`` does.
"""
from __future__ import annotations

import time
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.sharding.specs import (
    PartitionSpec,
    entry_axes,
    mesh_axis_size,
)

# host time spent in collectives (device waits included: staging a CUDA
# tensor through the host synchronises its stream), read by shard_scale
COLLECTIVE_STATS: Dict[str, float] = {"calls": 0, "seconds": 0.0, "bytes": 0}


def reset_collective_stats() -> None:
    """Set the collective counters to 0."""
    COLLECTIVE_STATS.update(calls=0, seconds=0.0, bytes=0)


def is_coordinator() -> bool:
    """True on rank 0, or when no process group is up."""
    return not dist.is_initialized() or dist.get_rank() == 0


def mesh_spans_processes(mesh: Optional[Any]) -> bool:
    """True when ``mesh`` has more than one rank (each rank is a process)."""
    return mesh is not None and int(mesh.mesh.numel()) > 1


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on under ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


# ---------------------------------------------------------------------------
# collectives (every one of the round's goes through these)
# ---------------------------------------------------------------------------


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Gather ``t`` from every rank of ``group`` and join the pieces along
    ``dim`` in rank order (one collective). Under gloo a CUDA tensor goes
    to the host and the joined result comes back in one copy each way."""
    t0 = time.perf_counter()
    n = dist.get_world_size(group)
    src = t.detach().contiguous()
    stage = src.is_cuda and dist.get_backend(group) == "gloo"
    if stage:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    if stage:
        out = out.to(t.device)
    COLLECTIVE_STATS["calls"] += 1
    COLLECTIVE_STATS["bytes"] += src.numel() * src.element_size() * n
    COLLECTIVE_STATS["seconds"] += time.perf_counter() - t0
    return out


def sum_in_rank_order(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group``: one all-gather, then the pieces added left
    to right in rank order on every rank, so every rank holds the same bits
    whatever the backend."""
    n = dist.get_world_size(group)
    parts = all_gather_cat(t[None], group, dim=0)
    acc = parts[0]
    for i in range(1, n):
        acc = acc + parts[i]
    return acc


def top_k_across(values: torch.Tensor, global_idx: torch.Tensor, k: int,
                 group, payload: Sequence[torch.Tensor] = ()
                 ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """The ``k`` largest of ``values`` over ``group``, in ``jax.lax.top_k``'s
    order: descending, ties to the lower global index.

    Each rank holds a contiguous slice of one vector (or of one batch of
    vectors: the last axis is the split one), rank r's slice below rank
    r + 1's in the group's order; ``global_idx`` (the last axis' global
    positions, broadcast against ``values``) says where. A rank takes its
    ``min(k, local)`` candidates by a stable descending sort, one all-gather
    joins every rank's candidates in rank order, and a stable descending sort
    of the joined values, cut to ``k``, merges them. This is exact: each
    rank's list keeps equal values in index order and the ranks come in index
    order, so the joined list already holds ties in global order, which the
    stable sort keeps. ``payload`` tensors (the shape of ``values``, 4- or
    8-byte dtypes) ride in the same gather and come back beside each winner.

    Returns ``(values, global_idx, payload)`` with last axis ``min(k,
    total)``, the same on every rank.
    """
    take = min(k, values.shape[-1])
    order = torch.sort(values, dim=-1, descending=True,
                       stable=True).indices[..., :take]
    idx = torch.broadcast_to(global_idx, values.shape)
    fields = [t.gather(-1, order) for t in (values, idx, *payload)]
    words = [t.contiguous().view(torch.int32).reshape(
        t.shape + (t.element_size() // 4,)) for t in fields]
    joined = all_gather_cat(torch.cat(words, dim=-1), group, dim=-2)
    out, pos = [], 0
    for t, w in zip(fields, words):
        width = w.shape[-1]
        out.append(joined[..., pos:pos + width].contiguous().view(t.dtype)
                   .squeeze(-1))
        pos += width
    keep = torch.sort(out[0], dim=-1, descending=True,
                      stable=True).indices[..., :k]
    out = [t.gather(-1, keep) for t in out]
    return out[0], out[1], out[2:]


def barrier() -> None:
    """Wait for every rank (no-op without a process group)."""
    if dist.is_initialized():
        dist.barrier()


# ---------------------------------------------------------------------------
# host <-> rank transfers
# ---------------------------------------------------------------------------


class LocalShard(NamedTuple):
    """This rank's slice of a tensor laid out on ``mesh`` by ``spec``: what a
    JAX array's sharding says, carried beside a plain local tensor for the
    readers that gather it (``fetch_replicated``, ``save_checkpoint``)."""

    local: torch.Tensor
    mesh: Any
    spec: PartitionSpec


def local_slice(value: torch.Tensor, mesh, spec: PartitionSpec) -> torch.Tensor:
    """This rank's contiguous slice of ``value`` under ``spec`` (a view).

    An entry naming several axes splits its dim over their product, the
    first axis the major one (JAX's order)."""
    for dim, entry in enumerate(spec):
        size = mesh_axis_size(mesh, entry)
        if size <= 1:
            continue
        if value.shape[dim] % size:
            raise ValueError(f"dim {dim} of {tuple(value.shape)} does not "
                             f"divide over {entry!r} ({size} shards)")
        index = 0
        for axis in entry_axes(entry):
            n = mesh_axis_size(mesh, axis)
            index = index * n + (mesh.get_local_rank(axis) if n > 1 else 0)
        chunk = value.shape[dim] // size
        value = value.narrow(dim, index * chunk, chunk)
    return value


def put_with_sharding(value: Any, mesh, spec: PartitionSpec) -> torch.Tensor:
    """Copy this rank's slice of a host value onto this rank's device.

    Every rank calls this with the same value (the engine's host walk is
    seeded alike on every rank); no communication.
    """
    t = value if isinstance(value, torch.Tensor) else torch.as_tensor(
        np.ascontiguousarray(value))
    return local_slice(t, mesh, spec).to(mesh_device(mesh), copy=True
                                         ).contiguous()


def put_replicated(tree: Any, mesh) -> Any:
    """Copy every leaf of a host tree whole onto this rank's device."""
    return _walk(tree, lambda v: put_with_sharding(v, mesh, PartitionSpec()))


def gather_shards(shard: LocalShard) -> torch.Tensor:
    """The whole tensor from every rank's ``LocalShard``: one all-gather over
    each sharded axis, joined in rank order. Every rank must call it. An
    entry naming several axes is joined over its minor axis first, so the
    first axis named stays the major one (``local_slice``'s order)."""
    out = shard.local
    for dim, entry in enumerate(shard.spec):
        for axis in reversed(entry_axes(entry)):
            if mesh_axis_size(shard.mesh, axis) > 1:
                out = all_gather_cat(out, shard.mesh.get_group(axis), dim)
    return out


def fetch_replicated(tree: Any) -> Any:
    """A tree of tensors -> host numpy, leaf by leaf. A plain tensor is a
    replicated one and is read locally; a ``LocalShard`` is gathered first
    (a collective: every rank must call this with the same tree)."""

    def leaf(v):
        if isinstance(v, LocalShard):
            v = gather_shards(v)
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy()
        return np.asarray(v)

    return _walk(tree, leaf)


def _walk(tree: Any, fn: Callable) -> Any:
    if isinstance(tree, LocalShard):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _walk(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_walk(v, fn) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn) for v in tree)
    return fn(tree)
