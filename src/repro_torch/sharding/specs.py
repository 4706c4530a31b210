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

An entry may name several axes, as a tuple (``("model", "data")``): the dim
is then split over the product of their sizes, the first axis named the
major one, as in JAX.

The language-model rules (``param_pspecs``, ``cohort_state_pspecs``,
``dist_state_pspecs``, ``batch_pspecs``, ``cache_pspecs``) are the JAX
package's, name and shape driven over the port's nested-dict trees:

* tensor parallelism over ``model``: attention QKV/O, MLP up/down, SSM
  in/out projections, MoE experts (expert-parallel on the E axis), and the
  embedding / LM head (vocab-sharded when divisible, else d-sharded);
* ``data`` carries FL cohort slots (replicated-client mode) or FSDP
  (distributed-client mode: the largest not-yet-sharded dim of each large
  weight is sharded over ``data``);
* ``pod`` is a second data-parallel tier.

Specs are padded on the left with None for stacking axes (layer stack L,
cohort stack C), and a dim is sharded only where the axis size divides it,
else it is replicated. The port executes none of these layouts: its LM is
not tensor-parallel (nor is the JAX package's executed training). The dry
run (``launch/dryrun.py``) reads them for the per-rank bytes, and the tests
hold them to JAX's and to ``put_with_sharding``.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

from repro_torch.utils.tree import tree_map_with_path

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


def mesh_axis_size(mesh: Any, name: Any) -> int:
    """Size of mesh axis ``name``: 1 when absent, None or ``mesh`` is None;
    a tuple of names is the product of their sizes.

    Reads ``mesh.mesh_dim_names`` and the shape of ``mesh.mesh``, which a
    ``torch.distributed.device_mesh.DeviceMesh`` has (and the shape-only
    ``launch/mesh.py::ShapeMesh``).
    """
    if mesh is None or name is None:
        return 1
    if isinstance(name, tuple):
        size = 1
        for n in name:
            size *= mesh_axis_size(mesh, n)
        return size
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape)))
    return int(sizes.get(name, 1))


def entry_axes(entry: Any) -> Tuple[str, ...]:
    """The mesh axes one spec entry names, major first (() for None)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


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


# ---------------------------------------------------------------------------
# language-model rules (the JAX package's sharding/specs.py:135-303)
# ---------------------------------------------------------------------------


def _div(dim: int, size: int) -> bool:
    return size > 0 and dim % size == 0


def _base_rule(name: str, path: Sequence[str], shape: Tuple[int, ...], mesh,
               fsdp: bool) -> List[Optional[Any]]:
    """Spec for the TRAILING dims of a leaf (left-padding added later).

    ``path`` is the leaf's key path (``utils/tree.py::tree_paths``). Returns
    a list of axis assignments for the last ``len(spec)`` dims.
    """
    msize = mesh_axis_size(mesh, MODEL_AXIS)
    dsize = mesh_axis_size(mesh, DATA_AXIS)
    in_moe = "moe" in path and "shared" not in path
    is_expert = in_moe and name in ("w_gate", "w_up", "w_down")

    if name == "embed":
        v, d = shape[-2], shape[-1]
        if _div(v, msize * (dsize if fsdp else 1)) and fsdp:
            return [(MODEL_AXIS, DATA_AXIS), None]
        if _div(v, msize):
            return [MODEL_AXIS, DATA_AXIS if (fsdp and _div(d, dsize)) else None]
        return [None, MODEL_AXIS if _div(d, msize) else None]
    if name == "lm_head":
        d, v = shape[-2], shape[-1]
        if _div(v, msize):
            return [DATA_AXIS if (fsdp and _div(d, dsize)) else None, MODEL_AXIS]
        return [MODEL_AXIS if _div(d, msize) else None, None]
    if name == "projector":
        return [None, MODEL_AXIS if _div(shape[-1], msize) else None]
    if is_expert:
        # (E, d, ff) or (E, ff, d): expert-parallel over model
        e = shape[-3]
        return [MODEL_AXIS if _div(e, msize) else None,
                DATA_AXIS if (fsdp and _div(shape[-2], dsize)) else None,
                None]
    if name == "router":
        return [None, None]
    if name in ("wq", "wk", "wv", "w_gate", "w_up", "in_proj", "dt_proj"):
        out_ok = _div(shape[-1], msize)
        in_ok = fsdp and _div(shape[-2], dsize)
        return [DATA_AXIS if in_ok else None, MODEL_AXIS if out_ok else None]
    if name in ("wo", "w_down", "out_proj", "x_proj"):
        in_ok = _div(shape[-2], msize)
        out_ok = fsdp and _div(shape[-1], dsize)
        return [MODEL_AXIS if in_ok else None, DATA_AXIS if out_ok else None]
    if name in ("bq", "bk", "bv", "b_up"):
        return [MODEL_AXIS if _div(shape[-1], msize) else None]
    if name == "conv_w":
        return [None, MODEL_AXIS if _div(shape[-1], msize) else None]
    if name in ("conv_b", "dt_bias", "D"):
        return [MODEL_AXIS if _div(shape[-1], msize) else None]
    if name == "A_log":
        return [MODEL_AXIS if _div(shape[-2], msize) else None, None]
    # norms, scalar-ish leaves: replicated
    return [None] * min(len(shape), 1)


def _leaf_spec(path: Sequence[str], shape: Sequence[int], mesh,
               fsdp: bool) -> PartitionSpec:
    """The full PartitionSpec of one leaf of key path ``path``."""
    shape = tuple(int(n) for n in shape)
    name = path[-1] if path else ""
    trailing = _base_rule(name, path, shape, mesh, fsdp)
    trailing = trailing[-len(shape):] if len(trailing) > len(shape) else trailing
    return P(*([None] * (len(shape) - len(trailing)) + list(trailing)))


def param_pspecs(params_shape: Any, mesh, fsdp: bool = False) -> Any:
    """PartitionSpec tree matching ``params_shape`` (tensors, meta tensors or
    anything with a ``shape``)."""
    return tree_map_with_path(
        lambda p, leaf: _leaf_spec(p, leaf.shape, mesh, fsdp), params_shape)


def _client_axis(client_axes: Sequence[str]) -> Any:
    return tuple(client_axes) if len(client_axes) > 1 else client_axes[0]


def cohort_state_pspecs(state_shape: Any, mesh, fsdp: bool = False,
                        client_axes=(DATA_AXIS,)) -> Any:
    """Specs for ``CohortState``: client-stacked trees get the client dim
    sharded over the data(+pod) axes; global params are TP-only."""
    from repro_torch.core.cohort import CohortState

    client_axis = _client_axis(client_axes)

    def stacked_spec(tree):
        return tree_map_with_path(lambda p, leaf: P(client_axis, *_leaf_spec(
            p, tuple(leaf.shape)[1:], mesh, False)), tree)

    return CohortState(
        global_params=param_pspecs(state_shape.global_params, mesh, fsdp),
        client_params=stacked_spec(state_shape.client_params),
        client_base=stacked_spec(state_shape.client_base),
        client_version=P(client_axis),
        version=P(),
    )


def dist_state_pspecs(state_shape: Any, mesh) -> Any:
    """Specs for ``DistFLState`` (FSDP x TP params, the accumulator alike)."""
    from repro_torch.core.cohort import DistFLState

    pspec = param_pspecs(state_shape.global_params, mesh, fsdp=True)
    return DistFLState(
        global_params=pspec,
        accum=pspec,
        v_buf=P(),
        count=P(),
        version=P(),
        update_norm_ring=P(),
    )


def batch_pspecs(batch_shape: Any, batch_axes=(DATA_AXIS,)) -> Any:
    """Shard the leading (batch/cohort) dim of every batch leaf."""
    ax = _client_axis(batch_axes)

    def leaf(_, t):
        n = len(t.shape)
        return P() if n == 0 else P(ax, *([None] * (n - 1)))

    return tree_map_with_path(leaf, batch_shape)


def cache_pspecs(cache_shape: Any, mesh, batch_axes=(DATA_AXIS,),
                 batch_size: int = 0) -> Any:
    """KV/SSM cache specs: batch dim over data(+pod) when divisible, the
    head_dim / d_inner dim over model when divisible.

    Cache leaves (from ``blocks.init_stack_cache``): leading L, then
      kv k/v : (L, B, len, Hkv, hd)   -> (None, B_ax, None, None, model)
      ssm conv: (L, B, K-1, di)       -> (None, B_ax, None, model)
      ssm h  : (L, B, di, N)          -> (None, B_ax, model, None)
      cross k/v: (L, B, S_enc, Hkv, hd) same as kv
    """
    msize = mesh_axis_size(mesh, MODEL_AXIS)
    bsize = 1
    for a in batch_axes:
        bsize *= mesh_axis_size(mesh, a)
    b_ax = _client_axis(batch_axes)

    def leaf_spec(keys, t):
        shape = tuple(t.shape)
        b_ok = len(shape) >= 2 and shape[1] % bsize == 0
        bspec = b_ax if b_ok else None
        if "kv" in keys or "cross" in keys:
            hd_ok = shape[-1] % msize == 0
            return P(None, bspec, None, None, MODEL_AXIS if hd_ok else None)
        if keys[-1] == "conv":
            return P(None, bspec, None,
                     MODEL_AXIS if shape[-1] % msize == 0 else None)
        if keys[-1] == "h":
            return P(None, bspec,
                     MODEL_AXIS if shape[-2] % msize == 0 else None, None)
        return P(*([None] * len(shape)))

    return tree_map_with_path(leaf_spec, cache_shape)
