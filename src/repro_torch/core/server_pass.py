"""The contribution-aware server pass on flat parameter vectors.

The paper's per-round server maths — eq. 3 staleness distances, the
weighting policy and the eq. 5 reduction — over the stacked K buffered
updates, with every intermediate left on the device:

    params tree ──flatten/pad──> x (Np,)        f32
    deltas (K, ...) ──flatten──> d (K, Np)       f32
    bases  (K, ...) ──flatten──> b (K, Np)       f32
    dists_k = ||x - b_k||^2                       (eq. 3)
    w = contribution_weights(policy, N_i * losses, S(dists), tau)
    x' = x - eta_g / k_eff * sum_k w_k d_k        (eq. 5)

The flatten adapter walks the parameter tree in the JAX package's leaf
order and zero-pads to the same ``n_padded``, so flat vectors (and the
engine's version-ring rows) match the JAX package's element for element.

``make_server_pass`` wraps the round core for trees of stacked (K, ...)
leaves, with the eq. 4 probe: ``AsyncServer`` (``core/server.py``) runs it
once per round.

Modes (``FLConfig.server_pass_mode``):
  reference : plain PyTorch on any device;
  batched   : eq. 3 through the K2 kernel (``ops.sq_dists``) and eq. 5
              through the K3 kernel (``ops.weighted_sum``);
  fused     : the K1 kernel (``ops.server_update``) — eq. 3 + weighting +
              eq. 5 in one call, bases and deltas each read once;
  auto      : fused on a CUDA device, reference on the CPU.

On CPU tensors the ``ops`` wrappers run their plain versions, so every
mode runs on the CPU too; on CUDA tensors they launch their kernels.

Model sharding (the JAX package's ``shard_map`` over ``model``):
``make_flat_spec(..., mesh=)`` returns a ``ShardedFlatSpec`` padded to a
multiple of ``block_n * model_shards``, so every rank holds a whole number
of tiles, and ``apply_server_round(..., mesh=)`` takes this rank's slice of
the flat vectors. Each rank computes its partial eq. 3 distances through K2
(both kernel modes: K1 needs the global distances before its weights, so
it does not run under ``model > 1``); the partials meet in one all-gather
over ``model`` and are summed in rank order on every rank
(``sharding/collectives.py::sum_in_rank_order``). The (K,) weighting is then
replicated and eq. 5 runs on the rank's slice through K3. Precomputed
``sq_dists`` arrive summed already: no collective at all.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.func import vmap

from repro_torch.configs.base import FLConfig
from repro_torch.core.weighting import (
    contribution_weights,
    staleness_degree,
    statistical_effect,
)
from repro_torch.kernels.weighted_agg import ops as _ops
from repro_torch.sharding.collectives import (
    all_gather_cat,
    sum_in_rank_order,
)
from repro_torch.sharding.specs import MODEL_AXIS, mesh_axis_size
from repro_torch.utils.device import DeviceLike
from repro_torch.utils.tree import Path, tree_leaves, tree_paths, tree_unflatten

MODES = ("auto", "reference", "batched", "fused")


def resolve_mode(mode: str, device: torch.device) -> str:
    """Map ``auto`` to ``fused`` on a CUDA device and ``reference`` on the CPU."""
    if mode not in MODES:
        raise ValueError(f"unknown server_pass_mode {mode!r}; valid: {MODES}")
    if mode == "auto":
        return "fused" if torch.device(device).type == "cuda" else "reference"
    return mode


# ---------------------------------------------------------------------------
# parameter tree flatten / pad / unflatten adapter
# ---------------------------------------------------------------------------


class FlatSpec(NamedTuple):
    """Static layout of a parameter tree flattened to one padded f32 vector."""

    paths: Tuple[Path, ...]  # leaf key paths, JAX leaf order
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    sizes: Tuple[int, ...]
    n: int  # true parameter count
    n_padded: int  # lane-aligned, block-divisible length (JAX's layout)
    block_n: int  # the tile the JAX package pads to


class ShardedFlatSpec(NamedTuple):
    """FlatSpec plus the mesh layout of the flat vector.

    The same leading fields as ``FlatSpec`` (the flatten helpers take
    either), but ``n_padded`` is a multiple of ``block_n * model_shards``,
    so the rank at ``model`` coordinate j holds the whole tiles
    ``[j * n_padded / m, (j + 1) * n_padded / m)``. Zero padding is
    distance- and sum-neutral.
    """

    paths: Tuple[Path, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    sizes: Tuple[int, ...]
    n: int
    n_padded: int
    block_n: int
    mesh: Any  # the DeviceMesh carrying the ``model`` axis
    model_shards: int  # size of the model axis (> 1)


def make_flat_spec(template: Any, block_n: int = 0, mesh: Any = None):
    """Build the flatten layout for ``template`` (a nested dict of tensors).

    With ``mesh`` carrying a ``model`` axis of size m > 1, returns a
    ``ShardedFlatSpec`` padded to a ``block_n * m`` multiple.
    """
    paths = tuple(tree_paths(template))
    leaves = tree_leaves(template)
    shapes = tuple(tuple(x.shape) for x in leaves)
    dtypes = tuple(x.dtype for x in leaves)
    sizes = tuple(int(x.numel()) for x in leaves)
    n = sum(sizes)
    block = block_n or _ops.pick_block(n)
    shards = mesh_axis_size(mesh, MODEL_AXIS)
    if shards > 1:
        return ShardedFlatSpec(paths, shapes, dtypes, sizes, n,
                               _ops.pad_to(n, block * shards), block, mesh,
                               shards)
    return FlatSpec(paths, shapes, dtypes, sizes, n, _ops.pad_to(n, block),
                    block)


def shard_bounds(spec) -> Tuple[int, int]:
    """[lo, hi) of this rank's slice of the flat vector (all of it for an
    unsharded spec)."""
    if not isinstance(spec, ShardedFlatSpec):
        return 0, spec.n_padded
    per = spec.n_padded // spec.model_shards
    j = spec.mesh.get_local_rank(MODEL_AXIS)
    return j * per, (j + 1) * per


def local_columns(spec, mat: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous slice of the last axis of ``mat``, whose last
    axis is the whole flat layout (a copy where the slice is strided)."""
    lo, hi = shard_bounds(spec)
    return mat[..., lo:hi].contiguous()


def _flatten_into(out: torch.Tensor, n: int, parts) -> torch.Tensor:
    """Write each (lead..., size) part, converted to f32, straight into its
    columns of ``out`` (lead..., n_padded) and zero the pad: the layout of
    ``cat`` + ``F.pad`` over f32 copies, with no copy but the buffer."""
    off = 0
    for part in parts:
        size = part.shape[-1]
        out[..., off:off + size].copy_(part)
        off += size
    out[..., n:].zero_()
    return out


def flatten_tree(spec: FlatSpec, tree: Any) -> torch.Tensor:
    """tree -> (n_padded,) f32, zero-padded (distance- and sum-neutral)."""
    leaves = tree_leaves(tree)
    out = torch.empty((spec.n_padded,), dtype=torch.float32,
                      device=leaves[0].device)
    return _flatten_into(out, spec.n, (x.reshape(-1) for x in leaves))


def flatten_stacked(spec: FlatSpec, stacked: Any) -> torch.Tensor:
    """tree with (K, ...) leaves -> (K, n_padded) f32."""
    leaves = tree_leaves(stacked)
    k = leaves[0].shape[0]
    out = torch.empty((k, spec.n_padded), dtype=torch.float32,
                      device=leaves[0].device)
    return _flatten_into(out, spec.n, (x.reshape(k, -1) for x in leaves))


def flatten_stacked_sub(spec: FlatSpec, a: Any, b: Any) -> torch.Tensor:
    """``flatten_stacked(spec, tree_sub(a, b))``: each leaf's ``a - b`` is
    taken in the leaves' dtype, as ``tree_sub`` does, and written into the
    f32 rows before the next is made, so one leaf's difference is the only
    scratch."""
    la, lb = tree_leaves(a), tree_leaves(b)
    k = la[0].shape[0]
    out = torch.empty((k, spec.n_padded), dtype=torch.float32,
                      device=la[0].device)
    return _flatten_into(out, spec.n, (torch.sub(x, y).reshape(k, -1)
                                       for x, y in zip(la, lb)))


def unflatten_stacked(spec: FlatSpec, mat: torch.Tensor) -> Any:
    """(K, n_padded) f32 -> tree with (K, ...) leaves (the spec's dtypes)."""
    k = mat.shape[0]
    leaves, off = [], 0
    for shape, dtype, size in zip(spec.shapes, spec.dtypes, spec.sizes):
        leaves.append(mat[:, off:off + size].reshape((k,) + shape).to(dtype))
        off += size
    return tree_unflatten(list(spec.paths), leaves)


def unflatten_like(spec: FlatSpec, vec: torch.Tensor) -> Any:
    """(n_padded,) or (n,) f32 -> tree with the spec's shapes and dtypes.

    Where every leaf is f32 the leaves are views of ``vec``; in a mixed
    tree (bf16 weights, f32 norms) the f32 leaves are copied, so that a few
    small leaves do not keep the whole f32 vector alive beside the cast
    params."""
    mixed = any(dt != vec.dtype for dt in spec.dtypes)
    leaves, off = [], 0
    for shape, dtype, size in zip(spec.shapes, spec.dtypes, spec.sizes):
        leaf = vec[off:off + size].reshape(shape)
        leaves.append(leaf.clone() if mixed and dtype == vec.dtype
                      else leaf.to(dtype))
        off += size
    return tree_unflatten(list(spec.paths), leaves)


# ---------------------------------------------------------------------------
# the round core
# ---------------------------------------------------------------------------


def apply_server_round(x: torch.Tensor, bases: torch.Tensor,
                       deltas: torch.Tensor, losses: torch.Tensor,
                       data_sizes: torch.Tensor, taus: torch.Tensor,
                       fl: FLConfig, *,
                       arrival_mask: Optional[torch.Tensor] = None,
                       mode: str = "reference",
                       sq_dists: Optional[torch.Tensor] = None,
                       mesh: Any = None
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """eq. 3 + 4 + 5 on flat tensors. Returns (new_x, info dict of (K,)).

    x: (Np,), bases/deltas: (K, Np); losses/data_sizes/taus: (K,).
    ``arrival_mask`` zeroes absent slots (weights AND the k_eff divisor).
    ``mode`` is a concrete mode (see ``resolve_mode``). ``sq_dists`` (K,)
    are eq. 3 distances the compressed ring codecs computed themselves:
    the pass then skips its own eq. 3 (and K1), weighting those distances
    and reducing through K3 in both kernel modes.

    With ``mesh`` carrying a ``model`` axis of size m > 1, x, bases, deltas
    and the returned new_x are this rank's slice (``shard_bounds`` of a
    ``ShardedFlatSpec``): the partial distances meet in one all-gather over
    ``model``, summed in rank order, and the info is the same on every rank.
    """
    if mode not in ("reference", "batched", "fused"):
        raise ValueError(f"unknown concrete mode {mode!r}")
    p = statistical_effect(losses, data_sizes)
    k = bases.shape[0]
    mask = (torch.ones((k,), dtype=torch.float32, device=bases.device)
            if arrival_mask is None else arrival_mask.to(torch.float32))
    taus = taus.to(torch.float32)
    sharded = mesh_axis_size(mesh, MODEL_AXIS) > 1
    if mode == "fused" and sq_dists is None and not sharded:
        upd, dists, w = _ops.server_update(
            x, bases, deltas, p, taus, mask, policy=fl.weighting,
            eta_g=fl.global_lr, s_min=fl.s_min, poly_a=fl.poly_a,
            hinge_a=fl.hinge_a, hinge_b=fl.hinge_b, normalize=fl.normalize)
        s = staleness_degree(dists, arrival_mask=mask)
    else:
        # K1 weights from the distances it sums itself: with precomputed
        # or per-shard distances fused mode runs K2 + K3 instead
        use_kernel = mode in ("batched", "fused")
        if sq_dists is not None:
            dists = sq_dists.to(torch.float32)
        else:
            dists = _sq_dists(x, bases, use_kernel=use_kernel)
            if sharded:
                dists = sum_in_rank_order(dists, mesh.get_group(MODEL_AXIS))
        upd, s, w = _weight_and_reduce(dists, deltas, p, taus, mask, fl,
                                       use_kernel=use_kernel)
    info = {"sq_dists": dists, "staleness": s, "stat_effect": p,
            "weights": w, "fresh_loss": losses}
    return x - upd, info


def _sq_dists(x: torch.Tensor, bases: torch.Tensor, *,
              use_kernel: bool) -> torch.Tensor:
    """eq. 3 squared distances over the flat vector."""
    if use_kernel:
        return _ops.sq_dists(x, bases)
    diff = bases - x[None]
    return torch.sum(diff * diff, dim=1)


def _weight_and_reduce(dists, deltas, p, taus, mask, fl: FLConfig, *,
                       use_kernel: bool):
    """Everything after eq. 3: staleness ratio -> policy weights -> the eq. 5
    weighted-delta reduction. The eq. 3 min reference runs over arrived
    slots only."""
    s = staleness_degree(dists, arrival_mask=mask)
    w = contribution_weights(fl.weighting, p, s, taus, s_min=fl.s_min,
                             poly_a=fl.poly_a, hinge_a=fl.hinge_a,
                             hinge_b=fl.hinge_b, normalize=fl.normalize,
                             arrival_mask=mask)
    k_eff = torch.clamp(torch.sum(mask), min=1.0)
    w_scaled = w * (fl.global_lr / k_eff)
    if use_kernel:
        upd = _ops.weighted_sum(deltas, w_scaled)
    else:
        upd = torch.sum(deltas * w_scaled[:, None], dim=0)
    return upd, s, w


def make_server_pass(fl: FLConfig, fresh_loss_fn: Optional[Callable], *,
                     mode: Optional[str] = None,
                     device: DeviceLike = "cuda", mesh: Any = None) -> Callable:
    """The server pass over stacked trees, memoized per (fl, fresh_loss_fn,
    mode, device), as the JAX package's ``make_server_pass``.

    Returns ``pass_fn(params, deltas_st, bases_st, probes, probe_mask,
    data_sizes, taus, precomputed_losses=None) -> (new_params, info)``:
    ``deltas_st`` / ``bases_st`` are trees with (K, ...) leaves, ``probes``
    a tree of stacked probe batches (leading K) or None, ``probe_mask`` (K,)
    {0, 1} marks the entries that supplied a probe (the rest take loss 1.0,
    i.e. pure size weighting), and ``precomputed_losses`` (K,) skips the
    probe. The eq. 4 probe is ``torch.func.vmap`` of ``fresh_loss_fn`` over
    the batch axis. ``mode`` (default ``fl.server_pass_mode``) resolves on
    ``device``: ``auto`` is ``fused`` on CUDA, ``reference`` on the CPU.
    Everything stays on the device.

    ``mesh`` shards the flat-vector round over its ``model`` axis: every
    rank passes the same replicated trees, runs the pass on its slice, and
    gets the whole new params back (one all-gather over ``model``).
    """
    return _server_pass(fl, fresh_loss_fn,
                        fl.server_pass_mode if mode is None else mode,
                        torch.device(device), mesh)


@functools.lru_cache(maxsize=64)
def _server_pass(fl: FLConfig, fresh_loss_fn: Optional[Callable], mode: str,
                 device: torch.device, mesh: Any) -> Callable:
    mode_ = resolve_mode(mode, device)

    def pass_fn(params, deltas_st, bases_st, probes, probe_mask, data_sizes,
                taus, precomputed_losses=None):
        spec = make_flat_spec(params, fl.server_pass_block_n, mesh)
        x = local_columns(spec, flatten_tree(spec, params))
        d = local_columns(spec, flatten_stacked(spec, deltas_st))
        b = local_columns(spec, flatten_stacked(spec, bases_st))
        data_sizes_ = data_sizes.to(torch.float32)
        if precomputed_losses is not None:
            losses = precomputed_losses.to(torch.float32)
        elif probes is None or fresh_loss_fn is None:
            losses = torch.ones_like(data_sizes_)
        else:
            losses = vmap(lambda pb: fresh_loss_fn(params, pb))(probes)
            losses = losses.to(torch.float32)
            if probe_mask is not None:
                losses = torch.where(probe_mask > 0, losses, 1.0)
        new_x, info = apply_server_round(x, b, d, losses, data_sizes_, taus,
                                         fl, mode=mode_, mesh=mesh)
        if isinstance(spec, ShardedFlatSpec):
            new_x = all_gather_cat(new_x, mesh.get_group(MODEL_AXIS))
        return unflatten_like(spec, new_x), info

    return pass_fn
