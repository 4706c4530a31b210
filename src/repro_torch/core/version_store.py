"""Codec-pluggable compressed version store.

The paper's eq. 3 staleness weighting needs the server to retain
R = max_staleness + 1 model versions. Stored as R full f32 flat rows the
ring is linear in model size, but eq. 3 only consumes *distances* to ring
entries, and clients pull bases that M local SGD steps immediately
perturb, so the rows can be stored compressed. A port of the JAX
package's ``core/version_store.py`` for one device; ``core/round_body.py::
make_ring_round`` is codec-agnostic and ``sim/engine.py`` carries the
codec state through checkpoints. ``FLConfig.ring_codec`` selects the codec.

Codecs (all on the ``make_flat_spec`` padded flat layout):

``f32``   identity: the (R, Np) f32 matrix. Gather ``ring[slots]``, write
          ``ring[slot] = row`` in place; ``distance_sq`` defers to the
          server pass (returns None), so the f32 round is unchanged.
``int8``  per-block affine quantization: int8 codewords + per-block f32
          (scale, zero) pairs, 3.88x smaller than f32 at qblock=256. eq. 3
          distances run through the K4 kernel (``kernels/ring_codec``), so
          the K decoded rows never feed a second full-width pass.
``delta`` sparse residual against a periodically refreshed f32 base
          snapshot: per row the top-m |residual| entries (m = density *
          Np) as (int32 idx, f32 val) pairs. Distances are exact via
          ||x - (base + s)||^2 = ||x - base||^2 - 2<x - base, s> + ||s||^2.
          Every ``ring_base_refresh`` writes the base snaps to the incoming
          row and retained rows re-encode against it, one row at a time,
          so no (R, Np) dense tensor is ever built.

Writes update the state's tensors in place (the gather copies, so a write
never aliases a base in use); ``encode`` returns the state to carry on,
which for ``delta`` also advances its host-side write count.

Checkpointing: a codec's state round-trips through ``state_to_host`` /
``state_from_host`` as plain numpy (f32: the bare (R, Np) matrix;
compressed codecs: a dict of arrays stamped with the codec name), in the
JAX package's layout, so a ring written by either package restores in the
other. Restore is codec-aware: a layout or codec mismatch raises naming
the codec and the expected layout.

Model sharding: with a mesh whose ``model`` axis has size m > 1,
``build_ring(..., mesh=, shard_ring=True)`` keeps on each rank only its
slice of every row, on the codec's ``pspecs`` (f32 and int8 rows
``P(None, "model")``: ``R * n_padded / m`` values a rank), and
``Int8Codec.distance_sq(..., mesh=)`` runs K4 on the rank's codes, scale
and zero, the partials summed in rank order over ``model``. The delta
codec keeps the rank's slice of its base (``P("model")``) and the sparse
rows replicated (``P()``, global indices); a write takes the row's top-m
across the ranks (``sharding/collectives.py::top_k_across``, one
all-gather, ``lax.top_k``'s tie order), a base refresh re-encodes all R
rows with one gather, and eq. 3 joins ``x - base`` over ``model``, so the
sharded delta ring is the single device's bit for bit. ``shard_ring=False``
replicates the rows on the same mesh (the bit-parity reference).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.server_pass import (
    flatten_tree,
    local_columns,
    make_flat_spec,
    shard_bounds,
)
from repro_torch.kernels.ring_codec import ops as _cops
from repro_torch.kernels.ring_codec import ref as _cref
from repro_torch.sharding.collectives import (
    LocalShard,
    local_slice,
    all_gather_cat,
    sum_in_rank_order,
    top_k_across,
)
from repro_torch.sharding.specs import (
    MODEL_AXIS,
    PartitionSpec,
    flat_param_pspec,
    ring_codes_pspec,
    ring_pspec,
    ring_scales_pspec,
)
from repro_torch.utils.tree import tree_leaves

CODECS = ("f32", "int8", "delta")


def resolve_qblock(spec, requested: int) -> int:
    """Largest power-of-two-ish divisor of the flat tile <= requested.

    The quantization block divides ``spec.block_n`` and therefore
    ``n_padded`` and the per-shard slice; ``block_n`` is a multiple of 128,
    so halving from the requested size always ends at a valid block.
    """
    qb = max(1, int(requested))
    while spec.block_n % qb:
        qb //= 2
    return max(qb, 1)


# ---------------------------------------------------------------------------
# codec states
# ---------------------------------------------------------------------------


class Int8RingState(NamedTuple):
    """int8 codec device state: codewords + per-block affine params."""

    codes: torch.Tensor  # (R, Np) int8
    scale: torch.Tensor  # (R, Np // qblock) f32
    zero: torch.Tensor  # (R, Np // qblock) f32


class DeltaRingState(NamedTuple):
    """delta codec device state: base snapshot + per-row sparse residual.

    ``writes`` is the ring-write counter on the device (checkpointed);
    ``host_writes`` mirrors it on the host, so the refresh schedule is
    decided without reading the device every round.
    """

    base: torch.Tensor  # (Np,) f32 snapshot the residuals are against
    idx: torch.Tensor  # (R, m) int32 residual positions
    val: torch.Tensor  # (R, m) f32 residual values
    writes: torch.Tensor  # () int32 ring-write counter (refresh schedule)
    host_writes: int = 0


def state_tensors(state) -> Tuple[torch.Tensor, ...]:
    """The device tensors a codec state holds (what it costs on the card)."""
    if isinstance(state, torch.Tensor):
        return (state,)
    return tuple(t for t in state if isinstance(t, torch.Tensor))


def _map_tensors(state, leaves: List[Any]):
    """``state`` with its tensors (``state_tensors``' order) replaced by
    ``leaves``; host fields (the delta ring's ``host_writes``) kept."""
    if isinstance(state, torch.Tensor):
        return leaves[0]
    it = iter(leaves)
    return type(state)(*(next(it) if isinstance(t, torch.Tensor) else t
                         for t in state))


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class F32Codec:
    """Identity codec: the (R, Np) f32 ring."""

    name = "f32"

    def init_state(self, spec, flat0: torch.Tensor, depth: int):
        return flat0[None].repeat(depth, 1)

    def decode(self, spec, state, slots: torch.Tensor) -> torch.Tensor:
        return state.index_select(0, slots)

    def encode(self, spec, state, slot, row: torch.Tensor):
        state[slot] = row
        return state

    def distance_sq(self, spec, state, slots, x, *, use_kernel=False,
                    mesh=None):
        """None: the server pass computes eq. 3 from the decoded rows."""
        return None

    def pspecs(self, spec) -> List[PartitionSpec]:
        return [ring_pspec()]

    def expected_layout(self, spec, depth: int) -> Dict[str, Tuple]:
        return {"ring": ((depth, spec.n_padded), "float32")}

    def device_bytes(self, spec, depth: int, model_shards: int = 1) -> int:
        per_shard_np = -(-spec.n_padded // model_shards)
        return depth * per_shard_np * 4

    def state_to_host(self, state) -> np.ndarray:
        return _host(state, np.float32)

    def state_from_host(self, spec, depth: int, host, device):
        if isinstance(host, dict):
            raise ValueError(_codec_mismatch_msg(self, spec, depth, host))
        rows = np.asarray(host)
        if tuple(rows.shape) != (depth, spec.n_padded):
            raise ValueError(
                f"checkpointed f32 ring shape {tuple(rows.shape)} does not "
                f"match this run's layout "
                f"{_layout_str(self.expected_layout(spec, depth))} — same "
                "model/fl config (incl. ring_codec) required to resume")
        return _tensor(rows, np.float32, device)


@dataclasses.dataclass(frozen=True)
class Int8Codec:
    """Per-block affine int8 quantization (codewords + scale/zero)."""

    qblock: int = 256

    name = "int8"

    def _qb(self, spec) -> int:
        return resolve_qblock(spec, self.qblock)

    def _nblocks(self, spec) -> int:
        return spec.n_padded // self._qb(spec)

    def _quant_row(self, spec, row: torch.Tensor):
        """(Np,) f32 -> (codes (Np,) int8, scale (Nb,), zero (Nb,)).

        The JAX package's op order exactly: zero = 0.5 * (hi + lo), scale =
        (hi - lo) / 254, round-half-even of (v - zero) / safe, clip to
        [-127, 127]. A zero-range block stores scale 0 and decodes exactly.
        """
        v = row.reshape(-1, self._qb(spec))
        hi = torch.amax(v, dim=1)
        lo = torch.amin(v, dim=1)
        zero = 0.5 * (hi + lo)
        scale = (hi - lo) / 254.0  # symmetric range [-127, 127]
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        q = torch.round((v - zero[:, None]) / safe[:, None])
        codes = torch.clamp(q, -127, 127).to(torch.int8)
        return codes.reshape(-1), scale, zero

    def init_state(self, spec, flat0: torch.Tensor, depth: int):
        codes, scale, zero = self._quant_row(spec, flat0)
        return Int8RingState(codes=codes[None].repeat(depth, 1),
                             scale=scale[None].repeat(depth, 1),
                             zero=zero[None].repeat(depth, 1))

    def decode(self, spec, state: Int8RingState, slots) -> torch.Tensor:
        return _cref.dequant_ref(state.codes.index_select(0, slots),
                                 state.scale.index_select(0, slots),
                                 state.zero.index_select(0, slots),
                                 self._qb(spec))

    def encode(self, spec, state: Int8RingState, slot, row):
        codes, scale, zero = self._quant_row(spec, row)
        state.codes[slot] = codes
        state.scale[slot] = scale
        state.zero[slot] = zero
        return state

    def distance_sq(self, spec, state: Int8RingState, slots, x, *,
                    use_kernel=False, mesh=None):
        """Fused dequantize-distance: K4 on CUDA tensors under a kernel
        mode (``batched``/``fused``); the plain version otherwise.

        ``x`` is the whole flat vector. Under a model-sharded ``spec`` each
        rank runs it on its slice of x and of the codes, scale and zero
        (sliced here from a replicated ring), and the partials meet in one
        all-gather over ``model``, summed in rank order.
        """
        qb = self._qb(spec)
        codes = state.codes.index_select(0, slots)
        scale = state.scale.index_select(0, slots)
        zero = state.zero.index_select(0, slots)
        sharded = getattr(spec, "model_shards", 1) > 1
        if sharded:
            lo, hi = shard_bounds(spec)
            x = x[lo:hi]
            if codes.shape[1] == spec.n_padded:  # a replicated ring
                codes = local_columns(spec, codes)
                scale = scale[:, lo // qb:hi // qb].contiguous()
                zero = zero[:, lo // qb:hi // qb].contiguous()
        if use_kernel:
            part = _cops.int8_sq_dists(x, codes, scale, zero, qblock=qb)
        else:
            part = _cref.int8_sq_dists_ref(x, codes, scale, zero, qb)
        if not sharded:
            return part
        return sum_in_rank_order(part, mesh.get_group(MODEL_AXIS))

    def pspecs(self, spec) -> List[PartitionSpec]:
        return [ring_codes_pspec(), ring_scales_pspec(), ring_scales_pspec()]

    def expected_layout(self, spec, depth: int) -> Dict[str, Tuple]:
        nb = self._nblocks(spec)
        return {"codes": ((depth, spec.n_padded), "int8"),
                "scale": ((depth, nb), "float32"),
                "zero": ((depth, nb), "float32")}

    def device_bytes(self, spec, depth: int, model_shards: int = 1) -> int:
        per_shard_np = -(-spec.n_padded // model_shards)
        per_shard_nb = -(-self._nblocks(spec) // model_shards)
        return depth * (per_shard_np + 2 * per_shard_nb * 4)

    def state_to_host(self, state: Int8RingState) -> Dict[str, np.ndarray]:
        return {"codec": np.asarray(self.name),
                "codes": _host(state.codes, np.int8),
                "scale": _host(state.scale, np.float32),
                "zero": _host(state.zero, np.float32)}

    def state_from_host(self, spec, depth: int, host, device):
        arrays = _checked_host_dict(self, spec, depth, host)
        return Int8RingState(
            codes=_tensor(arrays["codes"], np.int8, device),
            scale=_tensor(arrays["scale"], np.float32, device),
            zero=_tensor(arrays["zero"], np.float32, device))


@dataclasses.dataclass(frozen=True)
class DeltaCodec:
    """Sparse residual vs a periodically refreshed f32 base snapshot.

    Under a model-sharded ring (``build_ring(..., mesh=, shard_ring=True)``)
    ``base`` is this rank's slice of the flat layout and ``idx``/``val``
    stay replicated, indexing the GLOBAL flat vector: a row's top-m runs
    over every rank's slice with ``top_k_across`` (one all-gather a write),
    ``decode`` returns the rank's columns, and ``distance_sq`` joins ``x -
    base`` over ``model`` (one all-gather). Every step equals the single
    device's bit for bit, so a sharded ring, a replicated one
    (``shard_ring=False``) and one device at the same ``n_padded`` agree.
    """

    density: float = 0.05
    base_refresh: int = 0  # 0 -> ring depth (one full lap)

    name = "delta"

    def _m(self, spec) -> int:
        return max(1, min(spec.n_padded,
                          int(round(self.density * spec.n_padded))))

    def _refresh_every(self, depth: int) -> int:
        return self.base_refresh if self.base_refresh > 0 else depth

    def init_state(self, spec, flat0: torch.Tensor, depth: int):
        m = self._m(spec)
        dev = flat0.device
        return DeltaRingState(
            base=flat0.clone(),
            idx=torch.zeros((depth, m), dtype=torch.int32, device=dev),
            val=torch.zeros((depth, m), dtype=torch.float32, device=dev),
            writes=torch.zeros((), dtype=torch.int32, device=dev),
            host_writes=0)

    @staticmethod
    def _local(spec, state: DeltaRingState):
        """``(lo, hi, group)``: the columns ``state.base`` holds and the
        ``model`` group a row's top-m spans; the group is None when the base
        is whole (no mesh, a data-only mesh, ``shard_ring=False``)."""
        if state.base.shape[0] == spec.n_padded:
            return 0, spec.n_padded, None
        lo, hi = shard_bounds(spec)
        return lo, hi, spec.mesh.get_group(MODEL_AXIS)

    @staticmethod
    def _in_slice(idx: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        """Global indices -> positions in a slice of ``hi - lo`` columns plus
        one spare column, where every index outside ``[lo, hi)`` goes (a
        scatter then drops the spare column: no host read, exact)."""
        idx = idx.long()
        inside = (idx >= lo) & (idx < hi)
        return torch.where(inside, idx - lo, hi - lo)

    def decode(self, spec, state: DeltaRingState, slots) -> torch.Tensor:
        """(K, hi - lo) rows: the base plus the scatter of each row's
        residual entries that fall in the base's columns."""
        lo, hi, _ = self._local(spec, state)
        pos = self._in_slice(state.idx.index_select(0, slots), lo, hi)
        val = state.val.index_select(0, slots)
        # scatter_add_ uses atomics on CUDA; a row's indices are distinct
        # except in all-zero rows (init, refreshed slot), where every value
        # added is 0, so the sum stays exact in any order
        sp = torch.zeros((pos.shape[0], hi - lo + 1), dtype=torch.float32,
                         device=val.device).scatter_add_(1, pos, val)
        return state.base[None] + sp[:, :hi - lo]

    def _top_m(self, dense: torch.Tensor, m: int, lo: int, group):
        """Top-m |dense| entries of each row (the last axis), ties to the
        lower global index (``lax.top_k``'s order): a stable descending sort
        keeps equal magnitudes in index order, where ``torch.topk`` promises
        no order on ties. ``dense`` holds the columns from ``lo``; with a
        ``group`` the rows span its ranks (one all-gather for the batch)."""
        if group is None:
            idx = torch.sort(torch.abs(dense), dim=-1, descending=True,
                             stable=True).indices[..., :m]
            return idx.to(torch.int32), dense.gather(-1, idx)
        cols = torch.arange(lo, lo + dense.shape[-1], dtype=torch.int32,
                            device=dense.device)
        _, idx, (val,) = top_k_across(torch.abs(dense), cols, m, group,
                                      payload=(dense,))
        return idx, val

    def encode(self, spec, state: DeltaRingState, slot, row):
        """Write ``row`` (the base's columns of the new version) at ``slot``."""
        m = self._m(spec)
        lo, hi, group = self._local(spec, state)
        every = self._refresh_every(state.idx.shape[0])
        if (state.host_writes + 1) % every:
            idx, val = self._top_m(row - state.base, m, lo, group)
            state.idx[slot] = idx
            state.val[slot] = val
        else:
            # refresh: the new base is the incoming row and every retained
            # row re-encodes against it. Row r's dense residual vs the new
            # base is (base_old - base_new) + scatter(idx_r, val_r), rebuilt
            # one row at a time so the (R, Np) dense ring never exists; a
            # rank keeps each row's local candidates, and one gather merges
            # all R rows
            base_diff = F.pad(state.base - row, (0, 1))
            picks = []
            for r in range(state.idx.shape[0]):
                dense = base_diff.index_add(
                    0, self._in_slice(state.idx[r], lo, hi),
                    state.val[r])[:hi - lo]
                order = torch.sort(torch.abs(dense), descending=True,
                                   stable=True).indices[:m]
                picks.append((order, dense[order]))
            idx = torch.stack([i for i, _ in picks]).to(torch.int32) + lo
            val = torch.stack([v for _, v in picks])
            if group is not None:
                _, idx, (val,) = top_k_across(torch.abs(val), idx, m, group,
                                              payload=(val,))
            state.idx.copy_(idx)
            state.val.copy_(val)
            # the slot being written IS the new base: residual exactly 0
            state.idx[slot] = 0
            state.val[slot] = 0.0
            state.base.copy_(row)
        state.writes.add_(1)
        return state._replace(host_writes=state.host_writes + 1)

    def distance_sq(self, spec, state: DeltaRingState, slots, x, *,
                    use_kernel=False, mesh=None):
        """Exact eq. 3 distances without densifying the rows:
        ||x - (base + s_r)||^2 = ||x - base||^2 - 2<x - base, s_r>
        + ||s_r||^2, one dense pass over the base plus O(m) gathers.

        ``x`` is the whole flat vector. Under a model-sharded ring each rank
        holds ``x - base`` on its columns; one all-gather over ``model``
        joins the whole vector, and every rank evaluates the formula as one
        device does, bit for bit. Rank partials would not do: the formula
        subtracts terms far larger than its result, and the top-m selection
        of the next write turns the last bits of a distance into different
        ring entries, so a run on partials drifts from the single device's
        (measured on the card: ``PERF.md`` §6)."""
        xb = x - state.base if state.base.shape[0] == spec.n_padded else \
            all_gather_cat(x[slice(*shard_bounds(spec))] - state.base,
                           spec.mesh.get_group(MODEL_AXIS))
        idx = state.idx.index_select(0, slots).long()
        val = state.val.index_select(0, slots)
        d = (torch.sum(xb * xb)
             - 2.0 * torch.sum(xb[idx] * val, dim=1)
             + torch.sum(val * val, dim=1))
        return torch.clamp(d, min=0.0)

    def pspecs(self, spec) -> List[PartitionSpec]:
        # base rides the flat-param layout; the sparse (idx, val) pairs
        # index the GLOBAL flat vector, so they stay replicated (m is
        # density * Np entries a row), as does the write counter
        return [flat_param_pspec(), PartitionSpec(), PartitionSpec(),
                PartitionSpec()]

    def expected_layout(self, spec, depth: int) -> Dict[str, Tuple]:
        m = self._m(spec)
        return {"base": ((spec.n_padded,), "float32"),
                "idx": ((depth, m), "int32"),
                "val": ((depth, m), "float32"),
                "writes": ((), "int32")}

    def device_bytes(self, spec, depth: int, model_shards: int = 1) -> int:
        per_shard_np = -(-spec.n_padded // model_shards)
        return per_shard_np * 4 + depth * self._m(spec) * 8 + 4

    def state_to_host(self, state: DeltaRingState) -> Dict[str, np.ndarray]:
        return {"codec": np.asarray(self.name),
                "base": _host(state.base, np.float32),
                "idx": _host(state.idx, np.int32),
                "val": _host(state.val, np.float32),
                "writes": _host(state.writes, np.int32)}

    def state_from_host(self, spec, depth: int, host, device):
        arrays = _checked_host_dict(self, spec, depth, host)
        writes = np.asarray(arrays["writes"], np.int32)
        return DeltaRingState(
            base=_tensor(arrays["base"], np.float32, device),
            idx=_tensor(arrays["idx"], np.int32, device),
            val=_tensor(arrays["val"], np.float32, device),
            writes=_tensor(writes, np.int32, device),
            host_writes=int(writes))


def resolve_codec(fl) -> Any:
    """The codec instance ``FLConfig.ring_codec`` selects."""
    if fl.ring_codec == "f32":
        return F32Codec()
    if fl.ring_codec == "int8":
        return Int8Codec(qblock=fl.ring_qblock)
    if fl.ring_codec == "delta":
        return DeltaCodec(density=fl.ring_delta_density,
                          base_refresh=fl.ring_base_refresh)
    raise ValueError(
        f"unknown ring_codec {fl.ring_codec!r}; valid: {CODECS}")


def _host(t, dtype) -> np.ndarray:
    """A tensor, or an array ``fetch_replicated`` already brought back."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype)


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype)).to(device)


# ---------------------------------------------------------------------------
# codec-aware restore errors
# ---------------------------------------------------------------------------


def _layout_str(layout: Dict[str, Tuple]) -> str:
    return "{" + ", ".join(f"{k}: {shape} {dtype}"
                           for k, (shape, dtype) in layout.items()) + "}"


def _codec_mismatch_msg(codec, spec, depth: int, host) -> str:
    if isinstance(host, dict):
        found = str(host.get("codec", "<unstamped dict>"))
    else:
        found = f"f32 matrix of shape {tuple(np.shape(host))}"
    return (f"checkpointed ring was written by codec {found!r} but this "
            f"run uses ring_codec={codec.name!r} expecting layout "
            f"{_layout_str(codec.expected_layout(spec, depth))} — resume "
            "with the SAME ring_codec (and model/fl config) it was "
            "checkpointed with")


def _checked_host_dict(codec, spec, depth: int, host) -> Dict[str, Any]:
    """Validate a compressed codec's host dict: codec stamp + exact layout."""
    if not isinstance(host, dict):
        raise ValueError(_codec_mismatch_msg(codec, spec, depth, host))
    stamp = host.get("codec")
    if stamp is not None and str(np.asarray(stamp)) != codec.name:
        raise ValueError(_codec_mismatch_msg(codec, spec, depth, host))
    layout = codec.expected_layout(spec, depth)
    for key, (shape, _) in layout.items():
        if key not in host:
            raise ValueError(
                f"checkpointed {codec.name!r} ring is missing field "
                f"{key!r}; expected layout {_layout_str(layout)}")
        got = tuple(np.shape(host[key]))
        if got != shape:
            raise ValueError(
                f"checkpointed {codec.name!r} ring field {key!r} has shape "
                f"{got}, expected {shape} (full layout "
                f"{_layout_str(layout)}) — same model/fl config (incl. "
                "ring codec parameters) required to resume")
    return host


# ---------------------------------------------------------------------------
# store construction + host round trip (the engine's entry points)
# ---------------------------------------------------------------------------


# what the most recently built store costs a rank (telemetry, not program
# state): a sharded ring's is this rank's slice
_LAST_BUILT: Dict[str, Any] = {"ring_codec": None,
                               "ring_bytes_per_device": None}


def ring_provenance() -> Dict[str, Any]:
    """{ring_codec, ring_bytes_per_device} of the last store built."""
    return dict(_LAST_BUILT)


def _sharded(spec, shard_ring: bool) -> bool:
    return shard_ring and getattr(spec, "model_shards", 1) > 1


def build_ring(init_params: Any, fl, *, mesh: Optional[Any] = None,
               shard_ring: bool = True, rows: Optional[Any] = None):
    """Build (or restore) the version store. Returns ``(spec, state)``.

    The state lives on the device of ``init_params`` (a nested dict of
    tensors): the raw (R, Np) f32 matrix for the ``f32`` codec, a codec
    NamedTuple otherwise. ``rows`` restores from the host form
    ``ring_state_to_host`` produced (by either package); mismatches raise
    codec-aware errors naming the codec and its expected layout.

    With ``mesh`` (``spec`` is then a ``ShardedFlatSpec`` when its ``model``
    axis has size m > 1) and ``shard_ring=True``, each rank keeps only its
    slice of every row on the codec's ``pspecs``; ``shard_ring=False`` keeps
    the whole rows on every rank. Every rank calls this with the same
    params (and ``rows``).
    """
    spec = make_flat_spec(init_params, fl.server_pass_block_n, mesh)
    depth = fl.max_staleness + 1
    codec = resolve_codec(fl)
    if rows is None:
        state = codec.init_state(spec, flatten_tree(spec, init_params),
                                 depth)
    else:
        device = tree_leaves(init_params)[0].device
        state = codec.state_from_host(spec, depth, rows, device)
    sharded = _sharded(spec, shard_ring)
    if sharded:
        # each rank copies its slice out of the whole rows, which then go
        state = _map_tensors(
            state, [local_slice(t, mesh, ps).contiguous().clone()
                    for t, ps in zip(state_tensors(state),
                                     codec.pspecs(spec))])
    _LAST_BUILT.update(
        ring_codec=codec.name,
        ring_bytes_per_device=codec.device_bytes(
            spec, depth, spec.model_shards if sharded else 1))
    return spec, state


def ring_shards(fl, spec, state, mesh: Optional[Any] = None,
                shard_ring: bool = True) -> Any:
    """The state as ``fetch_replicated`` reads it: a model-sharded ring's
    tensors wrapped as ``LocalShard``s (gathered on fetch), any other ring
    as it is."""
    if not _sharded(spec, shard_ring):
        return state
    codec = resolve_codec(fl)
    return _map_tensors(state, [
        LocalShard(t, mesh, ps)
        for t, ps in zip(state_tensors(state), codec.pspecs(spec))])


def ring_state_to_host(fl, state) -> Any:
    """Device ring state (or its fetched arrays) -> checkpointable host arrays.

    f32 keeps the bare (R, Np) f32 matrix; compressed codecs produce a
    dict of arrays stamped with the codec name (the JAX package's layout).
    """
    return resolve_codec(fl).state_to_host(state)


def ring_device_bytes(fl, spec, model_shards: int = 1) -> int:
    """Bytes the ring costs a rank under ``fl`` on ``spec``'s layout, with
    each row split over ``model_shards`` ranks."""
    return resolve_codec(fl).device_bytes(spec, fl.max_staleness + 1,
                                          model_shards)
