"""Codec-pluggable compressed version store on one device.

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

Not ported: the model-sharded branch (``pspecs`` and the ``mesh`` argument
of the JAX package) comes with Slice E (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.server_pass import flatten_tree, make_flat_spec
from repro_torch.kernels.ring_codec import ops as _cops
from repro_torch.kernels.ring_codec import ref as _cref
from repro_torch.utils.tree import tree_leaves

CODECS = ("f32", "int8", "delta")


def resolve_qblock(spec, requested: int) -> int:
    """Largest power-of-two-ish divisor of the flat tile <= requested.

    The quantization block divides ``spec.block_n`` and therefore
    ``n_padded``; ``block_n`` is a multiple of 128, so halving from the
    requested size always ends at a valid block.
    """
    qb = max(1, int(requested))
    while spec.block_n % qb:
        qb //= 2
    return max(qb, 1)


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "a model-sharded version store is not ported; it comes with the "
            "distributed substrate (ROADMAP.md, Slice E)")


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

    def distance_sq(self, spec, state, slots, x, *, use_kernel=False):
        """None: the server pass computes eq. 3 from the decoded rows."""
        return None

    def expected_layout(self, spec, depth: int) -> Dict[str, Tuple]:
        return {"ring": ((depth, spec.n_padded), "float32")}

    def device_bytes(self, spec, depth: int) -> int:
        return depth * spec.n_padded * 4

    def state_to_host(self, state) -> np.ndarray:
        return state.detach().cpu().numpy().astype(np.float32)

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
                    use_kernel=False):
        """Fused dequantize-distance: K4 on CUDA tensors under a kernel
        mode (``batched``/``fused``); the plain version otherwise."""
        args = (x, state.codes.index_select(0, slots),
                state.scale.index_select(0, slots),
                state.zero.index_select(0, slots))
        if use_kernel:
            return _cops.int8_sq_dists(*args, qblock=self._qb(spec))
        return _cref.int8_sq_dists_ref(*args, self._qb(spec))

    def expected_layout(self, spec, depth: int) -> Dict[str, Tuple]:
        nb = self._nblocks(spec)
        return {"codes": ((depth, spec.n_padded), "int8"),
                "scale": ((depth, nb), "float32"),
                "zero": ((depth, nb), "float32")}

    def device_bytes(self, spec, depth: int) -> int:
        return depth * (spec.n_padded + 2 * self._nblocks(spec) * 4)

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
    """Sparse residual vs a periodically refreshed f32 base snapshot."""

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

    def decode(self, spec, state: DeltaRingState, slots) -> torch.Tensor:
        idx = state.idx.index_select(0, slots).long()
        val = state.val.index_select(0, slots)
        # scatter_add_ uses atomics on CUDA; a row's indices are distinct
        # except in all-zero rows (init, refreshed slot), where every value
        # added is 0, so the sum stays exact in any order
        sp = torch.zeros((idx.shape[0], spec.n_padded), dtype=torch.float32,
                         device=val.device).scatter_add_(1, idx, val)
        return state.base[None] + sp

    def _top_m(self, dense: torch.Tensor, m: int):
        """Top-m |dense| entries, ties to the lower index (``lax.top_k``'s
        order): a stable descending sort keeps equal magnitudes in index
        order, where ``torch.topk`` promises no order on ties."""
        idx = torch.sort(torch.abs(dense), descending=True,
                         stable=True).indices[:m]
        return idx.to(torch.int32), dense[idx]

    def encode(self, spec, state: DeltaRingState, slot, row):
        m = self._m(spec)
        every = self._refresh_every(state.idx.shape[0])
        if (state.host_writes + 1) % every:
            idx, val = self._top_m(row - state.base, m)
            state.idx[slot] = idx
            state.val[slot] = val
        else:
            # refresh: the new base is the incoming row and every retained
            # row re-encodes against it. Row r's dense residual vs the new
            # base is (base_old - base_new) + scatter(idx_r, val_r), rebuilt
            # one row at a time so the (R, Np) dense ring never exists
            base_diff = state.base - row
            for r in range(state.idx.shape[0]):
                dense = base_diff.index_add(0, state.idx[r].long(),
                                            state.val[r])
                state.idx[r], state.val[r] = self._top_m(dense, m)
            # the slot being written IS the new base: residual exactly 0
            state.idx[slot] = 0
            state.val[slot] = 0.0
            state.base.copy_(row)
        state.writes.add_(1)
        return state._replace(host_writes=state.host_writes + 1)

    def distance_sq(self, spec, state: DeltaRingState, slots, x, *,
                    use_kernel=False):
        """Exact eq. 3 distances without densifying the rows:
        ||x - (base + s_r)||^2 = ||x - base||^2 - 2<x - base, s_r>
        + ||s_r||^2, one dense pass over the base plus O(m) gathers."""
        xb = x - state.base
        idx = state.idx.index_select(0, slots).long()
        val = state.val.index_select(0, slots)
        d = (torch.sum(xb * xb)
             - 2.0 * torch.sum(xb[idx] * val, dim=1)
             + torch.sum(val * val, dim=1))
        return torch.clamp(d, min=0.0)

    def expected_layout(self, spec, depth: int) -> Dict[str, Tuple]:
        m = self._m(spec)
        return {"base": ((spec.n_padded,), "float32"),
                "idx": ((depth, m), "int32"),
                "val": ((depth, m), "float32"),
                "writes": ((), "int32")}

    def device_bytes(self, spec, depth: int) -> int:
        return spec.n_padded * 4 + depth * self._m(spec) * 8 + 4

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


def _host(t: torch.Tensor, dtype) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy(), dtype)


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


def build_ring(init_params: Any, fl, *, mesh: Optional[Any] = None,
               rows: Optional[Any] = None):
    """Build (or restore) the version store. Returns ``(spec, state)``.

    The state lives on the device of ``init_params`` (a nested dict of
    tensors): the raw (R, Np) f32 matrix for the ``f32`` codec, a codec
    NamedTuple otherwise. ``rows`` restores from the host form
    ``ring_state_to_host`` produced (by either package); mismatches raise
    codec-aware errors naming the codec and its expected layout.
    """
    _no_mesh(mesh)
    spec = make_flat_spec(init_params, fl.server_pass_block_n)
    depth = fl.max_staleness + 1
    codec = resolve_codec(fl)
    if rows is None:
        state = codec.init_state(spec, flatten_tree(spec, init_params),
                                 depth)
    else:
        device = tree_leaves(init_params)[0].device
        state = codec.state_from_host(spec, depth, rows, device)
    return spec, state


def ring_state_to_host(fl, state) -> Any:
    """Device ring state -> checkpointable host arrays.

    f32 keeps the bare (R, Np) f32 matrix; compressed codecs produce a
    dict of arrays stamped with the codec name (the JAX package's layout).
    """
    return resolve_codec(fl).state_to_host(state)


def ring_device_bytes(fl, spec) -> int:
    """Bytes the ring costs on the device under ``fl`` on ``spec``'s layout."""
    return resolve_codec(fl).device_bytes(spec, fl.max_staleness + 1)
