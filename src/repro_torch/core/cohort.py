"""The FL round as a cohort step: the JAX package's ``core/cohort.py``.

Two deployment mappings (DESIGN.md §2.1):

* **replicated-client** (``make_cohort_step``): C concurrent cohort slots
  (clients). State holds, per slot, the client's *current* local params
  and the *base* snapshot it last pulled, so eq. 3 staleness is computed
  exactly (per-slot ``||x^t - base_i||^2``), the fresh-loss probe (eq. 4)
  evaluates x^t on each client's probe batch, and eq. 5 reduces over the
  arrived slots. Stragglers (``arrival`` 0) carry their local progress
  into the next round instead of contributing. The round maths lives in
  ``core/round_body.py``, the same body the vectorized engine runs, so the
  server pass launches K1 (``fused`` mode) or K2 + K3 (``batched``) once a
  step, on masks with zeros in them; this module only adds the slot state
  machine (resync of arrivals, straggler carry-over, versions).

* **distributed-client** (``make_dist_step``): one client at a time; the
  K-buffer fills across sequential step calls with the running weighted
  accumulator of ``make_streaming_round_body``. ``count`` and ``version``
  are Python ints in the state, so the apply/hold decision (``lax.cond``
  in the JAX package) is a host branch that never waits for the device.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core.round_body import (
    make_round_body,
    make_streaming_round_body,
)
from repro_torch.core.server_pass import make_flat_spec
from repro_torch.obs.trace import (
    NULL_TRACER,
    SPAN_COHORT_STEP,
    SPAN_RESYNC,
    Tracer,
)
from repro_torch.utils.device import DeviceLike, resolve_device
from repro_torch.utils.tree import (
    tree_leaves,
    tree_map,
    tree_sq_dist,
    tree_to_device,
)


# ---------------------------------------------------------------------------
# replicated-client cohort
# ---------------------------------------------------------------------------


class CohortState(NamedTuple):
    global_params: Any  # x^t
    client_params: Any  # (C, ...) current local state per slot
    client_base: Any  # (C, ...) base snapshot each slot pulled (eq. 3)
    client_version: torch.Tensor  # (C,) int32: version of that base
    version: torch.Tensor  # scalar int32, t


def init_cohort_state(params: Any, cohort: int) -> CohortState:
    """Every slot starts from ``params`` (version 0), on ``params``' device."""

    def stack():  # distinct buffers per field
        return tree_map(
            lambda x: x[None].expand((cohort,) + tuple(x.shape)).clone(),
            params)

    dev = tree_leaves(params)[0].device
    return CohortState(
        global_params=params,
        client_params=stack(),
        client_base=stack(),
        client_version=torch.zeros((cohort,), dtype=torch.int32, device=dev),
        version=torch.zeros((), dtype=torch.int32, device=dev),
    )


def make_cohort_step(loss_fn: Callable, fl: FLConfig, *,
                     mesh: Optional[Any] = None,
                     device: DeviceLike = "cuda",
                     tracer: Tracer = NULL_TRACER) -> Callable:
    """Build the replicated-client FL round for state on ``device``.

    loss_fn(params, batch) -> (scalar, metrics). Batch layout (C slots):
      batch["local"] : leaves (C, M, b, ...): M local steps per slot
      batch["probe"] : leaves (C, bp, ...): fresh-loss probe (eq. 4)
      batch["arrival"]: (C,) f32 {0, 1}: slots buffered this round
      batch["data_sizes"]: (C,) f32: N_i
    Host arrays are copied onto ``device``. Returns ``step(state, batch) ->
    (new_state, metrics)``; the state is never written in place.
    ``fl.server_pass_mode`` resolves on ``device`` (``auto``: fused on
    CUDA).

    ``mesh`` shards the C slots over ``data`` inside the round body and the
    flat-vector server pass over ``model`` (``core/round_body.py``); every
    rank steps the same replicated state with the same batch and gets the
    same new state. With no mesh the step is the single-device one.

    ``tracer`` (default off) records each call as a ``cohort_step`` span
    holding the round body's ``local_train``, ``probe`` and
    ``server_pass`` and this step's ``resync``, and is the
    ``active_tracer()`` for the call, so the model's MoE spans and the
    kernel loads land in it too (``obs/trace.py``).
    """
    dev = resolve_device(device)
    bodies: Dict[Any, Callable] = {}  # one round body per params layout

    def step(state: CohortState, batch: Dict[str, Any]):
        with tracer.span(SPAN_COHORT_STEP), tracer.activate():
            return step_body(state, batch)

    def step_body(state: CohortState, batch: Dict[str, Any]):
        params = state.global_params
        spec = make_flat_spec(params, fl.server_pass_block_n, mesh)
        if spec not in bodies:
            bodies[spec] = make_round_body(loss_fn, fl, dev, spec, mesh=mesh,
                                           tracer=tracer)
        arrival = torch.as_tensor(batch["arrival"]).to(dev, torch.float32)
        tau = (state.version - state.client_version).to(torch.float32)

        # the paper's round: local training + eq. 3/4/5 (shared body); the
        # body flattens x and the bases itself, after the local training
        new_global, end_params, info = bodies[spec](
            params, None, state.client_base,
            tree_to_device(batch["local"], dev),
            tree_to_device(batch["probe"], dev),
            torch.as_tensor(batch["data_sizes"]).to(dev, torch.float32), tau,
            client_params=state.client_params, arrival_mask=arrival)
        with tracer.span(SPAN_RESYNC):
            fresh, s = info["fresh_loss"], info["staleness"]
            w = info["weights"]

            # arrivals re-sync; stragglers keep their local progress
            def resync(new_src, stacked_old):
                def leaf(g, old):
                    m = arrival.reshape((-1,) + (1,) * (old.dim() - 1))
                    return torch.where(m > 0, g[None].to(old.dtype), old)
                return tree_map(leaf, new_src, stacked_old)

            new_version = state.version + 1
            new_state = CohortState(
                new_global, resync(new_global, end_params),
                resync(new_global, state.client_base),
                torch.where(arrival > 0, new_version,
                            state.client_version).to(torch.int32),
                new_version)

            # round telemetry over ARRIVED slots only: stragglers must not
            # pollute the mins/means; an empty round reports neutral 0.0s
            n_arr = torch.sum(arrival)
            any_arr = n_arr > 0
            zero = torch.zeros((), dtype=torch.float32, device=dev)
            metrics = {
                "fresh_loss_mean": torch.where(
                    any_arr,
                    torch.sum(fresh * arrival) / torch.clamp(n_arr, min=1.0),
                    zero),
                "staleness_min": torch.where(
                    any_arr,
                    torch.min(torch.where(arrival > 0, s, torch.inf)), zero),
                "weights_max": torch.where(
                    any_arr,
                    torch.max(torch.where(arrival > 0, w, -torch.inf)), zero),
                "update_sq_norm": tree_sq_dist(params, new_global),
            }
            return new_state, metrics

    return step


# ---------------------------------------------------------------------------
# distributed-client (sequential buffer, streaming weighted accumulator)
# ---------------------------------------------------------------------------


class DistFLState(NamedTuple):
    global_params: Any  # x^t
    accum: Any  # running sum v_i * Delta_i (params-shaped, fl.accum_dtype)
    v_buf: torch.Tensor  # (buffer_size,) per-slot scalar weights v_i
    count: int  # updates buffered so far (host int: the branch reads it)
    version: int  # t (host int)
    update_norm_ring: torch.Tensor  # (max_staleness,) ||u_s||^2 scalars


def init_dist_state(params: Any, fl: FLConfig) -> DistFLState:
    dev = tree_leaves(params)[0].device
    acc_dtype = getattr(torch, fl.accum_dtype)
    return DistFLState(
        global_params=params,
        accum=tree_map(lambda x: torch.zeros(x.shape, dtype=acc_dtype,
                                             device=dev), params),
        v_buf=torch.zeros((fl.buffer_size,), dtype=torch.float32, device=dev),
        count=0,
        version=0,
        update_norm_ring=torch.zeros((fl.max_staleness,), dtype=torch.float32,
                                     device=dev),
    )


def make_dist_step(loss_fn: Callable, fl: FLConfig, *,
                   device: DeviceLike = "cuda") -> Callable:
    """One sequential buffer contribution + conditional server apply.

    A thin state machine over ``make_streaming_round_body``: all weighting
    and eq. 5 arithmetic lives there; this wrapper manages the buffer fill
    (v-slot write, count), the apply/hold branch (on the host ``count``)
    and the version.

    Batch layout (single client; host arrays are copied onto ``device``):
      batch["local"] : leaves (M, b, ...)
      batch["probe"] : leaves (bp, ...)
      batch["tau"]   : int: staleness in rounds
      batch["data_size"]: float

    Metrics: ``buffered`` is the PRE-apply fill count (so the step that
    triggers the apply reports K, not 0) and ``applied`` is 1 if this step
    flushed the buffer, else 0 (both host ints).
    """
    dev = resolve_device(device)
    streaming = make_streaming_round_body(loss_fn, fl)

    def step(state: DistFLState, batch: Dict[str, Any]):
        accum, v, fresh = streaming.contribute(
            state.global_params, state.accum, state.update_norm_ring,
            tree_to_device(batch["local"], dev),
            tree_to_device(batch["probe"], dev),
            torch.as_tensor(batch["data_size"]).to(dev, torch.float32),
            batch["tau"])
        v_buf = state.v_buf.clone()
        v_buf[state.count] = v
        count = state.count + 1
        applied = count >= fl.buffer_size
        if applied:
            new_params, ring = streaming.apply(
                state.global_params, accum, v_buf, count,
                state.update_norm_ring)
            new_state = DistFLState(new_params,
                                    tree_map(torch.zeros_like, accum),
                                    torch.zeros_like(v_buf), 0,
                                    state.version + 1, ring)
        else:
            new_state = state._replace(accum=accum, v_buf=v_buf, count=count)
        metrics = {"fresh_loss": fresh, "v_weight": v,
                   "buffered": state.count + 1, "applied": int(applied)}
        return new_state, metrics

    return step
