"""Device-resident population engine: million-client scenarios.

``run_vectorized`` keeps every client's state on the host: one PCG64
generator pair per client and a heap of pending uploads, which caps N at
thousands. This engine keeps the whole scenario state machine on the device
instead, as the JAX package's ``sim/population.py`` does:

* **Counter-based RNG.** Every draw of client ``cid`` is a pure function of
  ``(seed, stream, cid, k)``: the stream key is ``fold_in(fold_in(fold_in(
  PRNGKey(seed), tag), cid), k)`` (``utils/threefry.py``, bit-exact to
  ``jax.random``). Draws are random-access, so the order they are consumed
  in is irrelevant, and the per-client state is plain ``(N,)`` counters.
* **Vectorised behavior.** Availability gating, duration draws, Bernoulli
  and trace dropouts and straggler bursts are tensor functions over all N
  clients (``make_behavior_fns``); ``PopState`` is seven tensors.
* **Top-k windows.** A window is the K lexicographically smallest ``(t,
  cid)`` accepted uploads. Each client's next accepted time comes from its
  drop chain (``_peek``); a stable top-k over one int64 key per client,
  ``(bits(t) << 32) | cid``, picks the window (times are >= 0, so their
  float32 bit patterns order like the times, and equal times go to the
  lower cid, the host heap's order). A re-entry check (can a selected
  client's NEXT accept land inside this window?) guards the fast path; when
  it trips, or when K > N, the host event loop runs the window exactly over
  the device tensors (``_exact``).

The JAX package compiles S rounds of (window, pool gather, ring round) into
one ``lax.scan``. Here a chunk is a Python loop of S rounds over device
tensors; ``SimResult.num_launches`` counts chunks. The loops of the window
step (drop chains, the exact walk) stop on device flags the host reads, so
every window costs the host at least one read (the re-entry flag) and one
more per loop pass: **the port reads O(1) scalars per window, where the
JAX package reads none.** Each read counts in ``engine_host_syncs_total``
beside the eval and round-log fetches that the JAX package counts; no
``(N,)`` tensor leaves the device except in ``capture_state``.

The host twins ``CounterBehavior``/``CounterDataset`` consume the SAME
counter streams, so ``run_vectorized`` driven by them reproduces this
engine's events and round log; their float arithmetic is IEEE operations
only, so their draws equal the device's bit for bit on any device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import heapq
import math
import time
from typing import (Any, Callable, Dict, Iterator, List, NamedTuple,
                    Optional, Sequence, Tuple)

import numpy as np
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core.round_body import make_ring_round
from repro_torch.core.version_store import ring_state_to_host
from repro_torch.data.synthetic import ClientDataset
from repro_torch.obs.metrics import MetricsRegistry, default_registry
from repro_torch.obs.trace import (
    NULL_TRACER,
    SPAN_APPLY,
    SPAN_CHECKPOINT,
    SPAN_HOST_SYNC,
    Tracer,
)
from repro_torch.sim.base import (
    SimResult,
    history_from_arrays,
    history_to_arrays,
    record_eval,
    round_log_from_arrays,
    round_log_rows,
    round_log_to_arrays,
)
from repro_torch.sim.engine import _LOG_FIELDS, init_version_ring
from repro_torch.sim.scenarios import ClientBehavior, Scenario
from repro_torch.utils import threefry
from repro_torch.utils.threefry import f32
from repro_torch.utils.device import DeviceLike, resolve_device
from repro_torch.utils.tree import tree_map

# stream tags: every draw is fold_in(fold_in(fold_in(PRNGKey(seed), tag),
# cid), k)
_TAG_DUR = 101     # lognormal duration draws      (mirrors SeedSequence 101)
_TAG_DROP = 202    # Bernoulli dropout draws       (mirrors SeedSequence 202)
_TAG_TRAIN = 303   # local-step batch index draws
_TAG_PROBE = 304   # eq.-4 probe batch index draws
_TAG_TIER = 401    # static: compute tier assignment
_TAG_SPREAD = 402  # static: log-uniform in-tier spread
_TAG_COMM = 403    # static: comm tier assignment
_TAG_PHASE = 404   # static: diurnal phase offset

def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "the population engine on a mesh is not ported; it comes with "
            "the distributed substrate (ROADMAP.md, Slice E)")


def _stream_key(seed: int, tag: int, device: torch.device) -> threefry.Key:
    return threefry.fold_in(threefry.prng_key(seed, device), tag)


def _mod(x: torch.Tensor, y) -> torch.Tensor:
    """``jnp.mod``: ``fmod``, then add the divisor where the signs differ."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def _sort_key(t: torch.Tensor, cid: torch.Tensor) -> torch.Tensor:
    """One int64 per client ordering ``(t, cid)`` lexicographically: the
    float32 bits of ``t >= 0`` order like ``t``; ``cid`` breaks ties."""
    return (t.contiguous().view(torch.int32).to(torch.int64) << 32) | cid


class PopStatics(NamedTuple):
    """Immutable per-client population statics, ``(N,)`` f32 each."""

    speed: torch.Tensor  # multiplicative slowness (sorted, like ClientBehavior)
    comm: torch.Tensor   # additive upload latency
    phase: torch.Tensor  # diurnal phase offset


class PopState(NamedTuple):
    """The whole mutable scenario state machine, as tensors.

    ``(N,)`` per-client fields plus three scalars, in the JAX package's
    dtypes (int32 counters, float32 times): this IS the checkpoint payload.

    * ``t_next``  f32: completion time of the client's pending attempt
    * ``k_next``  i32: upload-attempt index of that pending attempt (also
                  its duration draw and its drop verdict, ``_TAG_DUR`` /
                  ``_TAG_DROP`` draw k)
    * ``batch_k`` i32: train-batch draw counter (advances ``local_steps``
                  per accepted upload; the probe stream is indexed by the
                  accept count ``batch_k // M``)
    * ``base_version`` i32: version of the model the client trains from
    """

    t_next: torch.Tensor
    k_next: torch.Tensor
    batch_k: torch.Tensor
    base_version: torch.Tensor
    version: torch.Tensor     # () i32 server version
    now: torch.Tensor         # () f32 sim time of the last aggregation
    num_events: torch.Tensor  # () i32 uploads processed (incl. dropped)


class _BehaviorFns(NamedTuple):
    """Counter-based draw functions over tensors (any broadcast shape)."""

    gate: Callable      # (phase, t) -> earliest start >= t
    draw: Callable      # (cid, k) -> f32 lognormal draw k of client cid
    finish: Callable    # (draw, cid, t, speed, comm) -> f32 duration
    duration: Callable  # (cid, k, t, speed, comm) -> finish(draw(cid, k), ..)
    dropped: Callable   # (cid, k) -> bool: upload k of cid lost
    has_drops: bool


@functools.lru_cache(maxsize=64)
def make_behavior_fns(sc: Scenario, seed: int,
                      device: torch.device) -> _BehaviorFns:
    """The scenario's stochastic pieces as pure functions of counters.

    Same semantics as ``ClientBehavior`` (diurnal gate, lognormal durations
    with burst multipliers, trace-then-Bernoulli drops), with the PCG64
    streams replaced by threefry counter draws. The arithmetic follows the
    JAX package's after XLA's CPU backend fuses it: ``exp`` of ``log_mean +
    sigma * z`` and the last multiply-add of a duration are single-rounding
    multiply-adds (``threefry.fma``). ``cid`` and ``k`` are int32 tensors,
    times float32 tensors.
    """
    log_mean = f32(math.log(sc.base_mean))
    sigma = f32(sc.sigma)
    k_dur = _stream_key(seed, _TAG_DUR, device)
    k_drop = _stream_key(seed, _TAG_DROP, device)
    period = f32(sc.diurnal_period)
    on = f32(sc.diurnal_duty * sc.diurnal_period)
    has_drops = sc.dropout_p > 0.0 or bool(sc.dropout_trace)
    trace = torch.tensor(sorted((c << 32) | k for c, k in sc.dropout_trace),
                         dtype=torch.int64, device=device)
    drop_p = f32(sc.dropout_p)
    burst_every = torch.tensor(f32(sc.burst_every), device=device)
    stride = max(1, int(round(1.0 / max(sc.burst_frac, 1e-9))))

    def gate(phase, t):
        if not sc.diurnal:
            return t
        local = _mod(t - phase, period)
        return torch.where(local < on, t, t + (period - local))

    def burst_mult(cid, t):
        # j = floor(t / every): a true division by a device tensor (CUDA
        # turns a division by a host scalar into a reciprocal multiply)
        j = torch.floor(t / burst_every).to(torch.int32)
        in_burst = _mod(t, f32(sc.burst_every)) < f32(sc.burst_len)
        hit = torch.remainder(cid + j, stride) == 0
        return torch.where(in_burst & hit, f32(sc.burst_factor), 1.0)

    def draw(cid, k):
        key = threefry.fold_in(threefry.fold_in(k_dur, cid), k)
        z = threefry.normal(key)
        return threefry.exp(threefry.fma(z, sigma, log_mean))

    def finish(dr, cid, t, speed, comm):
        if sc.burst_every <= 0.0:
            return threefry.fma(speed, dr.double(), comm.double())
        return threefry.fma(speed * dr, burst_mult(cid, t).double(),
                             comm.double())

    def duration(cid, k, t, speed, comm):
        return finish(draw(cid, k), cid, t, speed, comm)

    def dropped(cid, k):
        hit = torch.zeros(torch.broadcast_shapes(cid.shape, k.shape),
                          dtype=torch.bool, device=device)
        if sc.dropout_trace:
            ck = (cid.to(torch.int64) << 32) | k.to(torch.int64)
            hit = hit | torch.isin(ck, trace)
        if sc.dropout_p > 0.0:
            key = threefry.fold_in(threefry.fold_in(k_drop, cid), k)
            hit = hit | (threefry.uniform(key) < drop_p)
        return hit

    return _BehaviorFns(gate=gate, draw=draw, finish=finish,
                        duration=duration, dropped=dropped,
                        has_drops=has_drops)


def _init_statics(sc: Scenario, n: int, seed: int,
                 device: torch.device) -> PopStatics:
    """Per-client statics from counter draws: tier and comm tier by
    ``randint``, in-tier spread (log-uniform) and diurnal phase by
    ``uniform``; speeds sorted, like ``ClientBehavior``'s."""
    tiers = torch.tensor(sc.compute_tiers, dtype=torch.float32, device=device)
    comms = torch.tensor(sc.comm_tiers, dtype=torch.float32, device=device)
    log_slow = f32(math.log(max(sc.max_slowdown, 1.0 + 1e-9)))
    cids = torch.arange(n, dtype=torch.int32, device=device)

    def key(tag):
        return threefry.fold_in(_stream_key(seed, tag, device), cids)

    tier = threefry.randint(key(_TAG_TIER), (), 0, len(sc.compute_tiers))
    spread = threefry.exp(threefry.uniform(key(_TAG_SPREAD), (), 0.0,
                                           log_slow))
    comm = comms[threefry.randint(key(_TAG_COMM), (), 0,
                                  len(sc.comm_tiers)).long()]
    phase = threefry.uniform(key(_TAG_PHASE), (), 0.0, sc.diurnal_period)
    speed = torch.sort(tiers[tier.long()] * spread).values
    return PopStatics(speed=speed, comm=comm, phase=phase)


def _init_state(sc: Scenario, n: int, seed: int,
               statics: PopStatics) -> PopState:
    """Every client starts training at t=0 (availability-gated) from
    version 0, duration draw 0."""
    fns = make_behavior_fns(sc, seed, statics.speed.device)
    dev = statics.speed.device
    cids = torch.arange(n, dtype=torch.int32, device=dev)
    zi = torch.zeros(n, dtype=torch.int32, device=dev)
    start = fns.gate(statics.phase, torch.zeros(n, device=dev))
    dur = fns.duration(cids, zi, start, statics.speed, statics.comm)
    scalar_i = torch.zeros((), dtype=torch.int32, device=dev)
    return PopState(t_next=start + dur, k_next=zi, batch_k=zi.clone(),
                    base_version=zi.clone(), version=scalar_i,
                    now=torch.zeros((), device=dev),
                    num_events=scalar_i.clone())


def make_window_step(sc: Scenario, fl: FLConfig, n: int, seed: int,
                     device: torch.device, syncs) -> Callable:
    """One K-upload window over device tensors.

    ``window_step(statics, state) -> (new_state, win)``: ``win`` holds the
    (K,) window in host-heap order, ``cids`` (int64), ``taus`` f32,
    ``slots`` (ring rows, int64), ``bk0`` (pre-advance train-batch
    counters, int32) and ``t`` (upload times, f32). Semantics match
    ``run_vectorized``'s ``collect_window`` and trigger bookkeeping event for
    event. ``state`` is not modified. ``syncs`` (an ``obs`` counter) counts
    the host's reads: the re-entry flag, one per drop-chain loop pass, one
    per pass of the exact walk.
    """
    fns = make_behavior_fns(sc, seed, device)
    k = fl.buffer_size
    ring_depth = fl.max_staleness + 1
    max_stal = fl.max_staleness
    m = fl.local_steps
    cids_all = torch.arange(n, dtype=torch.int64, device=device)
    force_exact = k > n

    def read(x: torch.Tensor):
        """A scalar read from the device, counted."""
        syncs.inc()
        return x.item()

    def select(idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """``idx[mask]``, whose length the host reads from the device."""
        syncs.inc()
        return idx[mask]

    def _advance(statics, cid, t, ki):
        """Reschedule after attempt ``ki``: gate, then draw ``ki + 1``."""
        s = fns.gate(statics.phase[cid], t)
        return s + fns.duration(cid.to(torch.int32), ki + 1, s,
                                statics.speed[cid], statics.comm[cid])

    def _chains(statics, cid, t, ki, more):
        """Follow drop chains: while ``more(cid, t, k)`` holds, the pending
        attempt is lost and the client reschedules. Returns ``(t, k, drops)``
        per client. Only the clients still in a chain are recomputed; each
        pass reads how many remain."""
        t, ki = t.clone(), ki.clone()
        nd = torch.zeros_like(ki)
        idx = select(torch.arange(len(cid), device=device),
                          more(cid, t, ki))
        while idx.numel():
            c = cid[idx]
            t_new = _advance(statics, c, t[idx], ki[idx])
            k_new = ki[idx] + 1
            t[idx], ki[idx] = t_new, k_new
            nd[idx] += 1
            idx = select(idx, more(c, t_new, k_new))
        return t, ki, nd

    def _peek(statics, cid, t, ki):
        """Next ACCEPTED upload of each client: ``(t, k, drops consumed)``.
        Pure: counter draws are random-access."""
        if not fns.has_drops:
            return t, ki, torch.zeros_like(ki)
        return _chains(statics, cid, t, ki,
                       lambda c, t_, k_: fns.dropped(c.to(torch.int32), k_))

    def _exact(st: PopState, statics: PopStatics):
        """The host event loop over device tensors: pop the lexicographically
        smallest (t, cid) pending event until K uploads are accepted. A pass
        runs K - accepted events (never more than the window needs), then
        reads the accepted count."""
        v = st.version
        t_next, k_next = st.t_next.clone(), st.k_next.clone()
        batch_k, bv = st.batch_k.clone(), st.base_version.clone()
        nev = st.num_events.clone()
        count = torch.zeros(1, dtype=torch.int64, device=device)
        w_c = torch.zeros(k, dtype=torch.int64, device=device)
        w_tau = torch.zeros(k, device=device)
        w_slot = torch.zeros(k, dtype=torch.int64, device=device)
        w_bk = torch.zeros(k, dtype=torch.int32, device=device)
        w_t = torch.zeros(k, device=device)
        remaining = k
        while remaining:
            for _ in range(remaining):
                i = torch.argmin(_sort_key(t_next, cids_all)).reshape(1)
                t, ki = t_next[i], k_next[i]
                acc = ~fns.dropped(i.to(torch.int32), ki)
                t_next[i] = _advance(statics, i, t, ki)
                k_next[i] = ki + 1
                bvi = bv[i]
                bvi = torch.where(bvi < v - max_stal, v, bvi)
                w_c[count] = torch.where(acc, i, w_c[count])
                w_tau[count] = torch.where(acc, (v - bvi).float(),
                                           w_tau[count])
                w_slot[count] = torch.where(
                    acc, torch.remainder(bvi, ring_depth).long(),
                    w_slot[count])
                w_bk[count] = torch.where(acc, batch_k[i], w_bk[count])
                w_t[count] = torch.where(acc, t, w_t[count])
                batch_k[i] = batch_k[i] + torch.where(acc, m, 0).to(
                    torch.int32)
                bv[i] = v  # a drop AND a non-trigger accept re-pull v
                nev = nev + 1
                count = count + acc.long()
            remaining = k - read(count[0])
        bv[w_c[k - 1:]] = v + 1  # the K-th upload pulls the NEW version
        new_st = PopState(t_next=t_next, k_next=k_next, batch_k=batch_k,
                          base_version=bv, version=v + 1, now=w_t[k - 1],
                          num_events=nev)
        return new_st, {"cids": w_c, "taus": w_tau, "slots": w_slot,
                        "bk0": w_bk, "t": w_t}

    def window_step(statics: PopStatics, st: PopState):
        if force_exact:
            return _exact(st, statics)
        v = st.version
        t_acc, k_acc, nd_pre = _peek(statics, cids_all, st.t_next, st.k_next)
        # the K smallest accepted (t, cid): one unique int64 key per
        # client, so the selection is exact and ties go to the lower cid
        _, sel = torch.topk(_sort_key(t_acc, cids_all), k, largest=False,
                            sorted=True)
        t_sel = t_acc[sel]
        t_w, trig = t_sel[k - 1], sel[k - 1:]  # (1,): a tensor index
        # staleness bookkeeping, host order: an in-window drop re-pulled v
        # first; then the ring resync check
        bv = st.base_version[sel]
        bv = torch.where(nd_pre[sel] > 0, v, bv)
        bv = torch.where(bv < v - max_stal, v, bv)
        taus = (v - bv).float()
        slots = torch.remainder(bv, ring_depth).long()
        bk0 = st.batch_k[sel]
        k_sel = k_acc[sel] + 1
        # post-accept reschedule, then the re-entry check: if a selected
        # client's NEXT accepted upload lands before the trigger event, the
        # host walk would have put it IN this window: take the exact path
        t_re = _advance(statics, sel, t_sel, k_acc[sel])
        t_acc2, _, _ = _peek(statics, sel, t_re, k_sel)
        reenter = torch.any((t_acc2 < t_w) | ((t_acc2 == t_w) & (sel < trig)))
        if read(reenter):
            return _exact(st, statics)
        t_next, k_next = st.t_next.clone(), st.k_next.clone()
        batch_k, base_version = st.batch_k.clone(), st.base_version.clone()
        t_next[sel] = t_re
        k_next[sel] = k_sel
        batch_k[sel] += m
        base_version[sel] = v
        nev = st.num_events + k + torch.sum(nd_pre[sel]).to(torch.int32)
        if fns.has_drops:
            # consume every remaining drop with event order <= the trigger
            # (the host walk popped those this window)
            def more(c, t_, k_):
                before = (t_ < t_w) | ((t_ == t_w) & (c < trig))
                return before & fns.dropped(c.to(torch.int32), k_)

            t_next, k_next, nd_post = _chains(statics, cids_all, t_next,
                                              k_next, more)
            base_version = torch.where(nd_post > 0, v, base_version)
            nev = nev + torch.sum(nd_post).to(torch.int32)
        base_version[trig] = v + 1
        new_st = PopState(t_next=t_next, k_next=k_next, batch_k=batch_k,
                          base_version=base_version, version=v + 1, now=t_w,
                          num_events=nev)
        return new_st, {"cids": sel, "taus": taus, "slots": slots,
                        "bk0": bk0, "t": t_sel}

    return window_step


# ---------------------------------------------------------------------------
# device data pool
# ---------------------------------------------------------------------------


class DevicePool(NamedTuple):
    """All clients' samples as one pool, gathered on the run's device.

    ``x``/``y`` are the concatenated sample arrays; client ``cid`` owns rows
    ``[offsets[cid], offsets[cid] + sizes[cid])``. Batch indices are counter
    draws (``_TAG_TRAIN``/``_TAG_PROBE``), so a window's batches are one
    gather on the device. ``shared`` overlaps client slices on a small pool:
    the layout that keeps a 1e6-client run in flat memory. The fields are
    numpy arrays or tensors; ``run_population`` moves them to its device
    (``to`` places them there once for several runs).
    """

    x: Any        # (P, ...) features
    y: Any        # (P,) labels
    offsets: Any  # (N,) i32 first row per client
    sizes: Any    # (N,) i32 rows per client

    @property
    def num_clients(self) -> int:
        return int(self.offsets.shape[0])

    def to(self, device: DeviceLike) -> "DevicePool":
        """The pool as tensors on ``device`` (a no-op for tensors there)."""
        dev = torch.device(device)
        return DevicePool(*(torch.as_tensor(a).to(dev) for a in self))

    @staticmethod
    def from_clients(clients: Sequence[ClientDataset]) -> "DevicePool":
        """Concatenate per-client datasets (the small-N parity path)."""
        sizes = np.asarray([c.size for c in clients], np.int32)
        offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
        return DevicePool(
            x=np.concatenate([np.asarray(c.x) for c in clients]),
            y=np.concatenate([np.asarray(c.y) for c in clients]),
            offsets=offsets, sizes=sizes)

    @staticmethod
    def shared(x: np.ndarray, y: np.ndarray, num_clients: int,
               samples_per_client: int) -> "DevicePool":
        """N overlapping client slices over one fixed pool: O(pool) memory
        independent of N (a prime-stride walk decorrelates neighbors)."""
        total = int(np.asarray(x).shape[0])
        if samples_per_client > total:
            raise ValueError(f"samples_per_client {samples_per_client} "
                             f"exceeds pool size {total}")
        span = total - samples_per_client + 1
        offsets = (np.arange(num_clients, dtype=np.int64) * 7919) % span
        return DevicePool(x=x, y=y, offsets=offsets.astype(np.int32),
                          sizes=np.full(num_clients, samples_per_client,
                                        np.int32))


def _draw_indices(k_train: threefry.Key, k_probe: threefry.Key, cids,
                  bk0, offsets, sizes, m: int, b: int):
    """(K, M, B) train and (K, B) probe pool rows for a window's accepts.

    Train draws are counters ``bk0 .. bk0+M-1`` of the train stream; the
    probe is draw ``bk0 // M`` (the accept count) of its own stream, so the
    order host twins consume draws in cannot shift either stream."""
    kc_t = threefry.fold_in(k_train, cids)
    steps = bk0[:, None] + torch.arange(m, dtype=torch.int32,
                                        device=bk0.device)
    key_t = threefry.fold_in(kc_t[:, None], steps)
    idx_t = threefry.randint(key_t, (b,), 0, sizes[:, None])
    key_p = threefry.fold_in(threefry.fold_in(k_probe, cids),
                             torch.div(bk0, m, rounding_mode="floor"))
    idx_p = threefry.randint(key_p, (b,), 0, sizes)
    return (offsets[:, None, None] + idx_t).long(), \
        (offsets[:, None] + idx_p).long()


# ---------------------------------------------------------------------------
# events only: the window machine without training
# ---------------------------------------------------------------------------


def init_population(scenario: Scenario, n: int, fl: FLConfig, seed: int = 0,
                    mesh: Optional[Any] = None,
                    device: DeviceLike = "cuda"
                    ) -> Tuple[PopStatics, PopState]:
    """Fresh statics and state of an N-client population on ``device``."""
    _no_mesh(mesh)
    dev = resolve_device(device)
    statics = _init_statics(scenario, n, seed, dev)
    return statics, _init_state(scenario, n, seed, statics)


def _pack_f32(*tensors: torch.Tensor) -> torch.Tensor:
    """One flat float32 tensor of 4-byte tensors (int32 as raw bits), so a
    fetch is one device-to-host copy."""
    return torch.cat([t.reshape(-1).view(torch.float32) for t in tensors])


def _unpack(flat: np.ndarray, like: Sequence[Tuple[Tuple[int, ...], Any]]):
    out, pos = [], 0
    for shape, dtype in like:
        size = int(np.prod(shape))
        out.append(flat[pos:pos + size].view(dtype).reshape(shape))
        pos += size
    return out


def collect_windows(scenario: Scenario, n: int, fl: FLConfig,
                    num_windows: int, seed: int = 0,
                    mesh: Optional[Any] = None,
                    statics: Optional[PopStatics] = None,
                    state: Optional[PopState] = None,
                    device: DeviceLike = "cuda",
                    registry: Optional[MetricsRegistry] = None
                    ) -> Dict[str, Any]:
    """Run ``num_windows`` windows of the device event machine (no training):
    host-order (T, K) arrays, the event count and sim time, and the final
    device ``state``. The windows come back in one fetch at the end; the
    window step's own reads count in ``registry``'s
    ``engine_host_syncs_total``, as the fetch does."""
    _no_mesh(mesh)
    dev = resolve_device(device)
    syncs = (registry if registry is not None
             else default_registry()).counter("engine_host_syncs_total")
    if statics is None or state is None:
        statics, state = init_population(scenario, n, fl, seed, device=dev)
    step = make_window_step(scenario, fl, n, seed, dev, syncs)
    wins = []
    for _ in range(num_windows):
        state, win = step(statics, state)
        wins.append(win)
    k = fl.buffer_size
    cat = {f: (torch.stack([w[f] for w in wins]) if wins else
               torch.zeros((0, k), device=dev)) for f in ("cids", "taus",
                                                          "slots", "t")}
    syncs.inc()
    flat = _pack_f32(cat["cids"].to(torch.int32), cat["taus"],
                     cat["slots"].to(torch.int32), cat["t"],
                     state.num_events, state.now).cpu().numpy()
    tk = (num_windows, k)
    c, tau, slots, t, nev, now = _unpack(flat, [
        (tk, np.int32), (tk, np.float32), (tk, np.int32), (tk, np.float32),
        ((), np.int32), ((), np.float32)])
    return {"clients": c.astype(np.int64), "tau": tau.astype(np.int64),
            "slots": slots.astype(np.int64), "t": t.astype(np.float64),
            "num_events": int(nev), "now": float(now), "state": state}


def host_walk_windows(behavior: ClientBehavior, fl: FLConfig,
                      num_windows: int) -> Dict[str, Any]:
    """The engine's host event walk, events only (no data plane): the
    reference the device path is pinned against, and the baseline the
    population-scale benchmark measures speedup over."""
    n = behavior.num_clients
    k = fl.buffer_size
    ring_depth = fl.max_staleness + 1
    base_version = np.zeros(n, np.int64)
    version = 0
    num_events = 0
    events = []
    for cid in range(n):
        start = behavior.next_start(cid, 0.0)
        events.append((start + behavior.duration(cid, start), cid))
    heapq.heapify(events)

    def reschedule(cid, t):
        start = behavior.next_start(cid, t)
        heapq.heappush(events, (start + behavior.duration(cid, start), cid))

    out_c = np.zeros((num_windows, k), np.int64)
    out_tau = np.zeros((num_windows, k), np.int64)
    out_slot = np.zeros((num_windows, k), np.int64)
    out_t = np.zeros((num_windows, k), np.float64)
    now = 0.0
    for w in range(num_windows):
        filled = 0
        while filled < k:
            t, cid = heapq.heappop(events)
            num_events += 1
            _, lost = behavior.next_upload(cid)
            if lost:
                base_version[cid] = version
                reschedule(cid, t)
                continue
            bv = int(base_version[cid])
            if bv < version - fl.max_staleness:
                bv = version
                base_version[cid] = version
            out_c[w, filled] = cid
            out_tau[w, filled] = version - bv
            out_slot[w, filled] = bv % ring_depth
            out_t[w, filled] = t
            filled += 1
            if filled < k:
                base_version[cid] = version
                reschedule(cid, t)
        version += 1
        now = out_t[w, k - 1]
        trig = int(out_c[w, k - 1])
        base_version[trig] = version
        reschedule(trig, now)
    return {"clients": out_c, "tau": out_tau, "slots": out_slot, "t": out_t,
            "num_events": num_events, "now": float(now)}


# ---------------------------------------------------------------------------
# host twins: the SAME counter streams, consumed by the host engine
# ---------------------------------------------------------------------------

_BLOCK = 8  # draws per client computed at once by a host twin


class CounterBehavior(ClientBehavior):
    """Host ``ClientBehavior`` drawing from the population engine's counter
    streams (threefry ``fold_in`` by ``(cid, k)``) instead of per-client
    PCG64 generators.

    Drives ``run_vectorized``'s host event walk with the exact draws the
    device engine uses. The statics, the lognormal draws and the drop
    verdicts are computed on ``device`` with the engine's own functions, the
    draws ``_BLOCK`` counters at a time for every client; the gate and a
    duration's last arithmetic run per event on the CPU. Both are IEEE
    operations, which give the device's bits on any device.

    The device clock is float32: ``duration(cid, t)`` returns the float64
    difference that lands ``t + duration`` on the device's float32 sum
    ``t + d``, so the host walk's times are the device's, bit for bit. Its
    checkpoint state is counters only (``get_state`` packs no PCG64 rows).
    """

    def __init__(self, scenario: Scenario, num_clients: int, seed: int = 0,
                 device: DeviceLike = "cuda"):
        super().__init__(scenario, num_clients, seed)
        self._device = resolve_device(device)
        self._fns = make_behavior_fns(scenario, int(seed), self._device)
        self._cpu_fns = make_behavior_fns(scenario, int(seed),
                                          torch.device("cpu"))
        statics = _init_statics(scenario, int(num_clients), int(seed),
                               self._device)
        # replace the PCG64-drawn statics with the device population's
        self._statics = PopStatics(*(s.cpu() for s in statics))
        self.speed = self._statics.speed.numpy().astype(np.float64)
        self.comm = self._statics.comm.numpy().astype(np.float64)
        self.phase = self._statics.phase.numpy().astype(np.float64)
        self._dur_rng = self._drop_rng = None  # PCG64 streams retired
        self._blocks: Dict[Tuple[str, int], np.ndarray] = {}

    def _block(self, what: str, cid: int, k: int):
        b = k // _BLOCK
        if (what, b) not in self._blocks:
            dev = self._device
            cids = torch.arange(self.num_clients, dtype=torch.int32,
                                device=dev)[:, None]
            ks = torch.arange(b * _BLOCK, (b + 1) * _BLOCK,
                              dtype=torch.int32, device=dev)[None, :]
            fn = self._fns.draw if what == "draw" else self._fns.dropped
            self._blocks[what, b] = fn(cids, ks).cpu().numpy()
        return self._blocks[what, b][cid, k % _BLOCK]

    def next_start(self, cid: int, t: float) -> float:
        if not self.scenario.diurnal:
            return t
        # f32 gate, like the device: the host clock holds f32 values
        return float(self._cpu_fns.gate(self._statics.phase[cid:cid + 1],
                                        torch.tensor([t], dtype=torch.float32)))

    def duration(self, cid: int, t: float = 0.0) -> float:
        if self._replay_dur is not None:
            return super().duration(cid, t)
        k = len(self._durations[cid])
        s = torch.tensor([t], dtype=torch.float32)
        d = self._cpu_fns.finish(
            torch.tensor([self._block("draw", cid, k)]),
            torch.tensor([cid], dtype=torch.int32), s,
            self._statics.speed[cid:cid + 1], self._statics.comm[cid:cid + 1])
        dur = float(s + d) - t
        self._durations[cid].append(dur)
        return dur

    def next_upload(self, cid: int) -> Tuple[int, bool]:
        k = int(self._upload_idx[cid])
        self._upload_idx[cid] += 1
        if self._replay_drops is not None:
            hit = (cid, k) in self._replay_drops
        elif self._fns.has_drops:
            hit = bool(self._block("drop", cid, k))
        else:
            hit = False
        if hit:
            self._drops.append((cid, k))
        return k, hit

    # -- checkpointing: counters ARE the whole stream state -------------
    def get_state(self) -> Dict[str, np.ndarray]:
        return {"upload_idx": self._upload_idx.copy(),
                "draw_counts": np.asarray([len(d) for d in self._durations],
                                          np.int64)}

    def set_state(self, state: Dict[str, np.ndarray]) -> None:
        upload_idx = np.asarray(state["upload_idx"], np.int64)
        if len(upload_idx) != self.num_clients:
            raise ValueError(f"state has {len(upload_idx)} clients, "
                             f"behavior has {self.num_clients}")
        self._upload_idx = upload_idx.copy()
        counts = np.asarray(state["draw_counts"], np.int64)
        self._durations = [[float("nan")] * int(c) for c in counts]
        self._drops = []


@functools.lru_cache(maxsize=None)
def _index_keys(seed: int) -> Tuple[threefry.Key, threefry.Key]:
    cpu = torch.device("cpu")
    return (_stream_key(seed, _TAG_TRAIN, cpu),
            _stream_key(seed, _TAG_PROBE, cpu))


def _host_indices(seed: int, stream: int, cid: int, k0: int, count: int,
                  batch_size: int, size: int) -> np.ndarray:
    """(count * B,) row indices: draws ``k0 .. k0+count-1`` of ``cid``'s
    train (0) or probe (1) stream, each a (B,) ``randint`` in [0, size)."""
    key = threefry.fold_in(_index_keys(seed)[stream], cid)
    key = threefry.fold_in(key, torch.arange(k0, k0 + count,
                                             dtype=torch.int32))
    return threefry.randint(key, (batch_size,), 0, size).reshape(-1).numpy()


@dataclasses.dataclass
class CounterDataset(ClientDataset):
    """Host twin of the device pool's batch sampling.

    Train batches (``batches``) and probe batches (``batch``) consume
    separate counter streams: order-independent, so the engine's
    probes-after-all-train-draws convention and the device's per-accept
    draws index identically even when a client appears twice in one window.
    The draws are integer arithmetic, identical on every device; they run
    on the CPU. Checkpoint state is the two counters (no PCG64).
    """

    cid: int = 0
    stream_seed: int = 0

    def __post_init__(self):
        super().__post_init__()
        self._k_train = 0
        self._k_probe = 0

    def batch_indices(self, batch_size: int) -> np.ndarray:
        raise NotImplementedError(
            "CounterDataset draws are stream-specific: use batch() "
            "(probe stream) or batches() (train stream)")

    def batches(self, batch_size: int, count: int):
        idx = _host_indices(self.stream_seed, 0, self.cid, self._k_train,
                            count, batch_size, self.size)
        self._k_train += count
        return (self.x[idx].reshape(count, batch_size, *self.x.shape[1:]),
                self.y[idx].reshape(count, batch_size, *self.y.shape[1:]))

    def batch(self, batch_size: int):
        idx = _host_indices(self.stream_seed, 1, self.cid, self._k_probe, 1,
                            batch_size, self.size)
        self._k_probe += 1
        return self.x[idx], self.y[idx]

    def rng_state(self) -> np.ndarray:
        return np.asarray([self._k_train, self._k_probe, 0, 0, 0, 0],
                          np.uint64)

    def set_rng_state(self, row: np.ndarray) -> None:
        row = np.asarray(row).reshape(-1)
        self._k_train = int(row[0])
        self._k_probe = int(row[1])


def make_counter_clients(clients: Sequence[ClientDataset],
                         seed: int = 0) -> List[CounterDataset]:
    """Wrap existing per-client datasets as counter-stream twins of the
    ``DevicePool.from_clients`` sampling (shares the x/y arrays)."""
    return [CounterDataset(x=c.x, y=c.y, seed=c.seed, cid=i,
                           stream_seed=seed)
            for i, c in enumerate(clients)]


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------


class PopulationEngineState(NamedTuple):
    """Host snapshot of a ``run_population`` run at a round boundary.

    The client state machine is four plain ``(N,)`` arrays and three
    scalars (``PopState``): counter-based RNG means there is NO generator
    state to pack. Statics are not stored: they are a pure function of
    (scenario, n, seed). The layout is the JAX package's, so a snapshot
    written by either package resumes in the other."""

    version: int
    now: float
    num_events: int
    t_next: np.ndarray        # (N,) f32
    k_next: np.ndarray        # (N,) i32
    batch_k: np.ndarray       # (N,) i32
    base_version: np.ndarray  # (N,) i32
    params: Any               # nested dict of numpy arrays
    ring: Any                 # codec host state: (R, n_padded) f32 for the
    # f32 codec, a codec-stamped dict of arrays for int8/delta
    history: List[Dict]
    round_log: List[Dict]


def population_state_to_tree(state: PopulationEngineState) -> Dict[str, Any]:
    """PopulationEngineState -> nested dict of plain arrays (npz-safe)."""
    return {
        "meta": {"version": np.int64(state.version),
                 "now": np.float64(state.now),
                 "num_events": np.int64(state.num_events)},
        "t_next": np.asarray(state.t_next, np.float32),
        "k_next": np.asarray(state.k_next, np.int32),
        "batch_k": np.asarray(state.batch_k, np.int32),
        "base_version": np.asarray(state.base_version, np.int32),
        "params": state.params,
        "ring": (dict(state.ring) if isinstance(state.ring, dict)
                 else np.asarray(state.ring, np.float32)),
        "round_log": round_log_to_arrays(state.round_log),
        "history": history_to_arrays(state.history),
    }


def population_state_from_tree(tree: Dict[str, Any]) -> PopulationEngineState:
    """Inverse of ``population_state_to_tree``."""
    return PopulationEngineState(
        version=int(tree["meta"]["version"]),
        now=float(tree["meta"]["now"]),
        num_events=int(tree["meta"]["num_events"]),
        t_next=np.asarray(tree["t_next"], np.float32),
        k_next=np.asarray(tree["k_next"], np.int32),
        batch_k=np.asarray(tree["batch_k"], np.int32),
        base_version=np.asarray(tree["base_version"], np.int32),
        params=tree["params"],
        ring=(dict(tree["ring"]) if isinstance(tree["ring"], dict)
              else np.asarray(tree["ring"], np.float32)),
        history=history_from_arrays(tree["history"]),
        round_log=round_log_from_arrays(tree["round_log"]),
    )


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _card_numerics(dev: torch.device) -> Iterator[None]:
    """On CUDA: TF32 off and cuDNN deterministic, without autotuning, so a
    run and its resume choose the same convolution algorithms; the previous
    flags come back on exit. Nothing changes on the CPU."""
    if dev.type != "cuda":
        yield
        return
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic,
             cudnn.benchmark)
    try:
        cudnn.allow_tf32 = matmul.allow_tf32 = False
        cudnn.deterministic, cudnn.benchmark = True, False
        yield
    finally:
        (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic,
         cudnn.benchmark) = saved


def run_population(loss_fn: Callable, init_params: Any,
                   data: Any, fl: FLConfig, total_rounds: int,
                   eval_fn: Optional[Callable[[Any], Dict]] = None,
                   eval_every: int = 5,
                   scenario: Optional[Scenario] = None,
                   seed: int = 0,
                   latency: Optional[Any] = None,
                   rounds_per_launch: int = 8,
                   mesh: Optional[Any] = None,
                   shard_ring: bool = True,
                   init_state: Optional[PopulationEngineState] = None,
                   capture_state: bool = False,
                   registry: Optional[MetricsRegistry] = None,
                   tracer: Optional[Tracer] = None,
                   device: DeviceLike = "cuda") -> SimResult:
    """Simulate buffered-async FL with the client state machine resident on
    ``device`` (CUDA unless asked otherwise; see the module docstring).

    ``data`` is a ``DevicePool`` or a sequence of ``ClientDataset`` (then
    pooled by ``DevicePool.from_clients``: batches are drawn on the counter
    streams, matching ``CounterDataset`` twins rather than the PCG64
    ``ClientDataset`` draws). Scenario-driven only: behaviors, traces and
    ``LatencyModel`` stay on the host engine. Each round is one window, the
    pool gather of its K clients' batches, and the shared ring round
    (``make_ring_round``: K1, or K2 + K3, or K4 + K3 under a kernel mode);
    a chunk of up to ``rounds_per_launch`` rounds counts as one launch.

    Host reads: the window step's (at least one a round, see the module
    docstring), one per eval (the sim time), one round-log fetch at the end
    and one for ``capture_state``; all count in ``engine_host_syncs_total``
    (``registry``, default ``obs.default_registry()``). ``tracer`` records
    the spans ``apply``, ``host_sync`` and ``checkpoint``.

    On the card the run sets TF32 off (the config is f32) and cuDNN
    deterministic without autotuning, and puts the caller's flags back at
    the end (``_card_numerics``). ``capture_state=True`` attaches a
    ``PopulationEngineState`` to ``SimResult.final_state``; passing it back
    as ``init_state`` (same loss/pool/config/seed/device) resumes
    bit-identically to the uninterrupted run.
    ``total_rounds`` counts from round 0, as in ``run_vectorized``.
    ``mesh``/``shard_ring`` are the JAX signature's: a mesh raises until the
    distributed substrate is ported (Slice E).
    """
    if latency is not None:
        raise ValueError("run_population is scenario-driven; LatencyModel "
                         "populations need the host engine "
                         "(engine='vectorized')")
    _no_mesh(mesh)
    dev = resolve_device(device)
    with _card_numerics(dev):
        sc = scenario if scenario is not None else Scenario(
            name="population-default",
            description="heterogeneous lognormal population")
        pool = data if isinstance(data, DevicePool) else \
            DevicePool.from_clients(data)
        n = pool.num_clients
        k = fl.buffer_size
        m, b = fl.local_steps, fl.batch_size
        ring_depth = fl.max_staleness + 1

        reg = registry if registry is not None else default_registry()
        tr = tracer if tracer is not None else NULL_TRACER
        dispatches = reg.counter("engine_dispatches_total")
        launch_hist = reg.histogram("engine_launch_seconds")
        syncs = reg.counter("engine_host_syncs_total")
        dispatches_start = dispatches.value

        pool_x, pool_y, offsets, sizes = pool.to(dev)
        offsets, sizes = offsets.to(torch.int32), sizes.to(torch.int32)
        statics = _init_statics(sc, n, seed, dev)
        window_step = make_window_step(sc, fl, n, seed, dev, syncs)
        k_train = _stream_key(seed, _TAG_TRAIN, dev)
        k_probe = _stream_key(seed, _TAG_PROBE, dev)

        def to_device(tree):
            return tree_map(
                lambda v: torch.as_tensor(v).to(dev, copy=True), tree)

        # ---- init / resume -----------------------------------------------
        if init_state is None:
            params = to_device(init_params)
            spec, ring = init_version_ring(params, fl)
            state = _init_state(sc, n, seed, statics)
            version = 0
            history: List[Dict] = []
            round_log_prefix: List[Dict] = []
        else:
            if len(init_state.base_version) != n:
                raise ValueError(
                    f"checkpoint has {len(init_state.base_version)} clients, "
                    f"this run has {n}")
            params = to_device(init_state.params)
            spec, ring = init_version_ring(params, fl, rows=init_state.ring)
            version = init_state.version

            def place(arr, dtype):
                return torch.from_numpy(np.array(arr, dtype)).to(dev)

            state = PopState(
                t_next=place(init_state.t_next, np.float32),
                k_next=place(init_state.k_next, np.int32),
                batch_k=place(init_state.batch_k, np.int32),
                base_version=place(init_state.base_version, np.int32),
                version=place(version, np.int32),
                now=place(init_state.now, np.float32),
                num_events=place(init_state.num_events, np.int32))
            history = [dict(h) for h in init_state.history]
            if eval_fn and history and history[-1]["round"] == version \
                    and version % eval_every:
                # drop the snapshot run's trailing forced eval (off-cadence) so
                # the resumed history matches the uninterrupted run
                history.pop()
            round_log_prefix = [dict(r) for r in init_state.round_log]
        ring_round = make_ring_round(loss_fn, fl, dev, spec)

        def maybe_eval(force=False):
            if eval_fn is None or not (force or version % eval_every == 0):
                return
            with tr.span(SPAN_HOST_SYNC, what="eval", version=version):
                syncs.inc()
                now = float(state.now)
            record_eval(history, eval_fn, version, now, params, eval_every,
                        force)

        def one_round(params, ring, st, new_slot):
            st, win = window_step(statics, st)
            cids = win["cids"]
            idx_t, idx_p = _draw_indices(
                k_train, k_probe, cids.to(torch.int32), win["bk0"],
                offsets[cids], sizes[cids], m, b)
            params, ring, info = ring_round(
                params, ring, win["slots"], (pool_x[idx_t], pool_y[idx_t]),
                (pool_x[idx_p], pool_y[idx_p]), sizes[cids].to(torch.float32),
                win["taus"], new_slot)
            out = torch.cat([torch.stack([info[f] for f in _LOG_FIELDS]),
                             win["taus"][None]])  # (fields + tau, K)
            return params, ring, st, out, cids.to(torch.int32)

        pending: List[Tuple[torch.Tensor, torch.Tensor]] = []  # per round
        if init_state is None:
            maybe_eval(force=True)
        while version < total_rounds:
            horizon = total_rounds - version
            if eval_fn:
                horizon = min(horizon, eval_every - version % eval_every)
            s = min(rounds_per_launch, horizon)
            with tr.span(SPAN_APPLY, rounds=s, version=version):
                t0 = time.perf_counter()
                dispatches.inc()
                for j in range(s):
                    params, ring, state, out, cids = one_round(
                        params, ring, state, (version + j + 1) % ring_depth)
                    pending.append((out, cids))
                launch_hist.observe(time.perf_counter() - t0)
            # the host mirrors `version` deterministically: no read needed
            version += s
            maybe_eval()
        maybe_eval(force=True)

        # ---- one device-to-host fetch for the whole run's round log ------
        rounds = len(pending)
        fields = len(_LOG_FIELDS) + 1
        with tr.span(SPAN_HOST_SYNC, what="round_log", launches=rounds):
            syncs.inc()
            outs = (torch.stack([o for o, _ in pending]) if pending
                    else torch.zeros((0, fields, k), device=dev))
            cids = (torch.stack([c for _, c in pending]) if pending
                    else torch.zeros((0, k), dtype=torch.int32, device=dev))
            flat = _pack_f32(outs, cids, state.num_events,
                             state.now).cpu().numpy()
        outs, cids, nev, now = _unpack(flat, [
            ((rounds, fields, k), np.float32), ((rounds, k), np.int32),
            ((), np.int32), ((), np.float32)])
        logs = {f: outs[:, i] for i, f in enumerate(_LOG_FIELDS)}
        round_log = list(round_log_prefix)
        round_log.extend(round_log_rows(version - rounds, k, cids, outs[:, -1],
                                        logs))
        now, num_events = float(now), int(nev)

        final_state = None
        if capture_state:
            with tr.span(SPAN_CHECKPOINT, version=version):
                syncs.inc()
                final_state = PopulationEngineState(
                    version=version, now=now, num_events=num_events,
                    t_next=state.t_next.cpu().numpy(),
                    k_next=state.k_next.cpu().numpy(),
                    batch_k=state.batch_k.cpu().numpy(),
                    base_version=state.base_version.cpu().numpy(),
                    params=tree_map(lambda t: t.detach().cpu().numpy(),
                                    params),
                    ring=ring_state_to_host(fl, ring),
                    history=[dict(h) for h in history],
                    round_log=[dict(r) for r in round_log])
        return SimResult(history=history, server_rounds=version, sim_time=now,
                         round_log=round_log, num_events=num_events,
                         num_launches=int(dispatches.value - dispatches_start),
                         final_params=params, final_state=final_state)
