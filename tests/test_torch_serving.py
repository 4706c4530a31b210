"""The port's always-on serving loop against the JAX package's, on the CPU.

The counterparts of ``tests/test_serving.py`` on ``repro_torch.core.serving``
and ``repro_torch.sim.arrivals``: admission control and backpressure, stale
drops, the ``retry_after`` clamp, adaptive K, the FedAsync family at tau = 0,
the serving aggregate against the exact ``apply_server_round`` for all 8
policies (rtol 2e-5 / atol 1e-6, the JAX test's), ``serve_stream``
determinism and dropout accounting, and the overload retry path. Then the
same scenario stream through the JAX and the port controllers for all 8
policies: the same counters, K trajectory and fold journal (exact), params
within rtol 2e-5 / atol 1e-6 (the same f32 maths in other reduction
orders); the copied ``sim/arrivals.py`` drawing the same uploads; the obs
registry behind the counters equal to JAX's (every series), and the round
spans covering >= 95% of the serving wall time.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JFL
from repro.core.serving import ServeConfig as JServeConfig
from repro.core.serving import ServingController as JController
from repro.core.serving import serve_stream as j_serve_stream
from repro.sim.arrivals import TrafficGenerator as JTraffic
from repro.sim.arrivals import draw_upload as j_draw_upload
from repro.sim.scenarios import get_scenario as j_scenario
from repro_torch.configs.base import FLConfig
from repro_torch.core import make_local_update_fn
from repro_torch.core.server_pass import (
    apply_server_round,
    flatten_stacked,
    flatten_tree,
    make_flat_spec,
    unflatten_like,
)
from repro_torch.core.serving import (
    ADMITTED,
    DROP_MAX_STALENESS,
    REJECT_QUEUE_FULL,
    ServeConfig,
    ServingController,
    Upload,
    serve_stream,
)
from repro_torch.core.weighting import (
    FEDASYNC_POLICIES,
    POLICIES,
    contribution_weights,
)
from repro_torch.sim.arrivals import TrafficGenerator, draw_upload
from repro_torch.sim.scenarios import get_scenario

PARAMS = {"w": np.array([1.0, -1.0, 0.5, 2.0], np.float32)}


def _quad_loss(params, batch):
    x, y = batch
    return torch.mean((x @ params["w"] - y) ** 2), {}


def _quad_batch(rng, n=8, d=4):
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (x @ np.arange(1.0, d + 1.0) + 0.01 * rng.normal(size=n)).astype(
        np.float32)
    return x, y


def _upload(ctrl, i, tau=0, t=0.0, size=10.0):
    """One deterministic quad-problem upload, staleness ``tau`` rounds."""
    rng = np.random.default_rng(i)
    b = _quad_batch(rng)
    return Upload(client_id=i, base_version=ctrl.version - tau,
                  data_size=size, batch=tuple(a[None] for a in b),
                  probe=_quad_batch(rng), sent_at=t)


def _controller(fl, cfg=ServeConfig(), params=PARAMS, loss=_quad_loss):
    return ServingController(loss, params, fl, cfg, device="cpu")


class TestAdmissionControl:
    def _ctrl(self, **kw):
        fl = FLConfig(buffer_size=4, local_steps=1, local_lr=0.1,
                      max_staleness=4)
        return _controller(fl, ServeConfig(**kw)), fl

    def test_backpressure_rejects_under_burst(self):
        ctrl, _ = self._ctrl(queue_capacity=4, service_time=0.25,
                             adapt_every=0, retry_after_min=0.1)
        outcomes = []
        for i in range(12):  # simultaneous burst: service can't drain
            outcomes.append(ctrl.offer(_upload(ctrl, i, t=0.0), now=0.0))
            ctrl.pump(0.0)
        rejected = [a for a in outcomes if not a.accepted]
        assert ctrl.counters["admitted"] == 4
        assert ctrl.counters["rejected_queue_full"] == len(rejected) == 8
        assert all(a.reason == REJECT_QUEUE_FULL for a in rejected)
        assert all(a.retry_after >= 0.1 for a in rejected)
        assert rejected[0].retry_after == pytest.approx(4 * 0.25)
        ctrl.pump(4 * 0.25)
        assert ctrl.counters["folded"] == 4
        assert ctrl.counters["rounds"] == 1

    def test_stale_uploads_dropped_with_counters(self):
        ctrl, fl = self._ctrl(queue_capacity=8, service_time=0.0,
                              adapt_every=0)
        ctrl.version = 10
        adm = ctrl.offer(_upload(ctrl, 0, tau=fl.max_staleness + 1), now=0.0)
        assert not adm.accepted and adm.reason == DROP_MAX_STALENESS
        assert adm.retry_after == 0.0
        assert ctrl.counters["dropped_stale_ingress"] == 1
        assert ctrl.offer(_upload(ctrl, 1, tau=fl.max_staleness),
                          now=0.0).accepted
        ctrl.version += 1  # the queue head is now too old
        ctrl.offer(_upload(ctrl, 2, tau=0), now=0.1)
        assert ctrl.counters["dropped_stale_queue"] == 1
        assert len(ctrl.queue) == 1

    def test_queue_capacity_validated(self):
        with pytest.raises(ValueError, match="queue_capacity"):
            self._ctrl(queue_capacity=0)
        with pytest.raises(ValueError, match="k_min"):
            self._ctrl(k_min=4, k_max=2)

    def test_retry_after_clamped_to_max(self):
        ctrl, _ = self._ctrl(queue_capacity=8, service_time=10.0,
                             adapt_every=0, retry_after_max=5.0)
        for i in range(8):
            assert ctrl.offer(_upload(ctrl, i, t=0.0), now=0.0).accepted
        adm = ctrl.offer(_upload(ctrl, 9, t=0.0), now=0.0)
        assert not adm.accepted and adm.reason == REJECT_QUEUE_FULL
        assert adm.retry_after == 5.0  # unclamped: 8 * 10.0


class TestAdaptiveK:
    def test_k_settles_to_arrival_rate_times_target(self):
        fl = FLConfig(buffer_size=4, local_steps=1, local_lr=0.1,
                      max_staleness=4)
        cfg = ServeConfig(queue_capacity=8, service_time=0.0,
                          target_round_latency=2.0, k_min=2, k_max=64,
                          adapt_every=2, adapt_gain=0.5, arrival_ewma=0.5)
        ctrl = _controller(fl, cfg)
        assert ctrl.k == 4
        gap = 0.125  # lambda = 8/s  ->  K* = 16
        for i in range(200):
            t = i * gap
            ctrl.offer(_upload(ctrl, i % 8, t=t), now=t)
            ctrl.pump(t)
        assert ctrl.k == 16
        assert ctrl.arrival_rate() == pytest.approx(8.0, rel=1e-3)
        cadence = np.diff(ctrl.round_times[-4:])
        np.testing.assert_allclose(cadence, 2.0, atol=0.15)
        assert ctrl.k_history[0] == (0, 4)
        assert ctrl.k_history[-1][1] == 16

    def test_fixed_k_when_adaptation_disabled(self):
        fl = FLConfig(buffer_size=4, local_steps=1, local_lr=0.1,
                      max_staleness=4)
        ctrl = _controller(fl, ServeConfig(adapt_every=0))
        for i in range(64):
            t = i * 0.01
            ctrl.offer(_upload(ctrl, i % 8, t=t), now=t)
            ctrl.pump(t)
        assert ctrl.k == 4 and ctrl.k_history == [(0, 4)]


class TestFedAsyncPolicies:
    def test_all_discounts_are_one_at_tau_zero(self):
        p, s, tau = torch.tensor([1.0, 2.0, 3.0]), torch.ones(3), \
            torch.zeros(3)
        fb = contribution_weights("fedbuff", p, s, tau, normalize="none")
        for policy in FEDASYNC_POLICIES:
            w = contribution_weights(policy, p, s, tau, normalize="none")
            torch.testing.assert_close(w, fb, rtol=1e-6, atol=0)

    @pytest.mark.parametrize("policy", list(FEDASYNC_POLICIES))
    def test_serving_loop_parity_with_fedbuff_at_tau_zero(self, policy):
        def run(weighting):
            fl = FLConfig(buffer_size=3, local_steps=1, local_lr=0.1,
                          max_staleness=4, weighting=weighting,
                          normalize="none")
            ctrl = _controller(fl, ServeConfig(adapt_every=0))
            for i in range(9):
                ctrl.offer(_upload(ctrl, i, t=float(i)), now=float(i))
                ctrl.pump(float(i))
            assert ctrl.counters["rounds"] == 3
            return ctrl.params["w"].numpy()

        np.testing.assert_allclose(run(policy), run("fedbuff"), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("policy", list(POLICIES))
def test_serving_matches_apply_server_round(policy):
    """The acceptance gate: serving-loop aggregate == apply_server_round on
    the same upload stream, every weighting policy."""
    k = 4
    fl = FLConfig(buffer_size=k, local_steps=1, local_lr=0.1,
                  weighting=policy, normalize="mean", global_lr=1.0,
                  max_staleness=k)
    ctrl = _controller(fl, ServeConfig(adapt_every=0, k_max=8))
    # seed the eq. 3 ring so staleness distances are non-trivial
    ctrl.update_norm_ring = torch.tensor([0.3, 0.2, 0.1, 0.05])
    local_update = make_local_update_fn(_quad_loss, 1, 0.1)
    taus, sizes = [0, 1, 2, 3], [10.0, 20.0, 30.0, 40.0]
    rng = np.random.default_rng(0)
    t = 0.0
    for rnd in range(3):
        x_tree, ring = ctrl.params, ctrl.update_norm_ring.clone()
        deltas, losses, batches = [], [], []
        for i in range(k):
            b, pb = _quad_batch(rng), _quad_batch(rng)
            stacked = tuple(a[None] for a in b)
            tb = tuple(torch.from_numpy(a) for a in stacked)
            deltas.append(local_update(x_tree, tb)[0]["w"])
            losses.append(_quad_loss(x_tree, tuple(
                torch.from_numpy(a) for a in pb))[0])
            batches.append((stacked, pb))
        for i, (stacked, pb) in enumerate(batches):
            t += 0.1
            up = Upload(client_id=i, base_version=ctrl.version - taus[i],
                        data_size=sizes[i], batch=stacked, probe=pb,
                        sent_at=t)
            assert ctrl.offer(up, now=t).reason == ADMITTED
            ctrl.pump(t)
        assert ctrl.version == rnd + 1  # the K-th fold applied eq. 5

        dists = torch.tensor([float(ring[:tt].sum()) for tt in taus])
        spec = make_flat_spec(x_tree)
        x = flatten_tree(spec, x_tree)
        bases = x[None] - torch.sqrt(dists)[:, None] * torch.eye(
            spec.n_padded)[:k]
        new_x, _ = apply_server_round(
            x, bases, flatten_stacked(spec, {"w": torch.stack(deltas)}),
            torch.stack(losses), torch.tensor(sizes),
            torch.tensor(taus, dtype=torch.float32), fl)
        np.testing.assert_allclose(
            ctrl.params["w"].numpy(), unflatten_like(spec, new_x)["w"].numpy(),
            rtol=2e-5, atol=1e-6, err_msg=f"policy={policy} round={rnd}")


def _flat_loss(params, batch):
    x, y = batch
    x = x.reshape(x.shape[0], -1)
    return torch.mean((x @ params["w"] - y.to(torch.float32)) ** 2), {}


def _j_flat_loss(params, batch):
    x, y = batch
    x = x.reshape(x.shape[0], -1)
    return jnp.mean((x @ params["w"] - y) ** 2), {}


class TestServeStream:
    def _run(self, scenario="dropout-bernoulli", seed=0, rounds=3):
        sc = get_scenario(scenario)
        n = 6
        clients, _ = sc.make_dataset(n, samples_per_client=16, seed=seed)
        fl = FLConfig(num_clients=n, buffer_size=3, max_staleness=6,
                      local_steps=1, batch_size=4)
        ctrl = _controller(fl, ServeConfig(queue_capacity=8),
                           params={"w": np.zeros(784, np.float32)},
                           loss=_flat_loss)
        gen = TrafficGenerator(clients, sc.behavior(n, seed=seed), fl)
        out = serve_stream(ctrl, gen, max_rounds=rounds)
        return out, ctrl.params["w"].numpy()

    def test_deterministic_under_seed(self):
        out1, w1 = self._run(seed=0)
        out2, w2 = self._run(seed=0)
        assert out1["folded"] == out2["folded"]
        assert out1["rounds"] == out2["rounds"]
        assert out1["lost_in_transit"] == out2["lost_in_transit"]
        np.testing.assert_array_equal(w1, w2)

    def test_dropouts_are_counted_not_folded(self):
        out, _ = self._run(scenario="dropout-bernoulli", rounds=4)
        assert out["lost_in_transit"] > 0
        assert out["folded"] + out["lost_in_transit"] <= out["events"]
        assert out["rounds"] == 4

    def test_requires_a_bound(self):
        ctrl = _controller(FLConfig(buffer_size=2, max_staleness=4))
        with pytest.raises(ValueError, match="max_rounds"):
            serve_stream(ctrl, object())


def test_rejections_reoffered_at_hint_with_same_payload():
    """Backpressure through TrafficGenerator: every queue_full rejection is
    re-offered after exactly the hinted delay with the SAME payload, and
    every offer lands in exactly one admission counter."""
    sc = get_scenario("paper-fig1")
    n = 4
    clients, _ = sc.make_dataset(n, samples_per_client=16, seed=0)
    fl = FLConfig(num_clients=n, buffer_size=2, max_staleness=100,
                  local_steps=1, batch_size=4)
    ctrl = _controller(fl, ServeConfig(queue_capacity=1, service_time=0.9,
                                       adapt_every=0, retry_after_min=0.05),
                       params={"w": np.zeros(784, np.float32)},
                       loss=_flat_loss)
    gen = TrafficGenerator(clients, sc.behavior(n, seed=0), fl)
    horizon = 40.0
    log = []
    while not gen.empty():
        t, cid = gen.pop()
        if t > horizon:
            break
        up = gen.realize(cid, t, ctrl.version)
        if up is None:
            continue
        adm = ctrl.offer(up, t)
        ctrl.pump(t)
        log.append((t, cid, up, adm))
        gen.settle(cid, t, adm, ctrl.version, up)
    rejections = [(i, e) for i, e in enumerate(log)
                  if e[3].reason == REJECT_QUEUE_FULL]
    assert len(rejections) >= 3, "config failed to provoke overload"
    for i, (t, cid, up, adm) in rejections:
        if t + adm.retry_after > horizon:
            continue
        later = [e for e in log[i + 1:] if e[1] == cid]
        assert later, f"rejection at t={t} never re-offered"
        rt, _, rup, _ = later[0]
        assert rup is up and rt == t + adm.retry_after
        assert rup.base_version == up.base_version
    c = ctrl.counters
    assert len(log) == (c["admitted"] + c["rejected_queue_full"]
                        + c["dropped_stale_ingress"])
    assert gen.retries == len(rejections)


def _journal(ctrl):
    folds = []
    ctrl.fold_hook = lambda up, tau: folds.append(
        (up.client_id, up.seq, up.base_version, tau))
    return folds


@pytest.mark.parametrize("policy", list(POLICIES))
def test_same_stream_through_jax_and_port_controllers(policy):
    """One seeded scenario stream through both controllers: a dropout
    scenario, a queue that fills (retries), stale drops at ingress and in
    the queue, and a K that adapts."""
    n = 8
    # a step size under the problem's curvature (a 784-wide linear model on
    # raw pixels): a diverging run would amplify f32 rounding round on round
    kw = dict(num_clients=n, buffer_size=3, max_staleness=2, local_steps=2,
              local_lr=0.002, batch_size=4, weighting=policy)
    cfg = dict(queue_capacity=2, service_time=0.5, adapt_every=2,
               target_round_latency=2.0)
    w0 = np.random.default_rng(0).normal(size=784).astype(np.float32) * 0.01
    outs = []
    for pkg in ("jax", "torch"):
        sc = (j_scenario if pkg == "jax" else get_scenario)(
            "dropout-bernoulli")
        clients, _ = sc.make_dataset(n, samples_per_client=32, seed=1)
        beh = sc.behavior(n, seed=1)
        if pkg == "jax":
            fl = JFL(**kw)
            ctrl = JController(_j_flat_loss, {"w": jnp.asarray(w0)}, fl,
                               JServeConfig(**cfg))
            folds = _journal(ctrl)
            out = j_serve_stream(ctrl, JTraffic(clients, beh, fl),
                                 max_rounds=4)
        else:
            fl = FLConfig(**kw)
            ctrl = _controller(fl, ServeConfig(**cfg), params={"w": w0},
                               loss=_flat_loss)
            folds = _journal(ctrl)
            out = serve_stream(ctrl, TrafficGenerator(clients, beh, fl),
                               max_rounds=4)
        outs.append((out, folds, np.asarray(ctrl.params["w"])))
    (j_out, j_folds, j_w), (t_out, t_folds, t_w) = outs
    assert t_folds == j_folds and len(t_folds) >= 4 * 2
    assert t_out["rejected_queue_full"] and t_out["dropped_stale_queue"] \
        and t_out["dropped_stale_ingress"] and len(t_out["k_history"]) > 1
    for key in ("admitted", "rejected_queue_full", "dropped_stale_ingress",
                "dropped_stale_queue", "folded", "rounds", "version", "k",
                "events", "lost_in_transit", "retries_scheduled",
                "queue_depth_max"):
        assert t_out[key] == j_out[key], key
    assert [tuple(e) for e in t_out["k_history"]] == \
        [tuple(e) for e in j_out["k_history"]]
    for key in ("round_latency_p50", "round_latency_p99", "arrival_rate"):
        assert t_out[key] == j_out[key], key
    np.testing.assert_allclose(t_w, j_w, rtol=2e-5, atol=1e-6)


def test_arrivals_copy_draws_the_same_uploads():
    """``draw_upload`` of both packages on their datasets: the same
    batches, probe, size and stamps, bit for bit."""
    j_clients, _ = j_scenario("paper-fig1").make_dataset(
        3, samples_per_client=20, seed=2)
    t_clients, _ = get_scenario("paper-fig1").make_dataset(
        3, samples_per_client=20, seed=2)
    jfl, tfl = JFL(batch_size=4, local_steps=3), FLConfig(batch_size=4,
                                                          local_steps=3)
    for seq in range(3):
        for cid in range(3):
            a = j_draw_upload(j_clients[cid], cid, jfl, base_version=seq,
                              t=0.5 * seq, seq=seq)
            b = draw_upload(t_clients[cid], cid, tfl, base_version=seq,
                            t=0.5 * seq, seq=seq)
            assert (a.client_id, a.base_version, a.data_size, a.sent_at,
                    a.seq) == (b.client_id, b.base_version, b.data_size,
                               b.sent_at, b.seq)
            for x, y in zip(a.batch + a.probe, b.batch + b.probe):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# the obs registry behind the counters, and the round spans
# ---------------------------------------------------------------------------

SERIES = {
    "admitted": "serve_admitted_total",
    "rejected_queue_full": "serve_rejected_total{reason=queue_full}",
    "dropped_stale_ingress": "serve_dropped_total{reason=stale_ingress}",
    "dropped_stale_queue": "serve_dropped_total{reason=stale_queue}",
    "folded": "serve_folded_total",
    "rounds": "serve_rounds_total",
}


def test_registry_mirrors_every_counter_as_jax_does():
    """A seeded stream that hits every admission outcome, through both
    packages' controllers on private registries: the same counters and the
    same registry snapshot (every series, gauges and histogram included)."""
    from repro.obs.metrics import MetricsRegistry as JRegistry
    from repro_torch.obs import MetricsRegistry

    snaps = []
    for pkg in ("jax", "torch"):
        fl_kw = dict(buffer_size=4, local_steps=1, local_lr=0.1,
                     max_staleness=4)
        cfg_kw = dict(queue_capacity=4, service_time=0.25, adapt_every=0,
                      retry_after_min=0.1)
        if pkg == "jax":
            reg = JRegistry()
            ctrl = JController(
                lambda p, b: (jnp.mean((b[0] @ p["w"] - b[1]) ** 2), {}),
                {"w": jnp.asarray(PARAMS["w"])}, JFL(**fl_kw),
                JServeConfig(**cfg_kw), registry=reg)
        else:
            reg = MetricsRegistry()
            ctrl = ServingController(_quad_loss, PARAMS, FLConfig(**fl_kw),
                                     ServeConfig(**cfg_kw), registry=reg,
                                     device="cpu")
        for i in range(8):  # burst past capacity: 4 admitted, 4 rejected
            ctrl.offer(_upload(ctrl, i, t=0.0), now=0.0)
            ctrl.pump(0.0)
        ctrl.pump(4 * 0.25)
        assert not ctrl.offer(_upload(ctrl, 0, tau=5), now=2.0).accepted
        assert ctrl.offer(_upload(ctrl, 1, tau=4), now=2.0).accepted
        ctrl.version += 1  # the queue head out-ages before service
        ctrl.offer(_upload(ctrl, 2, tau=0), now=2.1)
        snaps.append((dict(ctrl.counters), reg.snapshot(), ctrl.metrics()))
    (j_counters, j_snap, j_m), (t_counters, t_snap, t_m) = snaps
    assert t_counters == j_counters and all(t_counters.values())
    for key, series in SERIES.items():
        assert t_snap[series] == float(t_counters[key]), series
    assert t_snap.keys() == j_snap.keys()
    for key in j_snap:  # the latency histogram is on the sim clock
        assert t_snap[key] == j_snap[key], key
    assert set(t_m) == set(j_m) and isinstance(t_m["admitted"], int)


def test_round_spans_cover_the_serving_walltime():
    """serve_fl --trace-out's gate, in process: collect_window and apply
    spans tile >= 95% of the rounds' window; round_hook fires once a
    round."""
    from repro_torch.obs import (
        SPAN_NAMES,
        Tracer,
        span_coverage,
        validate_trace,
    )

    sc = get_scenario("paper-fig1")
    clients, _ = sc.make_dataset(8, samples_per_client=16, seed=0)
    fl = FLConfig(num_clients=8, buffer_size=3, max_staleness=6,
                  local_steps=1, batch_size=4)
    tracer = Tracer(annotate=False)
    ctrl = ServingController(_flat_loss, {"w": np.zeros(784, np.float32)},
                             fl, ServeConfig(queue_capacity=8),
                             tracer=tracer, device="cpu")
    versions = []
    serve_stream(ctrl, TrafficGenerator(clients, sc.behavior(8, seed=0), fl),
                 max_rounds=4, round_hook=versions.append)
    assert versions == [1, 2, 3, 4]
    doc = tracer.to_json()
    validate_trace(doc)
    names = {ev["name"] for ev in doc["traceEvents"]}
    assert {"collect_window", "contribute", "apply"} <= names <= set(
        SPAN_NAMES)
    assert span_coverage(doc) >= 0.95
