"""The population engine: the port's ``sim/population.py`` against the JAX
package's on the CPU, and against its own host twins.

Each test of ``tests/test_population.py`` has its counterpart here, plus
the cross-package pins. Tolerances: windows' clients, tau, slots and event
counts exact; window times within rtol 1e-5 / atol 1e-5 of JAX's (the JAX
test's own tolerance; the port draws JAX's bits, so they agree exactly in
practice) and bit for bit against the port's host walk (both run on the
float32 clock); statics within 1 ulp of JAX's; round logs of the engine
against ``run_vectorized`` over the counter twins within the JAX test's
rtol 1e-4 / atol 1e-6 (eq. 3-5 sum in another order), against the JAX
engine within rtol 1e-4 / atol 1e-6 (the two frameworks' float kernels);
resume bit-identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as j_save
from repro.configs.base import FLConfig as JFL
from repro.data.synthetic import ClientDataset as JData
from repro.sim import population as jpop
from repro.sim.scenarios import get_scenario as j_scenario
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs.base import FLConfig as TFL
from repro_torch.core import run_async
from repro_torch.data.synthetic import ClientDataset as TData
from repro_torch.obs import MetricsRegistry
from repro_torch.sim import get_scenario
from repro_torch.sim.engine import run_vectorized
from repro_torch.sim.population import (
    CounterBehavior,
    CounterDataset,
    DevicePool,
    collect_windows,
    host_walk_windows,
    init_population,
    make_counter_clients,
    population_state_from_tree,
    population_state_to_tree,
    run_population,
)
from repro_torch.sim.scenarios import LatencyModel

PRESETS = ["paper-fig1", "diurnal-phones", "dropout-bernoulli",
           "straggler-burst", "dropout-trace", "bandwidth-tiers"]
FL = dict(num_clients=6, buffer_size=3, local_steps=2, local_lr=0.05,
          batch_size=8, max_staleness=4)
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t_quad(params, batch):
    x, y = batch
    return torch.mean((x @ params["w"] - y) ** 2), {}


def _j_quad(params, batch):
    x, y = batch
    return jnp.mean((x @ params["w"] - y) ** 2), {}


def _quad_clients(cls=TData, n=6, size=64, d=4, seed=0):
    rng = np.random.default_rng(seed)
    w_true = np.arange(1.0, d + 1.0)
    out = []
    for i in range(n):
        x = rng.normal(size=(size, d)).astype(np.float32)
        y = (x @ w_true + 0.05 * rng.normal(size=size)).astype(np.float32)
        out.append(cls(x=x, y=y, seed=seed + 10 + i))
    return out


def _params(d=4):
    return {"w": torch.zeros(d)}


def _t_eval(params):
    return {"wnorm": float(torch.sum(params["w"] ** 2))}


def _j_eval(params):
    return {"wnorm": float(jnp.sum(params["w"] ** 2))}


def _fl(cls, n, k, **kw):
    return cls(num_clients=n, buffer_size=k, local_steps=2, local_lr=0.05,
               batch_size=8, max_staleness=4, **kw)


def _windows_equal(a, b, exact_t):
    np.testing.assert_array_equal(a["clients"], b["clients"])
    np.testing.assert_array_equal(a["tau"], b["tau"])
    np.testing.assert_array_equal(a["slots"], b["slots"])
    if exact_t:
        np.testing.assert_array_equal(a["t"], b["t"])
    else:
        np.testing.assert_allclose(a["t"], b["t"], rtol=1e-5, atol=1e-5)
    assert a["num_events"] == b["num_events"]


def _windows(preset, n, k, t, seed, registry=None):
    port = collect_windows(get_scenario(preset), n, _fl(TFL, n, k), t,
                           seed=seed, device=CPU, registry=registry)
    jax_w = jpop.collect_windows(j_scenario(preset), n, _fl(JFL, n, k), t,
                                 seed=seed)
    host = host_walk_windows(CounterBehavior(get_scenario(preset), n,
                                             seed=seed, device=CPU),
                             _fl(TFL, n, k), t)
    return port, jax_w, host


class TestEventParity:
    """Device top-k windows == JAX's device windows == the port's host heap
    walk on the same counter streams, across behavior models."""

    @pytest.mark.parametrize("preset", PRESETS)
    def test_presets(self, preset):
        port, jax_w, host = _windows(preset, 8, 3, 12, 3)
        _windows_equal(port, jax_w, exact_t=False)
        _windows_equal(port, host, exact_t=True)
        assert port["now"] == host["now"]

    @pytest.mark.parametrize("preset", ["paper-fig1", "dropout-bernoulli"])
    def test_reentry_windows(self, preset):
        # n barely above K: clients re-enter windows, forcing the exact
        # walk; its passes show up as host reads beyond one per window
        reg = MetricsRegistry()
        port, jax_w, host = _windows(preset, 4, 3, 12, 5, registry=reg)
        _windows_equal(port, jax_w, exact_t=False)
        _windows_equal(port, host, exact_t=True)
        assert reg.snapshot()["engine_host_syncs_total"] > 12 + 1

    def test_k_exceeds_n_forced_exact(self):
        port, jax_w, host = _windows("paper-fig1", 3, 5, 6, 1)
        _windows_equal(port, jax_w, exact_t=False)
        _windows_equal(port, host, exact_t=True)

    @pytest.mark.parametrize("preset", ["paper-fig1", "dropout-bernoulli",
                                        "diurnal-phones"])
    def test_host_walk_at_larger_n(self, preset):
        # 600 clients, K = 16: the fast path (top-k) carries every window
        n, k, t = 600, 16, 6
        port = collect_windows(get_scenario(preset), n, _fl(TFL, n, k), t,
                               seed=0, device=CPU)
        host = host_walk_windows(CounterBehavior(get_scenario(preset), n,
                                                 seed=0, device=CPU),
                                 _fl(TFL, n, k), t)
        _windows_equal(port, host, exact_t=True)

    def test_windows_resume_from_state(self):
        sc, fl = get_scenario("dropout-bernoulli"), _fl(TFL, 8, 3)
        full = collect_windows(sc, 8, fl, 10, seed=2, device=CPU)
        half = collect_windows(sc, 8, fl, 4, seed=2, device=CPU)
        statics, _ = init_population(sc, 8, fl, seed=2, device=CPU)
        rest = collect_windows(sc, 8, fl, 6, seed=2, device=CPU,
                               statics=statics, state=half["state"])
        np.testing.assert_array_equal(
            np.concatenate([half["clients"], rest["clients"]]),
            full["clients"])
        assert rest["num_events"] == full["num_events"]

    @pytest.mark.parametrize("preset", PRESETS + ["compute-tiers"])
    def test_statics_match_jax(self, preset):
        n = 300
        statics, state = init_population(get_scenario(preset), n,
                                         _fl(TFL, n, 3), seed=3, device=CPU)
        js, jst = jpop.init_population(j_scenario(preset), n,
                                       _fl(JFL, n, 3), seed=3)
        for field in ("speed", "comm", "phase"):
            a = getattr(statics, field).numpy()
            b = np.asarray(getattr(js, field))
            assert a.dtype == np.float32
            ulps = np.abs(a.view(np.int32).astype(np.int64)
                          - b.view(np.int32).astype(np.int64))
            assert ulps.max() <= 1, field
        # tier and comm assignments are exact: comm takes the tier values
        np.testing.assert_array_equal(statics.comm.numpy(),
                                      np.asarray(js.comm))
        for field in ("t_next", "k_next", "batch_k", "base_version"):
            a, b = getattr(state, field).numpy(), np.asarray(getattr(jst,
                                                                     field))
            assert a.dtype == b.dtype
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)


def _run_pair(preset, rounds=10, seed=3, **kw):
    sc = get_scenario(preset)
    res_p = run_population(_t_quad, _params(), _quad_clients(), TFL(**FL),
                           total_rounds=rounds, eval_fn=_t_eval, eval_every=5,
                           scenario=sc, seed=seed, device=CPU, **kw)
    res_v = run_vectorized(_t_quad, _params(),
                           make_counter_clients(_quad_clients(), seed=seed),
                           TFL(**FL), total_rounds=rounds, eval_fn=_t_eval,
                           eval_every=5,
                           behavior=CounterBehavior(sc, 6, seed=seed,
                                                    device=CPU),
                           seed=seed, device=CPU)
    return res_p, res_v


def _logs_close(a, b, rtol, atol):
    assert len(a) == len(b)
    for la, lb in zip(a, b):
        assert (la["clients"], la["tau"], la["version"], la["k"]) == \
            (lb["clients"], lb["tau"], lb["version"], lb["k"])
        for f in ("weights", "sq_dists", "staleness_deg", "stat_effect"):
            np.testing.assert_allclose(la[f], lb[f], rtol=rtol, atol=atol,
                                       err_msg=f"v{la['version']} {f}")


class TestEngineParity:
    """run_population == run_vectorized over the counter twins, and ==
    the JAX package's run_population."""

    @pytest.mark.parametrize("preset", ["paper-fig1", "dropout-bernoulli",
                                        "diurnal-phones"])
    def test_full_run(self, preset):
        res_p, res_v = _run_pair(preset)
        assert res_p.num_events == res_v.num_events
        assert res_p.server_rounds == res_v.server_rounds == 10
        assert res_p.sim_time == res_v.sim_time  # one float32 clock
        _logs_close(res_p.round_log, res_v.round_log, 1e-4, 1e-6)
        assert [h["round"] for h in res_p.history] == \
               [h["round"] for h in res_v.history]
        for hp, hv in zip(res_p.history, res_v.history):
            assert hp["time"] == hv["time"]
            assert np.isclose(hp["wnorm"], hv["wnorm"], rtol=1e-4, atol=1e-6)

    @pytest.mark.parametrize("preset", ["paper-fig1", "dropout-bernoulli",
                                        "diurnal-phones"])
    def test_matches_jax(self, preset):
        res_p = run_population(_t_quad, _params(), _quad_clients(),
                               TFL(**FL), total_rounds=10, eval_fn=_t_eval,
                               eval_every=5, scenario=get_scenario(preset),
                               seed=3, device=CPU)
        res_j = jpop.run_population(_j_quad, {"w": jnp.zeros(4)},
                                    _quad_clients(JData), JFL(**FL),
                                    total_rounds=10, eval_fn=_j_eval,
                                    eval_every=5,
                                    scenario=j_scenario(preset), seed=3)
        assert res_p.num_events == res_j.num_events
        assert res_p.num_launches == res_j.num_launches
        assert np.isclose(res_p.sim_time, res_j.sim_time, rtol=1e-6)
        _logs_close(res_p.round_log, res_j.round_log, 1e-4, 1e-6)
        assert [(h["round"], h["time"]) for h in res_p.history] == \
            [(h["round"], h["time"]) for h in res_j.history]
        for hp, hj in zip(res_p.history, res_j.history):
            assert np.isclose(hp["wnorm"], hj["wnorm"], rtol=1e-4, atol=1e-6)

    @pytest.mark.parametrize("mode", ["batched", "fused"])
    def test_kernel_modes_match_reference(self, mode):
        kw = dict(total_rounds=6, scenario=get_scenario("dropout-bernoulli"),
                  seed=1, device=CPU)
        ref = run_population(_t_quad, _params(), _quad_clients(),
                             TFL(server_pass_mode="reference", **FL), **kw)
        res = run_population(_t_quad, _params(), _quad_clients(),
                             TFL(server_pass_mode=mode, **FL), **kw)
        _logs_close(res.round_log, ref.round_log, 1e-5, 1e-7)
        np.testing.assert_allclose(res.final_params["w"].numpy(),
                                   ref.final_params["w"].numpy(), rtol=1e-5)

    def test_single_launch_per_chunk(self):
        res = run_population(_t_quad, _params(), _quad_clients(), TFL(**FL),
                             total_rounds=8, scenario=get_scenario(
                                 "paper-fig1"), seed=0, rounds_per_launch=8,
                             device=CPU)
        assert res.server_rounds == 8
        assert res.num_launches == 1  # one chunk of 8 rounds

    def test_host_reads_counted(self):
        reg = MetricsRegistry()
        run_population(_t_quad, _params(), _quad_clients(), TFL(**FL),
                       total_rounds=8, scenario=get_scenario("paper-fig1"),
                       seed=0, rounds_per_launch=4, device=CPU,
                       registry=reg, eval_fn=_t_eval, eval_every=4)
        snap = reg.snapshot()
        # 8 re-entry reads (no drops, no re-entry at N = 6, K = 3 here or
        # more when a window takes the exact walk), 3 evals, 1 round log
        assert snap["engine_dispatches_total"] == 2
        assert snap["engine_host_syncs_total"] >= 8 + 3 + 1

    def test_latency_model_rejected(self):
        with pytest.raises(ValueError, match="LatencyModel"):
            run_population(_t_quad, _params(), _quad_clients(), TFL(**FL),
                           total_rounds=2,
                           scenario=get_scenario("paper-fig1"),
                           latency=LatencyModel(speed_factors=[1.0] * 6),
                           seed=0, device=CPU)

    def test_run_async_dispatch(self):
        res = run_async(_t_quad, _params(), _quad_clients(), TFL(**FL),
                        total_rounds=4, engine="population",
                        scenario=get_scenario("paper-fig1"), seed=0,
                        device=CPU)
        assert res.server_rounds == 4
        assert len(res.round_log) == 4
        assert res.final_params["w"].shape == (4,)


class TestCheckpointResume:
    """Counter checkpoints: plain integer arrays, bit-identical resume."""

    KW = dict(eval_fn=_t_eval, eval_every=4,
              scenario=get_scenario("dropout-bernoulli"), seed=9, device=CPU)

    @pytest.mark.parametrize("codec", ["f32", "int8", "delta"])
    def test_resume_bit_identical(self, codec):
        fl = TFL(ring_codec=codec, **FL)
        full = run_population(_t_quad, _params(), _quad_clients(), fl,
                              total_rounds=12, capture_state=True, **self.KW)
        half = run_population(_t_quad, _params(), _quad_clients(), fl,
                              total_rounds=6, capture_state=True, **self.KW)
        resumed = run_population(_t_quad, _params(), _quad_clients(), fl,
                                 total_rounds=12,
                                 init_state=half.final_state,
                                 capture_state=True, **self.KW)
        assert resumed.num_events == full.num_events
        assert resumed.sim_time == full.sim_time
        assert resumed.round_log == full.round_log
        assert resumed.history == full.history
        assert torch.equal(resumed.final_params["w"], full.final_params["w"])
        a, b = resumed.final_state, full.final_state
        for field in ("t_next", "k_next", "batch_k", "base_version"):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field))

    def test_state_tree_round_trip(self):
        half = run_population(_t_quad, _params(), _quad_clients(), TFL(**FL),
                              total_rounds=6, capture_state=True, **self.KW)
        tree = population_state_to_tree(half.final_state)
        state2 = population_state_from_tree(tree)
        res_a = run_population(_t_quad, _params(), _quad_clients(), TFL(**FL),
                               total_rounds=12, init_state=half.final_state,
                               **self.KW)
        res_b = run_population(_t_quad, _params(), _quad_clients(), TFL(**FL),
                               total_rounds=12, init_state=state2, **self.KW)
        assert res_a.round_log == res_b.round_log
        assert tree["k_next"].dtype == np.int32
        assert tree["t_next"].dtype == np.float32

    def test_jax_written_tree_resumes_in_port(self, tmp_path):
        """A JAX ``PopulationEngineState`` saved by the JAX checkpoint writer
        loads through the port's ``load_checkpoint`` and resumes: the events
        equal the port's uninterrupted run exactly, the float fields within
        the cross-package tolerance."""
        j_kw = dict(eval_fn=_j_eval, eval_every=4,
                    scenario=j_scenario("dropout-bernoulli"), seed=9)
        j_half = jpop.run_population(_j_quad, {"w": jnp.zeros(4)},
                                     _quad_clients(JData), JFL(**FL),
                                     total_rounds=6, capture_state=True,
                                     **j_kw)
        path = str(tmp_path / "population.npz")
        j_save(path, jpop.population_state_to_tree(j_half.final_state),
               step=6)
        port_half = run_population(_t_quad, _params(), _quad_clients(),
                                   TFL(**FL), total_rounds=6,
                                   capture_state=True, **self.KW)
        like = population_state_to_tree(port_half.final_state)
        loaded, step = load_checkpoint(path, like=like)
        state = population_state_from_tree(loaded)
        assert step == 6 and state.version == 6
        for field in ("k_next", "batch_k", "base_version"):
            np.testing.assert_array_equal(getattr(state, field),
                                          getattr(port_half.final_state,
                                                  field))
        resumed = run_population(_t_quad, _params(), _quad_clients(),
                                 TFL(**FL), total_rounds=12,
                                 init_state=state, **self.KW)
        full = run_population(_t_quad, _params(), _quad_clients(), TFL(**FL),
                              total_rounds=12, **self.KW)
        assert resumed.num_events == full.num_events
        assert resumed.sim_time == full.sim_time
        _logs_close(resumed.round_log, full.round_log, 1e-4, 1e-6)
        assert [(h["round"], h["time"]) for h in resumed.history] == \
            [(h["round"], h["time"]) for h in full.history]


class TestCounterTwins:
    """CounterBehavior / CounterDataset: the host-side consumers of the
    device counter streams."""

    def test_behavior_counter_checkpoint(self):
        sc = get_scenario("dropout-bernoulli")
        beh = CounterBehavior(sc, 4, seed=7, device=CPU)
        for cid in range(4):
            beh.duration(cid, 1.0)
            beh.next_upload(cid)
        snap = beh.get_state()
        a = [beh.duration(cid, 2.0) for cid in range(4)]
        beh2 = CounterBehavior(sc, 4, seed=7, device=CPU)
        beh2.set_state(snap)
        b = [beh2.duration(cid, 2.0) for cid in range(4)]
        assert a == b

    @pytest.mark.parametrize("preset", ["straggler-burst", "diurnal-phones",
                                        "dropout-trace"])
    def test_behavior_lands_on_the_device_clock(self, preset):
        sc = get_scenario(preset)
        n = 20
        beh = CounterBehavior(sc, n, seed=4, device=CPU)
        _, state = init_population(sc, n, _fl(TFL, n, 3), seed=4,
                                   device=CPU)
        starts = [beh.next_start(c, 0.0) for c in range(n)]
        ends = [s + beh.duration(c, s) for c, s in enumerate(starts)]
        np.testing.assert_array_equal(np.asarray(ends, np.float32),
                                      state.t_next.numpy())
        assert ends == [float(e) for e in state.t_next.numpy()]
        jbeh = jpop.CounterBehavior(j_scenario(preset), n, seed=4)
        for cid in range(n):
            assert beh.next_upload(cid) == jbeh.next_upload(cid)

    def test_dataset_counter_draws(self):
        base = _quad_clients(n=2)[0]
        ds = CounterDataset(x=base.x, y=base.y, seed=base.seed, cid=0,
                            stream_seed=3)
        ds2 = CounterDataset(x=base.x, y=base.y, seed=base.seed, cid=0,
                             stream_seed=3)
        a = ds.batches(8, 2)
        row = ds2.rng_state()
        b = ds2.batches(8, 2)
        assert all(np.array_equal(xa, xb) and np.array_equal(ya, yb)
                   for (xa, ya), (xb, yb) in zip(a, b))
        ds2.set_rng_state(row)
        c = ds2.batches(8, 2)
        assert all(np.array_equal(xb, xc)
                   for (xb, _), (xc, _) in zip(b, c))
        pa = ds.batch(8)
        ds_fresh = CounterDataset(x=base.x, y=base.y, seed=base.seed, cid=0,
                                  stream_seed=3)
        pb = ds_fresh.batch(8)
        assert np.array_equal(pa[0], pb[0])

    @pytest.mark.parametrize("cid,size", [(0, 64), (5, 1500), (123, 7)])
    def test_dataset_indices_match_jax(self, cid, size):
        rng = np.random.default_rng(cid)
        x = rng.normal(size=(size, 3)).astype(np.float32)
        y = np.arange(size, dtype=np.float32)
        t = CounterDataset(x=x, y=y, cid=cid, stream_seed=11)
        j = jpop.CounterDataset(x=x, y=y, cid=cid, stream_seed=11)
        for _ in range(3):
            for a, b in zip(t.batches(8, 4), j.batches(8, 4)):
                np.testing.assert_array_equal(a, b)
            for a, b in zip(t.batch(8), j.batch(8)):
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(t.rng_state(), j.rng_state())

    def test_batch_indices_not_supported(self):
        base = _quad_clients(n=1)[0]
        ds = CounterDataset(x=base.x, y=base.y, seed=base.seed, cid=0,
                            stream_seed=0)
        with pytest.raises(NotImplementedError):
            ds.batch_indices(8)


class TestDevicePool:
    def test_from_clients(self):
        clients = _quad_clients(n=3, size=16)
        pool = DevicePool.from_clients(clients)
        assert pool.num_clients == 3
        assert pool.x.shape[0] == 48
        np.testing.assert_array_equal(np.asarray(pool.sizes), [16, 16, 16])
        np.testing.assert_array_equal(np.asarray(pool.offsets), [0, 16, 32])
        jp = jpop.DevicePool.from_clients(_quad_clients(JData, n=3, size=16))
        for a, b in zip(pool, jp):
            np.testing.assert_array_equal(a, np.asarray(b))

    def test_shared_pool(self):
        x = np.arange(100, dtype=np.float32).reshape(100, 1)
        y = np.zeros(100, np.float32)
        pool = DevicePool.shared(x, y, num_clients=10, samples_per_client=30)
        assert pool.num_clients == 10
        assert pool.x.shape[0] == 100
        sizes, offs = np.asarray(pool.sizes), np.asarray(pool.offsets)
        assert (sizes == 30).all()
        assert (offs + sizes <= 100).all()
        with pytest.raises(ValueError, match="exceeds pool size"):
            DevicePool.shared(x, y, num_clients=2, samples_per_client=101)

    @pytest.mark.parametrize("n,per", [(10, 30), (100_000, 1500)])
    def test_shared_offsets_match_jax(self, n, per):
        x = np.zeros((45_000 if per == 1500 else 100, 1), np.float32)
        y = np.zeros(x.shape[0], np.int32)
        a = DevicePool.shared(x, y, n, per)
        b = jpop.DevicePool.shared(x, y, n, per)
        np.testing.assert_array_equal(a.offsets, b.offsets)
        np.testing.assert_array_equal(a.sizes, b.sizes)
        assert a.offsets.dtype == np.int32

    def test_run_population_accepts_pool(self):
        clients = _quad_clients()
        kw = dict(total_rounds=4, scenario=get_scenario("paper-fig1"), seed=0,
                  device=CPU)
        res_pool = run_population(_t_quad, _params(),
                                  DevicePool.from_clients(clients).to(CPU),
                                  TFL(**FL), **kw)
        res_list = run_population(_t_quad, _params(), clients, TFL(**FL),
                                  **kw)
        assert res_pool.round_log == res_list.round_log

    def test_shared_pool_run(self):
        x = np.random.default_rng(0).normal(size=(200, 4)).astype(np.float32)
        y = (x @ np.arange(1.0, 5.0)).astype(np.float32)
        pool = DevicePool.shared(x, y, num_clients=50, samples_per_client=40)
        fl = dataclasses.replace(TFL(**FL), num_clients=50, buffer_size=5)
        res = run_population(_t_quad, _params(), pool, fl, total_rounds=3,
                             scenario=get_scenario("paper-fig1"), seed=0,
                             device=CPU)
        j_pool = jpop.DevicePool.shared(x, y, num_clients=50,
                                        samples_per_client=40)
        j_res = jpop.run_population(
            _j_quad, {"w": jnp.zeros(4)}, j_pool,
            dataclasses.replace(JFL(**FL), num_clients=50, buffer_size=5),
            total_rounds=3, scenario=j_scenario("paper-fig1"), seed=0)
        _logs_close(res.round_log, j_res.round_log, 1e-4, 1e-6)
        jax.clear_caches()
