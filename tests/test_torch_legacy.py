"""The port's per-event legacy engine against the JAX package's, on the CPU.

``run_async_legacy`` on the quadratic clients of tests/test_sim_engine.py,
for every weighting: event for event (clients, tau, versions, event count,
sim time and eval times exact; floats rtol 1e-5, atol 1e-6: the same f32
maths over 10 rounds of a 4-parameter model). The stale-ring fallback case,
a recorded trace, a LeNet smoke run with equal accuracy at each eval, and
the port's legacy engine against its vectorized engine (as
tests/test_sim_engine.py does for JAX). Under ``slow``: the 20-round
quickstart gate, both packages, both engines, paper and fedbuff.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JFL
from repro.core import run_async as j_run_async
from repro.core import run_async_legacy as j_legacy
from repro.data.synthetic import ClientDataset as JData
from repro.models.lenet import apply_lenet as j_apply
from repro.models.lenet import init_lenet as j_init
from repro.models.lenet import lenet_loss as j_lenet_loss
from repro.sim.scenarios import get_scenario as j_scenario
from repro_torch.configs.base import FLConfig as TFL
from repro_torch.core import run_async, run_async_legacy
from repro_torch.data.synthetic import ClientDataset as TData
from repro_torch.launch import quickstart
from repro_torch.models import apply_lenet, lenet_loss, params_from_jax
from repro_torch.sim.engine import run_vectorized
from repro_torch.sim.scenarios import get_scenario as t_scenario

RTOL, ATOL = 1e-5, 1e-6
POLICIES = ("paper", "multiplicative", "fedbuff", "polynomial", "fedasync",
            "fedasync_constant", "fedasync_hinge", "fedasync_poly")
LOG_FIELDS = ("weights", "staleness_deg", "stat_effect", "sq_dists")
FL = dict(num_clients=6, buffer_size=3, local_steps=2, local_lr=0.05,
          batch_size=8, max_staleness=4)


def _j_quad(params, batch):
    x, y = batch
    return jnp.mean((x @ params["w"] - y) ** 2), {}


def _t_quad(params, batch):
    x, y = batch
    return torch.mean((x @ params["w"] - y) ** 2), {}


def _quad_clients(cls, n=6, size=64, d=4, seed=0):
    rng = np.random.default_rng(seed)
    w_true = np.arange(1.0, d + 1.0)
    out = []
    for i in range(n):
        x = rng.normal(size=(size, d)).astype(np.float32)
        y = (x @ w_true + 0.05 * rng.normal(size=size)).astype(np.float32)
        out.append(cls(x=x, y=y, seed=seed + 10 + i))
    return out


def _j_eval(params):
    return {"wnorm": float(jnp.sum(params["w"] ** 2))}


def _t_eval(params):
    return {"wnorm": float(torch.sum(params["w"] ** 2))}


def _assert_logs_match(a_log, b_log, rtol=RTOL, atol=ATOL):
    assert len(a_log) == len(b_log)
    for a, b in zip(a_log, b_log):
        assert list(a) == list(b)
        assert (a["version"], a["clients"], a["tau"], a["k"]) == \
            (b["version"], b["clients"], b["tau"], b["k"])
        for f in LOG_FIELDS:
            np.testing.assert_allclose(a[f], b[f], rtol=rtol, atol=atol,
                                       err_msg=f"v{a['version']} {f}")


def _assert_histories_match(a, b, key, rtol=RTOL):
    assert [(h["round"], h["time"]) for h in a] == \
        [(h["round"], h["time"]) for h in b]
    for ha, hb in zip(a, b):
        np.testing.assert_allclose(ha[key], hb[key], rtol=rtol)


@pytest.mark.parametrize("mode", ["reference", "batched"])
@pytest.mark.parametrize("weighting", POLICIES)
def test_legacy_matches_jax_event_for_event(weighting, mode):
    fl = dict(FL, weighting=weighting)
    jr = j_legacy(_j_quad, {"w": jnp.zeros(4)}, _quad_clients(JData),
                  JFL(**fl), total_rounds=10, eval_fn=_j_eval, seed=0)
    tr = run_async_legacy(_t_quad, {"w": torch.zeros(4)},
                          _quad_clients(TData),
                          TFL(server_pass_mode=mode, **fl), total_rounds=10,
                          eval_fn=_t_eval, seed=0, device="cpu")
    assert tr.server_rounds == jr.server_rounds == 10
    assert tr.num_events == jr.num_events
    assert tr.sim_time == jr.sim_time
    _assert_logs_match(tr.round_log, jr.round_log)
    _assert_histories_match(tr.history, jr.history, "wnorm")
    assert tr.final_params["w"].device.type == "cpu"


def test_legacy_stale_ring_fallback_matches_jax():
    """max_staleness=1 forces bases out of the ring: both resync."""
    fl = dict(FL, max_staleness=1, buffer_size=2)
    jr = j_legacy(_j_quad, {"w": jnp.zeros(4)}, _quad_clients(JData),
                  JFL(**fl), total_rounds=8, seed=1)
    tr = run_async_legacy(_t_quad, {"w": torch.zeros(4)},
                          _quad_clients(TData), TFL(**fl), total_rounds=8,
                          seed=1, device="cpu")
    _assert_logs_match(tr.round_log, jr.round_log)
    assert tr.num_events == jr.num_events


def test_legacy_trace_matches_jax_and_replays():
    fl = dict(FL, weighting="paper")
    sc = "dropout-bernoulli"
    jr = j_legacy(_j_quad, {"w": jnp.zeros(4)}, _quad_clients(JData),
                  JFL(**fl), total_rounds=6, seed=2,
                  scenario=j_scenario(sc), record_trace=True)
    tr = run_async_legacy(_t_quad, {"w": torch.zeros(4)},
                          _quad_clients(TData), TFL(**fl), total_rounds=6,
                          seed=2, scenario=t_scenario(sc), record_trace=True,
                          device="cpu")
    assert tr.trace.to_json() == jr.trace.to_json()
    assert tr.trace.drops  # the scenario dropped uploads
    replay = run_async_legacy(_t_quad, {"w": torch.zeros(4)},
                              _quad_clients(TData), TFL(**fl),
                              total_rounds=6, seed=2, trace=tr.trace,
                              device="cpu")
    _assert_logs_match(replay.round_log, tr.round_log, rtol=0, atol=0)


@pytest.mark.parametrize("weighting", ["paper", "fedbuff"])
def test_port_legacy_matches_port_vectorized(weighting):
    """The vectorized engine reproduces the legacy loop's round log event
    for event (tests/test_sim_engine.py:59, on the port)."""
    fl = TFL(weighting=weighting, **FL)
    res_v = run_vectorized(_t_quad, {"w": torch.zeros(4)},
                           _quad_clients(TData), fl, total_rounds=10,
                           eval_fn=_t_eval, seed=0, device="cpu")
    res_l = run_async(_t_quad, {"w": torch.zeros(4)}, _quad_clients(TData),
                      fl, total_rounds=10, eval_fn=_t_eval, seed=0,
                      engine="legacy", device="cpu")
    assert res_v.server_rounds == res_l.server_rounds == 10
    assert res_v.num_events == res_l.num_events
    assert res_v.sim_time == res_l.sim_time
    _assert_logs_match(res_v.round_log, res_l.round_log)
    _assert_histories_match(res_v.history, res_l.history, "wnorm")


def _lenet_setup(pkg_scenario):
    return pkg_scenario("paper-fig1").make_dataset(6, samples_per_client=64,
                                                   seed=0, noise=1.2)


def test_legacy_lenet_smoke_matches_jax():
    jp = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0)))
    jc, (xt, yt) = _lenet_setup(j_scenario)
    tc, _ = _lenet_setup(t_scenario)
    x, y = xt[:64], yt[:64]
    j_ev = jax.jit(lambda p: jnp.mean(
        (jnp.argmax(j_apply(p, x), -1) == y).astype(jnp.float32)))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    fl = dict(FL, weighting="paper")
    jr = j_legacy(j_lenet_loss, jax.tree.map(jnp.asarray, jp), jc, JFL(**fl),
                  3, eval_fn=lambda p: {"acc": float(j_ev(p))}, eval_every=1,
                  seed=0, scenario=j_scenario("paper-fig1"))
    tr = run_async_legacy(
        lenet_loss, params_from_jax(jp, "cpu"), tc, TFL(**fl), 3,
        eval_fn=lambda p: {"acc": float((apply_lenet(p, tx).argmax(-1) == ty)
                                        .float().mean())},
        eval_every=1, seed=0, scenario=t_scenario("paper-fig1"),
        device="cpu")
    # equal accuracy at each eval; LeNet's round log to the engine tests'
    # rtol 1e-4 (49,152 f32 terms per distance, other summation orders)
    assert [(h["round"], h["time"], h["acc"]) for h in tr.history] == \
        [(h["round"], h["time"], h["acc"]) for h in jr.history]
    _assert_logs_match(tr.round_log, jr.round_log, rtol=1e-4, atol=1e-7)


@pytest.mark.slow
@pytest.mark.parametrize("engine", ["vectorized", "legacy"])
def test_quickstart_gate_matches_jax(engine):
    """The 20-round quickstart (8 clients x 300, K=4, M=4, B=32,
    paper-fig1) on both packages from the JAX init: per-round logs at the
    engine tests' rtol 1e-4 and equal accuracy at r5/r10/r15/r20."""
    jp = j_init(jax.random.PRNGKey(0))
    sc = j_scenario("paper-fig1")
    _, (xt, yt) = sc.make_dataset(num_clients=8, samples_per_client=300,
                                  seed=0)
    j_ev = jax.jit(lambda p: jnp.mean(
        (jnp.argmax(j_apply(p, xt[:512]), -1) == yt[:512])
        .astype(jnp.float32)))
    port = quickstart.run(engine=engine, device="cpu",
                          params=params_from_jax(
                              jax.tree.map(np.asarray, jp), "cpu"))
    for weighting in quickstart.WEIGHTINGS:
        clients, _ = sc.make_dataset(num_clients=8, samples_per_client=300,
                                     seed=0)
        fl = JFL(num_clients=8, buffer_size=4, local_steps=4, local_lr=0.05,
                 batch_size=32, weighting=weighting)
        jr = j_run_async(j_lenet_loss, jp, clients, fl, total_rounds=20,
                         eval_fn=lambda p: {"acc": float(j_ev(p))},
                         eval_every=5, scenario=sc, seed=0, engine=engine)
        tr = port[weighting]["result"]
        # equal accuracy: the same count of correct test predictions (the
        # two frameworks' f32 means of one count differ in the last bit)
        n_eval = len(xt[:512])
        assert [h["round"] for h in tr.history] == [0, 5, 10, 15, 20]
        assert [(h["round"], round(h["acc"] * n_eval)) for h in tr.history] \
            == [(h["round"], round(h["acc"] * n_eval)) for h in jr.history]
        _assert_logs_match(tr.round_log, jr.round_log, rtol=1e-4, atol=1e-7)


def test_quickstart_driver_runs_both_engines():
    out = quickstart.run(engine="legacy", device="cpu", rounds=2)
    assert sorted(out) == sorted(quickstart.WEIGHTINGS)
    for run in out.values():
        assert run["result"].server_rounds == 2
        assert run["telemetry"]["rounds"] == 2
    assert quickstart.main(["--list"]) is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            quickstart.main(["--rounds", "1"])
