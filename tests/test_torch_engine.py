"""The whole slice: the port's engine against the JAX engine on the CPU.

Same data (the port's byte-identical copy of the data module), same
converted ``init_lenet(PRNGKey(0))`` and the same scenario timeline go
through ``repro.sim.engine.run_vectorized`` (``reference`` mode) and
``repro_torch`` (every mode; the kernel wrappers take their plain versions
on CPU tensors). Tolerances: round-log fields rtol 1e-4 / atol 1e-7 and
final params atol 1e-5, eval accuracy exact: f32 rounding differences of
the two frameworks' CPU kernels compound over 4 rounds x 2 local steps but
stay orders of magnitude below one SGD step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JFL
from repro.core.simulator import run_sync as j_sync
from repro.models.lenet import apply_lenet as j_apply
from repro.models.lenet import init_lenet as j_init
from repro.models.lenet import lenet_loss as j_loss
from repro.sim.engine import init_version_ring as j_ring
from repro.sim.engine import run_vectorized as j_run
from repro.sim.scenarios import get_scenario as j_scenario
from repro_torch.configs.base import FLConfig as TFL
from repro_torch.core import run_async, run_sync
from repro_torch.launch import paper_experiment
from repro_torch.models import apply_lenet, lenet_loss, params_from_jax
from repro_torch.sim.engine import init_version_ring as t_ring
from repro_torch.sim.scenarios import get_scenario as t_scenario

FL = dict(num_clients=6, buffer_size=3, local_steps=2, local_lr=0.05,
          batch_size=8, max_staleness=4)
ROUNDS = 4
LOG_FIELDS = ("sq_dists", "staleness_deg", "stat_effect", "weights")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _data(pkg_scenario, name="paper-fig1"):
    return pkg_scenario(name).make_dataset(6, samples_per_client=64, seed=0,
                                           noise=1.2)


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0)))


def _evals(xt, yt):
    x, y = xt[:64], yt[:64]
    j_ev = jax.jit(lambda p: jnp.mean(
        (jnp.argmax(j_apply(p, x), -1) == y).astype(jnp.float32)))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    return (lambda p: {"acc": float(j_ev(p))},
            lambda p: {"acc": float((apply_lenet(p, tx).argmax(-1) == ty)
                                    .float().mean())})


def _assert_params_close(t_params, j_params, atol):
    for layer in j_params:
        for key in j_params[layer]:
            np.testing.assert_allclose(t_params[layer][key].numpy(),
                                       np.asarray(j_params[layer][key]),
                                       rtol=0, atol=atol,
                                       err_msg=f"{layer}/{key}")


@pytest.fixture(scope="module")
def jax_run(jax_params):
    clients, (xt, yt) = _data(j_scenario)
    j_ev, _ = _evals(xt, yt)
    res = j_run(j_loss, jax.tree.map(jnp.asarray, jax_params), clients,
                JFL(**FL), ROUNDS, eval_fn=j_ev, eval_every=2, seed=0,
                scenario=j_scenario("paper-fig1"), rounds_per_launch=2,
                capture_state=True)
    return res


@pytest.mark.parametrize("mode", ["auto", "reference", "batched", "fused"])
def test_engine_matches_jax(jax_params, jax_run, mode):
    clients, (xt, yt) = _data(t_scenario)
    _, t_ev = _evals(xt, yt)
    res = run_async(lenet_loss, params_from_jax(jax_params, "cpu"), clients,
                    TFL(server_pass_mode=mode, **FL), ROUNDS, eval_fn=t_ev,
                    eval_every=2, seed=0, scenario=t_scenario("paper-fig1"),
                    rounds_per_launch=2, device="cpu")
    assert res.server_rounds == jax_run.server_rounds == ROUNDS
    assert res.num_events == jax_run.num_events
    assert res.num_launches == jax_run.num_launches == 2
    assert res.sim_time == jax_run.sim_time
    assert len(res.round_log) == len(jax_run.round_log) == ROUNDS
    for a, b in zip(res.round_log, jax_run.round_log):
        assert (a["version"], a["clients"], a["tau"], a["k"]) == \
            (b["version"], b["clients"], b["tau"], b["k"])
        for f in LOG_FIELDS:
            np.testing.assert_allclose(a[f], b[f], rtol=1e-4, atol=1e-7,
                                       err_msg=f"v{a['version']} {f}")
    assert [(h["round"], h["time"], h["acc"]) for h in res.history] == \
        [(h["round"], h["time"], h["acc"]) for h in jax_run.history]
    _assert_params_close(res.final_params, jax_run.final_state.params, 1e-5)


def test_version_ring_bit_identical(jax_params):
    _, jr = j_ring(jax.tree.map(jnp.asarray, jax_params), JFL(**FL))
    _, tr = t_ring(params_from_jax(jax_params, "cpu"), TFL(**FL))
    assert tr.shape == (FL["max_staleness"] + 1, 49152)
    assert tr.numpy().tobytes() == np.asarray(jr).tobytes()


def test_stale_ring_resync_matches_jax(jax_params):
    """max_staleness=1 forces bases out of the ring (resync to tau 0)."""
    fl = dict(FL, max_staleness=1)
    jc, _ = _data(j_scenario)
    tc, _ = _data(t_scenario)
    jr = j_run(j_loss, jax.tree.map(jnp.asarray, jax_params), jc, JFL(**fl),
               3, seed=0, scenario=j_scenario("paper-fig1"),
               capture_state=True)
    tr = run_async(lenet_loss, params_from_jax(jax_params, "cpu"), tc,
                   TFL(**fl), 3, seed=0, scenario=t_scenario("paper-fig1"),
                   device="cpu")
    assert [r["tau"] for r in tr.round_log] == [r["tau"] for r in jr.round_log]
    for a, b in zip(tr.round_log, jr.round_log):
        np.testing.assert_allclose(a["weights"], b["weights"], rtol=1e-4)
    _assert_params_close(tr.final_params, jr.final_state.params, 1e-5)


def test_run_sync_matches_jax(jax_params):
    fl = dict(FL, clients_per_round=3, weighting="fedbuff")
    jc, (xt, yt) = _data(j_scenario)
    tc, _ = _data(t_scenario)
    j_ev, t_ev = _evals(xt, yt)
    jr = j_sync(j_loss, jax.tree.map(jnp.asarray, jax_params), jc, JFL(**fl),
                2, eval_fn=j_ev, eval_every=1, seed=0,
                scenario=j_scenario("paper-fig1"))
    tr = run_sync(lenet_loss, params_from_jax(jax_params, "cpu"), tc,
                  TFL(**fl), 2, eval_fn=t_ev, eval_every=1, seed=0,
                  scenario=t_scenario("paper-fig1"), device="cpu")
    assert tr.server_rounds == jr.server_rounds == 2
    assert tr.num_events == jr.num_events
    assert [(h["round"], h["time"], h["acc"]) for h in tr.history] == \
        [(h["round"], h["time"], h["acc"]) for h in jr.history]


def test_paper_experiment_runs_every_protocol():
    results = paper_experiment.run(num_clients=4, samples_per_client=32,
                                   rounds=2, buffer_k=2, device="cpu")
    assert sorted(results) == sorted([
        "ca-afl(paper)", "fedbuff", "polynomial", "fedasync(K=1)",
        "fedavg(sync)", "fedavg(sync,C=K)"])
    for res in results.values():
        assert res.history and all(0.0 <= h["acc"] <= 1.0
                                   for h in res.history)
