"""The port's cohort step, dist step and ``aggregate_fused`` against the JAX
package's, on the CPU.

Pinned to ``repro.core.cohort`` / ``repro.core.aggregation``: the
replicated-client ``make_cohort_step`` over several rounds with stragglers,
a round that drops the fresh slots and an empty round, in the port's
reference, batched and fused modes (plain versions on CPU tensors) against
JAX's reference mode, on the quadratic problem and on LeNet from the JAX
init (``params_from_jax``); the cohort against the engine's ring round; the
straggler carry-over; ``make_dist_step`` for 8 policies x {mean, none}
against JAX's and against the exact ``apply_server_round``; the ``s_min``
cap and the build-time ``normalize`` error; ``aggregate_fused`` against
``aggregate`` and JAX's Pallas ``aggregate_fused`` (interpret mode). A
traced step (``tracer=``) against an untraced one: its spans nest as
``obs/trace.py`` lays out and its states are the same bits, on the
quadratic problem in every mode and on Hymba-1.5B's smoke model.
Tolerances: rtol 1e-5 / atol 1e-6 on the quadratic problem and the
telemetry (the same f32 maths in other reduction orders); LeNet params
atol 1e-5 over 3 rounds (two frameworks' CPU convolutions); the streaming
aggregate against the exact path rtol 2e-5 / atol 1e-6, as
``tests/test_round_body.py`` holds JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JFL
from repro.core.aggregation import aggregate_fused as j_aggregate_fused
from repro.core.cohort import init_cohort_state as j_init_cohort
from repro.core.cohort import init_dist_state as j_init_dist
from repro.core.cohort import make_cohort_step as j_cohort_step
from repro.core.cohort import make_dist_step as j_dist_step
from repro.models.lenet import init_lenet as j_init_lenet
from repro.models.lenet import lenet_loss as j_lenet_loss
from repro.utils.pytree import tree_sq_dist as j_tree_sq_dist
from repro_torch.configs.base import FLConfig as TFL
from repro_torch.core import (
    aggregate,
    aggregate_fused,
    apply_server_round,
    flatten_stacked,
    flatten_tree,
    init_cohort_state,
    init_dist_state,
    make_cohort_step,
    make_dist_step,
    make_flat_spec,
    make_local_update_fn,
    make_ring_round,
    make_round_body,
    unflatten_like,
)
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.models import build_model, lenet_loss, params_from_jax
from repro_torch.obs import Tracer
from repro_torch.obs import trace as ttrace
from repro_torch.sim.engine import init_version_ring
from repro_torch.utils.tree import tree_leaves, tree_sq_dist

RTOL, ATOL = 1e-5, 1e-6
POLICIES = ("paper", "multiplicative", "fedbuff", "polynomial", "fedasync",
            "fedasync_constant", "fedasync_hinge", "fedasync_poly")
MODES = ("reference", "batched", "fused")
METRICS = ("fresh_loss_mean", "staleness_min", "weights_max",
           "update_sq_norm")


def _j_quad(params, batch):
    x, y = batch
    return jnp.mean((x @ params["w"] - y) ** 2), {}


def _t_quad(params, batch):
    x, y = batch
    return torch.mean((x @ params["w"] - y) ** 2), {}


def _quad_batch(rng, *lead, n=8, d=4):
    x = rng.normal(size=lead + (n, d)).astype(np.float32)
    y = (x @ np.arange(1.0, d + 1.0) + 0.01 * rng.normal(
        size=lead + (n,))).astype(np.float32)
    return x, y


W0 = np.array([1.0, -1.0, 0.5, 2.0], np.float32)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_t(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(a, b, msg="", rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol,
                               atol=atol, err_msg=msg)


def _trees_close(t_tree, j_tree, msg="", rtol=RTOL, atol=ATOL):
    tl, jl = tree_leaves(t_tree), jax.tree.leaves(j_tree)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        _close(a.numpy(), b, msg, rtol, atol)


# masks: stragglers, then the fresh slots (arrived last round) absent,
# then an empty round, then everyone
MASKS = [[1, 0, 1, 0], [1, 0, 0, 1], [0, 1, 1, 0], [0, 0, 0, 0],
         [1, 1, 1, 1]]


def _quad_rounds(seed=0, c=4, m=2):
    rng = np.random.default_rng(seed)
    out = []
    for mask in MASKS:
        out.append({"local": _quad_batch(rng, c, m), "probe": _quad_batch(
            rng, c), "arrival": np.asarray(mask, np.float32),
            "data_sizes": np.linspace(10.0, 40.0, c).astype(np.float32)})
    return out


def _j_run(j_loss, params, rounds, fl_kw):
    """JAX's cohort trajectory (reference mode): [(state, metrics)]."""
    step = jax.jit(j_cohort_step(j_loss, JFL(**fl_kw,
                                             server_pass_mode="reference")))
    state, out = j_init_cohort(_j(params), len(rounds[0]["arrival"])), []
    for batch in rounds:
        state, mets = step(state, _j(batch))
        out.append((state, mets))
    return out


def _check_run(t_loss, params, rounds, fl_kw, mode, j_out, ptol, mtol):
    """The port's cohort in ``mode`` against JAX's trajectory ``j_out``:
    state within ``ptol`` = (rtol, atol), telemetry within rtol ``mtol``."""
    step = make_cohort_step(t_loss, TFL(**fl_kw, server_pass_mode=mode),
                            device="cpu")
    ts = init_cohort_state(params_from_jax(params, "cpu"),
                           len(rounds[0]["arrival"]))
    for r, (batch, (js, jm)) in enumerate(zip(rounds, j_out)):
        ts, tm = step(ts, batch)
        msg = f"{mode} round {r}"
        for field in ("global_params", "client_params", "client_base"):
            _trees_close(getattr(ts, field), getattr(js, field),
                         f"{msg} {field}", *ptol)
        np.testing.assert_array_equal(ts.client_version.numpy(),
                                      np.asarray(js.client_version))
        assert int(ts.version) == int(js.version) == r + 1
        for key in METRICS:
            _close(tm[key].numpy(), jm[key], f"{msg} {key}", rtol=mtol)
        if not batch["arrival"].any():  # empty round: neutral 0.0s
            assert all(float(tm[k]) == 0.0 for k in METRICS)


QUAD_KW = dict(buffer_size=4, local_steps=2, local_lr=0.05)


@pytest.fixture(scope="module")
def quad_runs():
    rounds = _quad_rounds()
    return rounds, {policy: _j_run(_j_quad, {"w": W0}, rounds,
                                   dict(QUAD_KW, weighting=policy))
                    for policy in ("paper", "fedasync_hinge")}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("policy", ["paper", "fedasync_hinge"])
def test_cohort_step_matches_jax_with_stragglers(quad_runs, mode, policy):
    rounds, j_runs = quad_runs
    _check_run(_t_quad, {"w": W0}, rounds, dict(QUAD_KW, weighting=policy),
               mode, j_runs[policy], (RTOL, ATOL), RTOL)


LENET_KW = dict(buffer_size=3, local_steps=2, local_lr=0.05)


@pytest.fixture(scope="module")
def lenet_runs():
    init = jax.tree.map(np.asarray, j_init_lenet(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    c, m, b = 3, 2, 8

    def batch(mask):
        return {"local": (rng.normal(size=(c, m, b, 28, 28, 1)).astype(
                    np.float32), rng.integers(0, 10, (c, m, b)).astype(
                    np.int32)),
                "probe": (rng.normal(size=(c, b, 28, 28, 1)).astype(
                    np.float32), rng.integers(0, 10, (c, b)).astype(
                    np.int32)),
                "arrival": np.asarray(mask, np.float32),
                "data_sizes": np.asarray([50.0, 80.0, 30.0], np.float32)}

    rounds = [batch(mk) for mk in ([1, 0, 1], [0, 1, 0], [1, 1, 1])]
    return init, rounds, _j_run(j_lenet_loss, init, rounds, LENET_KW)


@pytest.mark.parametrize("mode", MODES)
def test_cohort_step_matches_jax_on_lenet(lenet_runs, mode):
    init, rounds, j_out = lenet_runs
    _check_run(lenet_loss, init, rounds, LENET_KW, mode, j_out, (0, 1e-5),
               1e-4)


def test_cohort_step_matches_ring_round():
    """One all-arrived cohort round == one engine ring round on the same
    inputs (``tests/test_round_body.py``'s form): same new params, the
    ring row holds them, same telemetry."""
    rng = np.random.default_rng(0)
    k = 3
    fl = TFL(buffer_size=k, local_steps=2, local_lr=0.05, max_staleness=0,
             server_pass_mode="reference")
    params = {"w": torch.from_numpy(W0)}
    local, probe = _t(_quad_batch(rng, k, 2)), _t(_quad_batch(rng, k))
    sizes = torch.linspace(10.0, 30.0, k)
    spec, ring = init_version_ring(params, fl)
    new_p, ring, info = make_ring_round(_t_quad, fl, "cpu", spec)(
        params, ring, torch.zeros(k, dtype=torch.long), local, probe, sizes,
        torch.zeros(k), 0)
    step = make_cohort_step(_t_quad, fl, device="cpu")
    state, mets = step(init_cohort_state(params, k),
                       {"local": local, "probe": probe,
                        "arrival": torch.ones(k), "data_sizes": sizes})
    _close(state.global_params["w"], new_p["w"])
    _close(ring[0][:spec.n], new_p["w"], rtol=1e-6, atol=0)
    _close(float(mets["fresh_loss_mean"]),
           float(torch.mean(info["fresh_loss"])))
    _close(float(mets["staleness_min"]), float(torch.min(info["staleness"])))
    _close(float(mets["weights_max"]), float(torch.max(info["weights"])))


def test_engine_and_cohort_entry_shapes_agree():
    """With fresh slots (client_params == pulled base) the cohort shape of
    the body reproduces the engine shape: same new params and info."""
    rng = np.random.default_rng(2)
    k = 3
    fl = TFL(buffer_size=k, local_steps=2, local_lr=0.05)
    params = {"w": torch.from_numpy(W0)}
    spec = make_flat_spec(params)
    body = make_round_body(_t_quad, fl, "cpu", spec)
    local, probe = _t(_quad_batch(rng, k, 2)), _t(_quad_batch(rng, k))
    sizes, taus = torch.linspace(10.0, 30.0, k), torch.arange(3.0)
    bases = {"w": params["w"][None].expand(k, 4).clone()}
    x, b = flatten_tree(spec, params), flatten_stacked(spec, bases)
    new_e, new_x, info_e = body(params, x, b, local, probe, sizes, taus)
    new_c, end_c, info_c = body(params, x, b, local, probe, sizes, taus,
                                client_params=bases,
                                arrival_mask=torch.ones(k))
    assert tuple(end_c["w"].shape) == (k, 4) and new_x.shape == x.shape
    _close(new_e["w"], new_c["w"])
    assert set(info_e) == set(info_c)
    for key in info_e:
        _close(info_e[key], info_c[key], key)


ROUND_PHASES = [ttrace.SPAN_LOCAL_TRAIN, ttrace.SPAN_PROBE,
                ttrace.SPAN_SERVER_PASS, ttrace.SPAN_RESYNC]


def _inside(outer, inner):
    return outer.start_ns <= inner.start_ns and inner.end_ns <= outer.end_ns


def _check_traced_rounds(loss_fn, params, rounds, fl, annotate=False):
    """Step ``rounds`` with and without a tracer: the same bits every
    round, and each round's spans nest as ``cohort_step`` > the four
    phases in order > ``local_forward`` x M inside ``local_train``."""
    tr = Tracer(annotate=annotate)
    plain = make_cohort_step(loss_fn, fl, device="cpu")
    traced = make_cohort_step(loss_fn, fl, device="cpu", tracer=tr)
    a = b = init_cohort_state(params, len(rounds[0]["arrival"]))
    for batch in rounds:
        a, met_a = plain(a, batch)
        b, met_b = traced(b, batch)
        for x, y in zip(tree_leaves({**a._asdict(), **met_a}),
                        tree_leaves({**b._asdict(), **met_b})):
            assert torch.equal(x, y)
    steps = [e for e in tr.edges if e.name == ttrace.SPAN_COHORT_STEP]
    assert len(steps) == len(rounds)
    for step in steps:
        inner = sorted((e for e in tr.edges if e is not step
                        and _inside(step, e)), key=lambda e: e.start_ns)
        phases = [e for e in inner if e.name in ROUND_PHASES]
        assert [e.name for e in phases] == ROUND_PHASES
        for first, then in zip(phases, phases[1:]):
            assert first.end_ns <= then.start_ns
        forwards = [e for e in inner if e.name == ttrace.SPAN_LOCAL_FORWARD]
        assert len(forwards) == fl.local_steps
        assert all(_inside(phases[0], e) for e in forwards)
        assert {e.name for e in inner} <= set(ttrace.COHORT_SPAN_NAMES)
    return tr


@pytest.mark.parametrize("mode", MODES)
def test_traced_cohort_step_spans_and_bits(mode):
    _check_traced_rounds(_t_quad, {"w": torch.from_numpy(W0)},
                         _quad_rounds(), TFL(**QUAD_KW,
                                             server_pass_mode=mode))


def test_traced_cohort_step_on_an_lm():
    """Hymba-1.5B's smoke model under ``vmap(grad)``, every span also a
    ``record_function`` (the launcher's tracer)."""
    cfg = smoke_variant(get_arch("hymba-1.5b").model)
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    c, m, s = 3, 2, 16

    def toks(*lead):
        t = torch.from_numpy(rng.integers(0, cfg.vocab_size, lead + (s + 1,)))
        return {"tokens": t[..., :s], "labels": t[..., 1:]}

    rounds = [{"local": toks(c, m, 1), "probe": toks(c, 2),
               "arrival": torch.tensor(mask), "data_sizes":
               torch.tensor([500.0, 900.0, 1300.0])}
              for mask in ([1.0, 0.0, 1.0], [0.0, 1.0, 1.0])]
    _check_traced_rounds(model.loss, params, rounds,
                         TFL(buffer_size=2, local_steps=m, local_lr=5e-3,
                             server_pass_mode="fused"), annotate=True)


def test_straggler_semantics_preserved():
    """A straggler slot carries its local progress (its local params leave
    its base); an arrived slot resyncs to the new global params."""
    fl = TFL(buffer_size=1, local_steps=1, local_lr=0.1)
    state = init_cohort_state({"w": torch.zeros(4)}, 2)
    rng = np.random.default_rng(0)
    x, y = _t(_quad_batch(rng))
    px, py = _t(_quad_batch(rng))
    batch = {"local": (x.expand(2, 1, 8, 4), y.expand(2, 1, 8)),
             "probe": (px.expand(2, 8, 4), py.expand(2, 8)),
             "arrival": torch.tensor([1.0, 0.0]), "data_sizes": torch.ones(2)}
    s1, _ = make_cohort_step(_t_quad, fl, device="cpu")(state, batch)
    assert not torch.allclose(s1.client_params["w"][1],
                              s1.client_base["w"][1])  # progress carried
    assert torch.equal(s1.client_params["w"][0], s1.global_params["w"])
    assert s1.client_version.tolist() == [1, 0]


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("normalize", ["mean", "none"])
def test_dist_step_matches_jax_and_exact_path(policy, normalize):
    """K sequential dist steps against JAX's dist step (the same inputs,
    rtol 1e-5), and against one exact ``apply_server_round`` fed bases
    whose eq. 3 distances equal the ring distances (rtol 2e-5): the fill
    holds a fresh upload, so the pinned reference equals the buffer min."""
    k = 4
    kw = dict(buffer_size=k, local_steps=1, local_lr=0.1, weighting=policy,
              normalize=normalize, global_lr=1.0, max_staleness=k)
    fl = TFL(**kw)
    norm_ring = np.array([0.3, 0.2, 0.1, 0.05], np.float32)
    params = {"w": torch.from_numpy(W0)}
    state = init_dist_state(params, fl)._replace(
        update_norm_ring=torch.from_numpy(norm_ring))
    j_state = j_init_dist({"w": jnp.asarray(W0)}, JFL(**kw))._replace(
        update_norm_ring=jnp.asarray(norm_ring))
    step = make_dist_step(_t_quad, fl, device="cpu")
    j_step = jax.jit(j_dist_step(_j_quad, JFL(**kw)))
    local_update = make_local_update_fn(_t_quad, 1, 0.1)
    taus, sizes = [0, 1, 2, 3], [10.0, 20.0, 30.0, 40.0]
    rng = np.random.default_rng(3)
    deltas, losses = [], []
    for i in range(k):
        stacked, pb = _quad_batch(rng, 1), _quad_batch(rng)
        state, mets = step(state, {"local": stacked, "probe": pb,
                                   "tau": taus[i], "data_size": sizes[i]})
        j_state, j_mets = j_step(j_state, {
            "local": _j(stacked), "probe": _j(pb),
            "tau": jnp.int32(taus[i]), "data_size": jnp.float32(sizes[i])})
        _close(float(mets["v_weight"]), float(j_mets["v_weight"]))
        _close(float(mets["fresh_loss"]), float(j_mets["fresh_loss"]))
        assert mets["buffered"] == int(j_mets["buffered"]) == i + 1
        assert mets["applied"] == int(j_mets["applied"])
        deltas.append(local_update(params, _t(stacked))[0])
        losses.append(_t_quad(params, _t(pb))[0])
    assert mets["applied"] == 1 and state.count == 0 and state.version == 1
    _close(state.global_params["w"], np.asarray(j_state.global_params["w"]))
    _close(state.update_norm_ring, np.asarray(j_state.update_norm_ring))

    dists = torch.tensor([float(norm_ring[:t].sum()) for t in taus])
    spec = make_flat_spec(params)
    x = flatten_tree(spec, params)
    bases = x[None] - torch.sqrt(dists)[:, None] * torch.eye(
        spec.n_padded)[:k]
    new_x, _ = apply_server_round(
        x, bases, flatten_stacked(spec, {"w": torch.stack(
            [d["w"] for d in deltas])}), torch.stack(losses),
        torch.tensor(sizes), torch.tensor(taus, dtype=torch.float32), fl)
    _close(state.global_params["w"], unflatten_like(spec, new_x)["w"],
           rtol=2e-5, atol=1e-6)


def test_dist_step_caps_stale_weight():
    """A hugely stale upload's streaming weight is bounded by P / s_min."""
    fl = TFL(buffer_size=2, local_steps=1, local_lr=0.1, weighting="paper",
             max_staleness=4)
    state = init_dist_state({"w": torch.from_numpy(W0)}, fl)._replace(
        update_norm_ring=torch.tensor([1e6, 0.0, 0.0, 0.0]))
    step = make_dist_step(_t_quad, fl, device="cpu")
    rng = np.random.default_rng(1)
    b, pb = _quad_batch(rng, 1), _quad_batch(rng)
    vs = []
    for tau in (0, 1):  # same data, same probe: only staleness differs
        state, mets = step(state, {"local": b, "probe": pb, "tau": tau,
                                   "data_size": 10.0})
        vs.append(float(mets["v_weight"]))
    assert vs[1] / vs[0] <= 1.0 / fl.s_min * 1.01
    assert vs[1] > vs[0]


def test_unknown_normalize_raises_at_build():
    with pytest.raises(ValueError, match="normalize"):
        make_dist_step(_t_quad, TFL(normalize="typo"), device="cpu")


def test_tree_sq_dist_matches_jax():
    rng = np.random.default_rng(4)
    a = {"z": rng.normal(size=(3, 5)).astype(np.float32),
         "b": {"k": rng.normal(size=7).astype(np.float32)}}
    b = jax.tree.map(lambda v: v + 0.1 * np.float32(rng.normal()), a)
    _close(float(tree_sq_dist(_t(a), _t(b))),
           float(j_tree_sq_dist(_j(a), _j(b))))


def test_aggregate_fused_matches_aggregate_and_jax():
    rng = np.random.default_rng(5)
    k = 5
    params = {"c": {"w": rng.normal(size=(3, 7)).astype(np.float32)},
              "b": rng.normal(size=11).astype(np.float32)}
    deltas = jax.tree.map(
        lambda v: (0.1 * rng.normal(size=(k,) + v.shape)).astype(np.float32),
        params)
    w = rng.uniform(0.5, 2.0, size=k).astype(np.float32)
    new_f, upd_f = aggregate_fused(_t(params), _t(deltas), torch.from_numpy(w),
                                   0.7, k)
    new_a, upd_a = aggregate(_t(params), _t(deltas), torch.from_numpy(w),
                             0.7, k)
    new_j, upd_j = j_aggregate_fused(_j(params), _j(deltas), jnp.asarray(w),
                                     0.7, k, interpret=True)
    _trees_close(new_f, new_j)
    _trees_close(upd_f, upd_j)
    for a, b in zip(tree_leaves(new_f) + tree_leaves(upd_f),
                    tree_leaves(new_a) + tree_leaves(upd_a)):
        assert a.shape == b.shape
        _close(a, b)
