"""The port's buffered-async server against the JAX package's, on the CPU.

Pinned to ``repro.core``: the ``core/buffer.py`` copy (``UpdateBuffer``,
``VersionHistory`` and its floor), ``tree_stack``, ``make_server_pass`` for
all 8 policies in the port's reference and batched modes (against JAX's
reference mode) with probes, a missing probe (size weighting), precomputed
losses and no probes, and ``AsyncServer``'s round log over a sequence of
``receive``s, with heterogeneous probe shapes (the losses path) and a base
older than the ring (the stale-base fallback). Floats: rtol 1e-5, atol 1e-6
(the same f32 maths in other reduction orders, on 4-parameter models).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JFL
from repro.core import buffer as jbuf
from repro.core.client import make_fresh_loss_fn as j_fresh_fn
from repro.core.server import AsyncServer as JServer
from repro.core.server_pass import make_server_pass as j_make_pass
from repro.utils.pytree import tree_stack as j_tree_stack
from repro_torch.configs.base import FLConfig as TFL
from repro_torch.core import AsyncServer, make_fresh_loss_fn, make_server_pass
from repro_torch.core import buffer as tbuf
from repro_torch.utils.tree import tree_leaves, tree_stack

RTOL, ATOL = 1e-5, 1e-6
POLICIES = ("paper", "multiplicative", "fedbuff", "polynomial", "fedasync",
            "fedasync_constant", "fedasync_hinge", "fedasync_poly")
INFO_FIELDS = ("sq_dists", "staleness", "stat_effect", "weights", "fresh_loss")
LOG_FIELDS = ("weights", "staleness_deg", "stat_effect", "sq_dists")


def _j_loss(params, batch):
    x, y = batch
    return jnp.mean((x @ params["w"] + params["b"] - y) ** 2), {}


def _t_loss(params, batch):
    x, y = batch
    return torch.mean((x @ params["w"] + params["b"] - y) ** 2), {}


J_FRESH = j_fresh_fn(_j_loss)
T_FRESH = make_fresh_loss_fn(_t_loss)


def _params(rng):
    return {"b": rng.normal(size=()).astype(np.float32),
            "w": rng.normal(size=4).astype(np.float32)}


def _batch(rng, b=8):
    x = rng.normal(size=(b, 4)).astype(np.float32)
    return x, (x @ np.arange(1.0, 5.0) + 0.1).astype(np.float32)


def _to_t(tree):
    if isinstance(tree, dict):
        return {k: _to_t(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_t(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def _close(a, b, msg=""):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


# ---------------------------------------------------------------------------
# core/buffer.py copy
# ---------------------------------------------------------------------------


def test_buffer_copy_behaves_as_jax():
    for mod in (jbuf, tbuf):
        with pytest.raises(ValueError):
            mod.VersionHistory(0)
    jh, th = jbuf.VersionHistory(3), tbuf.VersionHistory(3)
    for v in range(7):
        jh.put(v, f"p{v}")
        th.put(v, f"p{v}")
        # the floor keeps exactly max_versions snapshots
        assert [u for u in range(8) if u in th] == \
            [u for u in range(8) if u in jh] == list(range(max(0, v - 2), v + 1))
        assert th.oldest() == jh.oldest()
        assert [th.get(u) for u in range(8)] == [jh.get(u) for u in range(8)]
    jb, tb = jbuf.UpdateBuffer(3), tbuf.UpdateBuffer(3)
    for i in range(5):
        for buf, mod in ((jb, jbuf), (tb, tbuf)):
            buf.add(mod.BufferEntry(client_id=i, delta=None, base_version=i,
                                    data_size=10 + i))
        assert (len(tb), tb.ready()) == (len(jb), jb.ready())
    jd, td = jb.drain(), tb.drain()
    assert [dataclasses.astuple(e) for e in td] == \
        [dataclasses.astuple(e) for e in jd]
    assert [e.client_id for e in td] == [0, 1, 2]  # FIFO, overflow kept
    assert (len(tb), tb.ready()) == (len(jb), jb.ready()) == (2, False)


def test_tree_stack_matches_jax():
    rng = np.random.default_rng(0)
    trees = [{"z": rng.normal(size=(2, 3)).astype(np.float32),
              "a": {"k": rng.normal(size=5).astype(np.float32),
                    "b": np.float32(rng.normal())}} for _ in range(4)]
    js = j_tree_stack([jax.tree.map(jnp.asarray, t) for t in trees])
    ts = tree_stack([_to_t(t) for t in trees])
    jl, tl = jax.tree.leaves(js), tree_leaves(ts)
    assert len(jl) == len(tl) == 3
    for a, b in zip(tl, jl):  # JAX leaf order, same shapes, same bits
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# make_server_pass
# ---------------------------------------------------------------------------


def _pass_inputs(case, k=5, seed=3):
    rng = np.random.default_rng(seed)
    params = _params(rng)
    deltas = [_params(rng) for _ in range(k)]
    for d in deltas:
        d["w"] *= 0.1
    bases = [{"b": params["b"] + 0.05 * i * rng.normal(),
              "w": (params["w"] + 0.05 * i * rng.normal(size=4))
              .astype(np.float32)} for i in range(k)]
    for b in bases:
        b["b"] = np.float32(b["b"])
    probes = [_batch(rng) for _ in range(k)]
    stacked_probes = tuple(np.stack([p[i] for p in probes]) for i in range(2))
    sizes = rng.integers(50, 500, k).astype(np.float32)
    taus = np.asarray([0, 1, 3, 7, 9][:k], np.float32)
    mask = losses = None
    if case == "missing":
        mask = np.asarray([1, 0, 1, 1, 0][:k], np.float32)
    elif case == "precomputed":
        losses = rng.uniform(0.5, 3.0, k).astype(np.float32)
    if case == "none":
        stacked_probes = None
    return params, deltas, bases, stacked_probes, mask, sizes, taus, losses


@pytest.mark.parametrize("case", ["probes", "missing", "precomputed", "none"])
@pytest.mark.parametrize("mode", ["reference", "batched"])
@pytest.mark.parametrize("policy", POLICIES)
def test_make_server_pass_matches_jax(policy, mode, case):
    params, deltas, bases, probes, mask, sizes, taus, losses = \
        _pass_inputs(case)
    kw = dict(weighting=policy, global_lr=0.7, buffer_size=5)
    j = lambda a: None if a is None else jax.tree.map(jnp.asarray, a)  # noqa: E731
    t = lambda a: None if a is None else _to_t(a)  # noqa: E731
    jp, jinfo = j_make_pass(JFL(**kw), J_FRESH, mode="reference")(
        j(params), j(j_tree_stack([j(d) for d in deltas])),
        j(j_tree_stack([j(b) for b in bases])), j(probes), j(mask), j(sizes),
        j(taus), j(losses))
    tpass = make_server_pass(TFL(**kw), T_FRESH, mode=mode, device="cpu")
    assert tpass is make_server_pass(TFL(**kw), T_FRESH, mode=mode,
                                     device="cpu")  # memoized
    tp, tinfo = tpass(t(params), tree_stack([t(d) for d in deltas]),
                      tree_stack([t(b) for b in bases]), t(probes), t(mask),
                      t(sizes), t(taus), t(losses))
    for key in ("b", "w"):
        _close(tp[key].numpy(), jp[key], key)
        assert tuple(tp[key].shape) == jp[key].shape
    assert sorted(tinfo) == sorted(jinfo) == sorted(INFO_FIELDS)
    for key in INFO_FIELDS:
        _close(tinfo[key].numpy(), jinfo[key], key)
    if case == "missing":  # absent probes fall back to loss 1.0
        assert tinfo["fresh_loss"][1] == tinfo["fresh_loss"][4] == 1.0
    if case == "none":
        assert torch.all(tinfo["fresh_loss"] == 1.0)


# ---------------------------------------------------------------------------
# AsyncServer
# ---------------------------------------------------------------------------


# (client, base version, data size, probe rows or None): K=3, max_staleness
# 2 (a ring of 3), so base 0 is out of the ring by round 3 (stale-base
# fallback); a None probe takes loss 1.0; probe rows 8 vs 5 in one round
# take the heterogeneous-shape losses path
UPLOADS = [(0, 0, 100, 8), (1, 0, 120, 8), (2, 0, 90, 8),
           (3, 0, 110, None), (4, 1, 130, 8), (5, 0, 80, 8),
           (0, 1, 100, 8), (1, 2, 120, 5), (2, 2, 90, 8),
           (3, 0, 110, 8), (4, 3, 130, 8), (5, 1, 80, 8)]


def _drive(server_cls, fl, to_backend, device_kw):
    rng = np.random.default_rng(7)
    params = _params(rng)
    deltas = [_params(rng) for _ in UPLOADS]
    probes = [None if rows is None else _batch(rng, rows)
              for (_, _, _, rows) in UPLOADS]
    conv = (lambda a: jax.tree.map(jnp.asarray, a)) if to_backend is None \
        else to_backend
    server = server_cls(conv(params), fl,
                        J_FRESH if to_backend is None else T_FRESH,
                        **device_kw)
    advanced = []
    for (cid, bv, size, _), d, pb in zip(UPLOADS, deltas, probes):
        advanced.append(server.receive(
            cid, conv(d), bv, size,
            None if pb is None else (lambda pb=pb: pb)))
    return server, advanced


@pytest.mark.parametrize("mode", ["reference", "batched", "fused"])
@pytest.mark.parametrize("policy", ["paper", "fedbuff", "fedasync_hinge"])
def test_async_server_round_log_matches_jax(policy, mode):
    kw = dict(weighting=policy, buffer_size=3, max_staleness=2,
              global_lr=0.9)
    js, jadv = _drive(JServer, JFL(server_pass_mode="reference", **kw), None,
                      {})
    ts, tadv = _drive(AsyncServer, TFL(server_pass_mode=mode, **kw), _to_t,
                      {"device": "cpu"})
    assert tadv == jadv and ts.version == js.version == 4
    assert len(ts.round_log) == len(js.round_log) == 4
    for a, b in zip(ts.round_log, js.round_log):
        assert list(a) == list(b)  # the JAX package's keys, in its order
        assert (a["version"], a["tau"], a["clients"], a["k"]) == \
            (b["version"], b["tau"], b["clients"], b["k"])
        assert all(type(x) is int for x in a["tau"] + a["clients"])
        for f in LOG_FIELDS:
            assert all(type(x) is float for x in a[f])
            _close(a[f], b[f], f"v{a['version']} {f}")
    # round 4 takes base 0 at version 3, outside the ring {1, 2, 3}
    assert ts.round_log[3]["tau"] == [3, 0, 2]
    for key in ("b", "w"):
        _close(ts.params[key].numpy(), js.params[key], key)
    assert sorted(v for v in range(6) if v in ts.history) == [2, 3, 4]


def test_async_server_one_host_read_per_round(monkeypatch):
    """One pass call and one ``.cpu()`` (the stacked round-log fields) per
    round, and no other host read, as tests/test_server_pass.py pins for
    the JAX server."""
    fl = TFL(buffer_size=3, weighting="paper")
    server = AsyncServer({"b": torch.zeros(()), "w": torch.zeros(4)}, fl,
                         T_FRESH, device="cpu")
    rng = np.random.default_rng(0)
    batch = _batch(rng)
    reads = []
    for name in ("cpu", "item", "tolist", "numpy"):
        orig = getattr(torch.Tensor, name)
        monkeypatch.setattr(
            torch.Tensor, name,
            lambda self, *a, _n=name, _o=orig, **k: (reads.append(_n),
                                                     _o(self, *a, **k))[1])
    calls = []
    orig_pass = server._pass
    server._pass = lambda *a, **kw: (calls.append(1), orig_pass(*a, **kw))[1]
    d = {"b": torch.zeros(()), "w": torch.ones(4)}
    assert not server.receive(0, d, 0, 10, lambda: batch)
    assert not server.receive(1, d, 0, 20, lambda: batch)
    assert reads == [] and calls == []
    assert server.receive(2, d, 0, 30, lambda: batch)
    assert calls == [1]
    assert reads == ["cpu", "numpy"]  # numpy of the fetched host tensor
    assert server.version == 1 and len(server.round_log) == 1
    assert isinstance(server.params["w"], torch.Tensor)
