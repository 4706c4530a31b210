"""The port's FlatSpec adapter and server round against the JAX package's.

Flat layout: leaf order, sizes and ``n_padded`` must equal JAX's exactly,
and flattening converted LeNet params must give the same bits. The round:
``apply_server_round`` in all three modes against JAX's ``reference`` mode
(rtol 2e-5, atol 1e-6: the same f32 maths, different reduction orders).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JFL
from repro.core import server_pass as jsp
from repro.models.lenet import init_lenet as j_init
from repro_torch.configs.base import FLConfig as TFL
from repro_torch.core import server_pass as tsp
from repro_torch.models import params_from_jax, params_to_numpy

RTOL, ATOL = 2e-5, 1e-6


@pytest.fixture(scope="module")
def lenet():
    jp = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0)))
    return jp, params_from_jax(jp, "cpu")


def test_flat_spec_matches_jax(lenet):
    jp, tp = lenet
    js, ts = jsp.make_flat_spec(jp), tsp.make_flat_spec(tp)
    assert ts.shapes == js.shapes
    assert ts.sizes == js.sizes
    assert (ts.n, ts.n_padded, ts.block_n) == (js.n, js.n_padded, js.block_n)
    assert (ts.n, ts.n_padded) == (44426, 49152)
    assert ts.paths == (("c1", "b"), ("c1", "w"), ("c2", "b"), ("c2", "w"),
                        ("f1", "b"), ("f1", "w"), ("f2", "b"), ("f2", "w"),
                        ("f3", "b"), ("f3", "w"))


def test_flatten_bit_identical_and_round_trip(lenet):
    jp, tp = lenet
    js, ts = jsp.make_flat_spec(jp), tsp.make_flat_spec(tp)
    flat = tsp.flatten_tree(ts, tp)
    assert flat.numpy().tobytes() == np.asarray(
        jsp.flatten_tree(js, jp)).tobytes()
    back = params_to_numpy(tsp.unflatten_like(ts, flat))
    for layer in jp:
        for key in jp[layer]:
            np.testing.assert_array_equal(back[layer][key], jp[layer][key])
    stacked = {l: {k: torch.stack([v, 2 * v]) for k, v in d.items()}
               for l, d in tp.items()}
    mat = tsp.flatten_stacked(ts, stacked)
    assert mat.shape == (2, 49152)
    np.testing.assert_array_equal(mat[1].numpy(), 2 * flat.numpy())
    again = tsp.unflatten_stacked(ts, mat)
    for layer in tp:
        for key in tp[layer]:
            assert torch.equal(again[layer][key], stacked[layer][key])


def test_resolve_mode():
    assert tsp.resolve_mode("auto", torch.device("cpu")) == "reference"
    assert tsp.resolve_mode("auto", torch.device("cuda")) == "fused"
    assert tsp.resolve_mode("batched", torch.device("cpu")) == "batched"
    with pytest.raises(ValueError):
        tsp.resolve_mode("turbo", torch.device("cpu"))


@pytest.mark.parametrize("mode", ["reference", "batched", "fused"])
@pytest.mark.parametrize("policy,use_mask", [("paper", False),
                                             ("paper", True),
                                             ("fedasync_hinge", True),
                                             ("polynomial", False)])
def test_apply_server_round(mode, policy, use_mask):
    rng = np.random.default_rng(11)
    k, n = 6, 49152
    x = rng.normal(size=n).astype(np.float32)
    bases = (x[None] + np.linspace(0, 0.1, k, dtype=np.float32)[:, None]
             * rng.normal(size=(k, n))).astype(np.float32)
    deltas = (0.01 * rng.normal(size=(k, n))).astype(np.float32)
    losses = rng.uniform(1.0, 2.5, k).astype(np.float32)
    sizes = np.full(k, 1500.0, np.float32)
    taus = np.asarray([0, 1, 3, 7, 8, 2], np.float32)
    mask = np.asarray([1, 1, 0, 1, 1, 1], np.float32) if use_mask else None
    kw = dict(weighting=policy, global_lr=0.8)
    jx, jinfo = jsp.apply_server_round(x, bases, deltas, losses, sizes, taus,
                                       JFL(**kw), arrival_mask=mask,
                                       mode="reference")
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    tx, tinfo = tsp.apply_server_round(t(x), t(bases), t(deltas), t(losses),
                                       t(sizes), t(taus), TFL(**kw),
                                       arrival_mask=t(mask), mode=mode)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=RTOL,
                               atol=ATOL)
    assert sorted(tinfo) == sorted(jinfo)
    for key in jinfo:
        np.testing.assert_allclose(tinfo[key].numpy(), np.asarray(jinfo[key]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)
