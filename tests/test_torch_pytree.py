"""``repro_torch.utils`` (the tree helpers) and the LM example's driver
against the JAX package's.

Each helper runs on the same numpy trees in both packages (f32 and bf16
leaves, an int leaf) and must agree: bit for bit where the maths is one
elementwise op or a count, at rtol 1e-6 where it sums in f32 in another
order. Then ``launch/train_lm_federated.py`` on the CPU, from the JAX
example's init carried across, must print the JAX example's per-round log
(``examples/train_lm_federated.py`` run as it is, its stdout read): the
probe loss within its printed 4 decimals plus 1e-4 relative (the cohort
step's rounds agree to 1e-3 relative, ``tests/test_torch_train.py``), the
staleness within its 3 decimals, the arrivals exact. The run is cut to a
2-layer, 64-wide decoder over a 256-token vocabulary so that the file
keeps well inside the suite's time.
"""
import dataclasses
import importlib.util
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.utils as j_utils
import repro_torch.utils as t_utils
from repro.configs.base import ModelConfig as JModelConfig
from repro.models.model import build_model as j_build
from repro_torch.launch import train_lm_federated as t_example
from repro_torch.models import lm_params_from_jax
from repro_torch.utils.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
FLAGS = dict(rounds=3, model_dim=64, layers=2, vocab=256, seq=32, batch=2)
SUM_RTOL = 1e-6


def _np_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                  "b": rng.normal(size=(4,)).astype(np.float32)},
            "c": rng.normal(size=(2, 3)).astype(np.float32)}


def _stacked(seed=0, k=3):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(k, 5)).astype(np.float32),
            "y": {"z": rng.normal(size=(k, 2, 2)).astype(np.float32)}}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _same(got, want, rtol=0.0):
    got_leaves = [np.asarray(x.float().numpy() if x.dtype == torch.bfloat16
                             else x.numpy()) for x in tree_leaves(got)]
    want_leaves = [np.asarray(x, np.float32 if x.dtype == jnp.bfloat16
                              else x.dtype) for x in jax.tree.leaves(want)]
    assert len(got_leaves) == len(want_leaves)
    for a, b in zip(got_leaves, want_leaves):
        if rtol:
            np.testing.assert_allclose(a, b, rtol=rtol)
        else:
            np.testing.assert_array_equal(a, b)


def test_exports_equal_jax():
    def names(mod):
        return sorted(n for n in dir(mod) if n.startswith("tree_"))

    assert names(t_utils) == names(j_utils)
    import repro.core as j_core
    import repro_torch.core as t_core

    for name in ("LatencyModel", "SimResult", "ShardedFlatSpec",
                 "run_vectorized"):
        assert hasattr(j_core, name) and hasattr(t_core, name)
    assert set(n for n in dir(j_core) if not n.startswith("_")) <= set(
        dir(t_core))


ELEMENTWISE = {
    "tree_add": lambda m, a, b: m.tree_add(a, b),
    "tree_sub": lambda m, a, b: m.tree_sub(a, b),
    "tree_scale": lambda m, a, b: m.tree_scale(a, 0.37),
    "tree_axpy": lambda m, a, b: m.tree_axpy(-1.5, a, b),
    "tree_zeros_like": lambda m, a, b: m.tree_zeros_like(a),
    "tree_cast": lambda m, a, b: m.tree_cast(
        a, jnp.bfloat16 if m is j_utils else torch.bfloat16),
}


@pytest.mark.parametrize("name", list(ELEMENTWISE))
def test_elementwise_helpers_equal_jax(name):
    a, b = _np_tree(0), _np_tree(1)
    _same(ELEMENTWISE[name](t_utils, _t(a), _t(b)),
          ELEMENTWISE[name](j_utils, _j(a), _j(b)))


REDUCTIONS = {
    "tree_dot": lambda m, a, b: m.tree_dot(a, b),
    "tree_sq_norm": lambda m, a, b: m.tree_sq_norm(a),
    "tree_sq_dist": lambda m, a, b: m.tree_sq_dist(a, b),
}


@pytest.mark.parametrize("name", list(REDUCTIONS))
def test_reductions_equal_jax(name):
    a, b = _np_tree(2), _np_tree(3)
    got = REDUCTIONS[name](t_utils, _t(a), _t(b))
    want = REDUCTIONS[name](j_utils, _j(a), _j(b))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=SUM_RTOL)


def test_weighted_sum_stack_unstack_equal_jax():
    s = _stacked()
    w = np.asarray([0.2, -1.0, 3.5], np.float32)
    _same(t_utils.tree_weighted_sum(_t(s), torch.from_numpy(w)),
          j_utils.tree_weighted_sum(_j(s), jnp.asarray(w)), rtol=SUM_RTOL)
    parts = t_utils.tree_unstack(_t(s), 3)
    j_parts = j_utils.tree_unstack(_j(s), 3)
    for p, jp in zip(parts, j_parts):
        _same(p, jp)
    _same(t_utils.tree_stack(parts), j_utils.tree_stack(j_parts))


def test_counts_bytes_finite_and_vector_equal_jax():
    a = _np_tree(4)
    a["n"] = np.arange(6, dtype=np.int32)
    ta, ja = _t(a), _j(a)
    assert t_utils.tree_count_params(ta) == j_utils.tree_count_params(ja) == 28
    assert t_utils.tree_bytes(ta) == j_utils.tree_bytes(ja)
    bf = t_utils.tree_cast(ta, torch.bfloat16)
    assert t_utils.tree_bytes(bf) == j_utils.tree_bytes(
        j_utils.tree_cast(ja, jnp.bfloat16))
    assert bool(t_utils.tree_isfinite(ta)) == bool(j_utils.tree_isfinite(ja))
    ta["c"][0, 1] = float("nan")
    ja = _j({**a, "c": ta["c"].numpy()})
    assert bool(t_utils.tree_isfinite(ta)) is bool(j_utils.tree_isfinite(ja)) \
        is False
    assert bool(t_utils.tree_isfinite({"n": ta["n"]})) is True
    np.testing.assert_array_equal(
        t_utils.tree_flatten_to_vector(_t(_np_tree(5))).numpy(),
        np.asarray(j_utils.tree_flatten_to_vector(_j(_np_tree(5)))))


# ---------------------------------------------------------------------------
# the LM example against the JAX example
# ---------------------------------------------------------------------------

ROUND = re.compile(r"round\s+(\d+): probe_ce=([-\d.]+) S_min=([-\d.]+) "
                   r"arrivals=(\d+)")


def test_lm_example_matches_the_jax_example(monkeypatch, capsys):
    spec = importlib.util.spec_from_file_location(
        "jax_train_lm_federated", ROOT / "examples" / "train_lm_federated.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    argv = ["train_lm_federated.py", "--rounds", str(FLAGS["rounds"]),
            "--model-dim", str(FLAGS["model_dim"]), "--layers",
            str(FLAGS["layers"]), "--vocab", str(FLAGS["vocab"]), "--seq",
            str(FLAGS["seq"]), "--batch", str(FLAGS["batch"])]
    monkeypatch.setattr(sys, "argv", argv)
    example.main()
    out = capsys.readouterr().out
    want = [tuple(m.groups()) for m in ROUND.finditer(out)]
    assert len(want) == FLAGS["rounds"]

    cfg = t_example.make_config(FLAGS["model_dim"], FLAGS["layers"],
                                FLAGS["vocab"])
    j_cfg = JModelConfig(**dataclasses.asdict(cfg))
    j_params = jax.device_get(j_build(j_cfg).init(jax.random.PRNGKey(0)))
    lines = []
    got = t_example.run(**FLAGS, device="cpu",
                        init_params=lm_params_from_jax(j_params, "cpu"),
                        log=lines.append)
    assert lines[0] in out.splitlines()  # "model params: N"
    assert lines[-1] == f"final version: {FLAGS['rounds']}"
    assert lines[-1] in out.splitlines()
    for rec, (r, ce, s_min, arrivals) in zip(got, want):
        assert abs(rec["probe_ce"] - float(ce)) <= 5e-5 + 1e-4 * float(ce), r
        assert abs(rec["staleness_min"] - float(s_min)) <= 5e-4 + 1e-3, r
        assert rec["arrivals"] == int(arrivals)
