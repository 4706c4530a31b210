"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package's.

Both get the JAX init's weights (carried across with
``lm_params_from_jax``) and the same numpy-made inputs on the CPU. The
routing is held exactly: the same top-k expert ids (ties to the lower id,
``jax.lax.top_k``'s order) and the same set of (token, choice) pairs
dropped over capacity, which the JAX side reads by the lines of its own
``_dispatch_group``. ``y`` and ``aux`` at f32: rtol 1e-5, atol 1e-5 times
the largest |y| (the same f32 maths, XLA's and PyTorch's matmuls summing in
other orders).

bf16 (the full configs' dtype): both packages run the expert products and
the combine in bf16, rounding at the same places, but each matmul rounds
its f32 sum to bf16 once, so one element may land one bf16 step (2^-8
relative, 2^-7 just above a power of two) away after each of the
expert's three products and the combine's adds: rtol 2e-2, atol 2e-2 times
the largest |y|, the same tolerance as ``tests/test_torch_lm.py``'s bf16
forward.

Under an active tracer (``obs.trace``) each token group's dispatch and
combine are one ``moe_dispatch`` and one ``moe_combine`` span, in that
order, with the same output bits as untraced; with no active tracer
nothing is recorded.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs import smoke_variant as j_smoke
from repro.models import blocks as j_blocks
from repro.models import moe as j_moe
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.configs import smoke_variant
from repro_torch.models import blocks as t_blocks
from repro_torch.models import lm_params_from_jax
from repro_torch.models import moe as t_moe
from repro_torch.obs import NULL_TRACER, Tracer
from repro_torch.obs import trace as ttrace

RTOL = ATOL_REL = 1e-5
BF16_TOL = 2e-2


def _cfg_pair(arch, **kw):
    jc = j_smoke(j_get_arch(arch).model).replace(**kw)
    tc = smoke_variant(t_get_arch(arch).model).replace(**kw)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def _moe_params(jc, seed=0):
    jp = jax.device_get(j_moe.init_moe(jax.random.PRNGKey(seed), jc))
    return jp, lm_params_from_jax(jp, device="cpu")


def _x(b, s, d, seed=1, dtype=np.float32):
    x = np.random.default_rng(seed).normal(size=(b, s, d)).astype(np.float32)
    return x.astype(dtype)


def _close(got, want, rtol=RTOL, atol_rel=ATOL_REL):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * float(np.abs(want).max()))


def _jax_routing(jc, jp, xf, cap):
    """Expert ids and the dropped (token, choice) pairs of one group, by the
    lines of ``repro/models/moe.py::_dispatch_group``."""
    e, k = jc.num_experts, jc.experts_per_token
    probs = jax.nn.softmax(jnp.asarray(xf).astype(jnp.float32) @ jp["router"],
                           axis=-1)
    _, expert_ids = jax.lax.top_k(probs, k)
    flat_e = expert_ids.reshape(-1)
    sort_idx = jnp.argsort(flat_e)
    sorted_e = flat_e[sort_idx]
    counts = jax.ops.segment_sum(jnp.ones_like(sorted_e), sorted_e,
                                 num_segments=e)
    offsets = jnp.concatenate([jnp.zeros((1,), counts.dtype),
                               jnp.cumsum(counts)[:-1]])
    keep = (jnp.arange(flat_e.shape[0]) - offsets[sorted_e]) < cap
    dropped = {(int(i) // k, int(i) % k)
               for i in np.asarray(sort_idx)[~np.asarray(keep)]}
    return np.asarray(expert_ids), dropped


def _port_routing(tc, tp, xf, cap):
    _, _, expert_ids = t_moe.route(tc, tp, torch.from_numpy(xf))
    plan = t_moe.dispatch_plan(tc, expert_ids, cap)
    k = tc.experts_per_token
    dropped = {(int(i) // k, int(i) % k)
               for i in plan.sort_idx[~plan.keep].tolist()}
    return expert_ids.numpy(), dropped


@pytest.mark.parametrize("cf,groups", [(None, 1), (1.0, 1), (None, 2),
                                       (1.0, 2), (0.5, 1)])
def test_moe_ffn_matches_jax(cf, groups):
    """As written (the smoke variant's cf 8: dropless), and at cf 1.0 and
    0.5 with drops, in one group and in two."""
    jc, tc = _cfg_pair("deepseek-moe-16b", moe_groups=groups)
    jp, tp = _moe_params(jc)
    b, s = 2, 32
    x = _x(b, s, jc.d_model)
    jy, jaux = j_moe.moe_ffn(jc, jp, jnp.asarray(x), capacity_factor=cf)
    ty, taux = t_moe.moe_ffn(tc, tp, torch.from_numpy(x), capacity_factor=cf)
    _close(ty, jy)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=RTOL)

    tg = b * s // groups
    cap = t_moe.capacity(tc, tg, tc.moe_capacity_factor if cf is None
                         else cf)
    n_dropped = 0
    for xf in x.reshape(groups, tg, -1):
        j_ids, j_drop = _jax_routing(jc, jp, xf, cap)
        t_ids, t_drop = _port_routing(tc, tp, xf, cap)
        np.testing.assert_array_equal(t_ids, j_ids)
        assert t_drop == j_drop
        n_dropped += len(t_drop)
    assert (n_dropped > 0) == (cf is not None)


def test_top_k_ties_go_to_the_lower_expert():
    """Equal router probabilities: ``jax.lax.top_k`` takes the lower ids;
    so does ``route`` (a stable sort, not ``torch.topk``)."""
    jc, tc = _cfg_pair("deepseek-moe-16b")
    jp, tp = _moe_params(jc)
    router = np.zeros_like(jp["router"])
    router[:, 1] = router[:, 3] = 0.5  # experts 1 and 3 tie at the top
    jp = dict(jp, router=router)
    tp = dict(tp, router=torch.from_numpy(router))
    xf = np.abs(_x(1, 8, jc.d_model)[0])
    j_ids, _ = _jax_routing(jc, jp, xf, cap=16)
    t_ids, _ = _port_routing(tc, tp, xf, cap=16)
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_array_equal(t_ids, np.tile([1, 3], (8, 1)))


def test_dispatch_combine_under_a_shared_routing():
    """``dispatch_combine`` given JAX's own routing reproduces JAX's y: the
    split the card checks rely on."""
    jc, tc = _cfg_pair("deepseek-moe-16b", num_shared_experts=0)
    jp, tp = _moe_params(jc)
    xf = _x(1, 48, jc.d_model)[0]
    cap = t_moe.capacity(tc, 48, 1.0)
    jy, _ = j_moe._dispatch_group(jc, jp, jnp.asarray(xf), cap)
    probs, gates, ids = t_moe.route(tc, tp, torch.from_numpy(xf))
    j_ids, _ = _jax_routing(jc, jp, xf, cap)
    np.testing.assert_array_equal(ids.numpy(), j_ids)
    _close(t_moe.dispatch_combine(tc, tp, torch.from_numpy(xf), gates,
                                  torch.from_numpy(j_ids.copy()), cap), jy)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_dense_residual_layer_matches_jax():
    """arctic: the dense MLP in parallel with the MoE in every layer."""
    jc, tc = _cfg_pair("arctic-480b")
    assert jc.dense_residual_ff
    jp = jax.device_get(j_blocks.init_layer(jax.random.PRNGKey(4), jc))
    tp = lm_params_from_jax(jp, device="cpu")
    assert set(tp) >= {"moe", "mlp"}
    x = _x(2, 24, jc.d_model, seed=2)
    jy, jaux = j_blocks.decoder_layer_train(jc, jp, jnp.asarray(x))
    ty, taux = t_blocks.decoder_layer_train(tc, tp, torch.from_numpy(x))
    _close(ty, jy)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=RTOL)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "arctic-480b"])
def test_moe_ffn_bf16_matches_jax(arch):
    jc, tc = _cfg_pair(arch, param_dtype="bfloat16",
                       compute_dtype="bfloat16")
    jp, tp = _moe_params(jc, seed=5)
    assert tp["w_gate"].dtype == torch.bfloat16
    assert tp["router"].dtype == torch.float32
    x = _x(2, 32, jc.d_model, seed=3, dtype=ml_dtypes.bfloat16)
    jy, jaux = j_moe.moe_ffn(jc, jp, jnp.asarray(x), capacity_factor=1.0)
    ty, taux = t_moe.moe_ffn(tc, tp, torch.from_numpy(
        x.astype(np.float32)).to(torch.bfloat16), capacity_factor=1.0)
    assert ty.dtype == torch.bfloat16
    _close(ty, jy, rtol=BF16_TOL, atol_rel=BF16_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def test_decode_is_dropless():
    """S == 1: the capacity factor rises to E / k, so no token drops even
    when every token picks the same experts."""
    jc, tc = _cfg_pair("deepseek-moe-16b", moe_capacity_factor=0.25)
    jp, tp = _moe_params(jc)
    x = np.repeat(_x(1, 1, jc.d_model), 16, axis=0)  # (16, 1, d), one route
    jy, _ = j_moe.moe_ffn(jc, jp, jnp.asarray(x))
    ty, _ = t_moe.moe_ffn(tc, tp, torch.from_numpy(x))
    _close(ty, jy)
    np.testing.assert_allclose(ty[1:].numpy(), np.repeat(ty[:1].numpy(), 15,
                                                         axis=0), rtol=1e-6)


@pytest.mark.parametrize("groups", [1, 2])
def test_moe_spans(groups):
    jc, tc = _cfg_pair("deepseek-moe-16b", moe_groups=groups)
    _, tp = _moe_params(jc)
    x = torch.from_numpy(_x(2, 8, tc.d_model))
    want, _ = t_moe.moe_ffn(tc, tp, x)
    assert NULL_TRACER.edges == []
    tr = Tracer(annotate=False)
    with tr.activate():
        got, _ = t_moe.moe_ffn(tc, tp, x)
    assert torch.equal(got, want)
    names = [e.name for e in tr.edges]
    assert names == [ttrace.SPAN_MOE_DISPATCH, ttrace.SPAN_MOE_COMBINE] \
        * groups
    for first, then in zip(tr.edges, tr.edges[1:]):
        assert first.end_ns <= then.start_ns
    assert {e["cat"] for e in tr.to_json()["traceEvents"]} == {"moe"}
