"""The plain reference against the port's plain CPU path at smoke width,
in float32, on the benchmark's own weights."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import HYMBA_SMOKE, MOE_SMOKE
from portbench.harness import traffic, weights
from portbench.harness.model import model_config
from portbench.reference import lm
from portbench.reference.numerics import Numerics, to_fp8


def port_and_params(cfg, seed=3):
    from repro_torch.models.model import build_model

    mc = model_config(cfg)
    model = build_model(mc, "cpu")
    params = weights.make_weights(build_model(mc, "meta").init(None), seed,
                                  torch.device("cpu"))
    return model, params


def lm_batch(cfg, b, s, seed=5):
    t = traffic.lm_token_stream(cfg["vocab_size"], s, b, seed=seed)
    return {"tokens": torch.as_tensor(t[:, :s]),
            "labels": torch.as_tensor(t[:, 1:])}


@pytest.mark.parametrize("cfg", [HYMBA_SMOKE, MOE_SMOKE], ids=["hybrid", "moe"])
def test_loss_matches_the_port(cfg):
    model, params = port_and_params(cfg)
    batch = lm_batch(cfg, 2, 128)
    want = float(model.loss(params, batch)[0])
    got = float(lm.loss(cfg, params, batch, Numerics("f32")))
    assert got == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("cfg", [HYMBA_SMOKE, MOE_SMOKE], ids=["hybrid", "moe"])
def test_gradients_match_the_port(cfg):
    from torch.func import grad

    model, params = port_and_params(cfg)
    batch = lm_batch(cfg, 1, 64)
    want = grad(lambda p: model.loss(p, batch)[0])(params)
    leaves = lm.fp32_copy(params, requires_grad=True)
    value = lm.loss(cfg, leaves, batch, Numerics("f32"), remat=True)
    value.backward()
    for (path, w), (_, g) in zip(weights.leaves(want), weights.leaves(leaves)):
        assert torch.allclose(g.grad, w, rtol=1e-3, atol=1e-6), path


def test_last_logits_match_the_prefill():
    model, params = port_and_params(HYMBA_SMOKE)
    tokens = lm_batch(HYMBA_SMOKE, 2, 192)["tokens"]
    want = model.prefill_logits(params, {"tokens": tokens})[:, -1]
    got = lm.last_logits(HYMBA_SMOKE, params, tokens, Numerics("f32"))
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-5)


def test_chunked_scan_matches_the_sequential_recurrence(monkeypatch):
    from repro_torch.kernels.ssm_scan.ref import selective_scan_ref

    g = torch.Generator().manual_seed(0)
    b, s, di, n = 2, 256, 8, 4
    x = torch.randn(b, s, di, generator=g)
    dt = torch.rand(b, s, di, generator=g) * 0.3
    bm, cm = torch.randn(b, s, n, generator=g), torch.randn(b, s, n, generator=g)
    a = -torch.rand(di, n, generator=g) * 8
    want = selective_scan_ref(x, dt, bm, cm, a)
    monkeypatch.setattr(lm, "SCAN_CHUNK", 16)
    assert torch.allclose(lm.selective_scan(x, dt, bm, cm, a), want,
                          rtol=1e-4, atol=1e-5)


def test_a_scan_pass_that_overflows_is_run_step_by_step():
    from repro_torch.kernels.ssm_scan.ref import selective_scan_ref

    g = torch.Generator().manual_seed(1)
    b, s, di, n = 1, 64, 4, 4
    x = torch.randn(b, s, di, generator=g)
    dt = torch.full((b, s, di), 60.0)  # 16 steps of dt A reach e^-15360
    bm, cm = torch.randn(b, s, n, generator=g), torch.randn(b, s, n, generator=g)
    a = -torch.arange(1, n + 1, dtype=torch.float32).expand(di, n) * 16
    got = lm.selective_scan(x, dt, bm, cm, a)
    assert torch.isfinite(got).all()
    assert torch.allclose(got, selective_scan_ref(x, dt, bm, cm, a),
                          rtol=1e-4, atol=1e-5)


def test_fp8_rounding_is_coarser_than_bf16():
    t = torch.randn(4096, generator=torch.Generator().manual_seed(1))
    e8 = (to_fp8(t) - t).abs().max() / t.abs().max()
    e16 = (t.to(torch.bfloat16).float() - t).abs().max() / t.abs().max()
    assert e8 > 4 * e16


def test_weights_are_the_seeds_and_shaped_like_the_layout():
    from repro_torch.models.model import build_model

    layout = build_model(model_config(HYMBA_SMOKE), "meta").init(None)
    a = weights.make_weights(layout, 2**33 + 1, torch.device("cpu"))
    b = weights.make_weights(layout, 2**33 + 1, torch.device("cpu"))
    c = weights.make_weights(layout, 2**33 + 2, torch.device("cpu"))
    for (p, x), (_, y), (_, z), (_, m) in zip(
            weights.leaves(a), weights.leaves(b), weights.leaves(c),
            weights.leaves(layout)):
        assert x.shape == m.shape and x.dtype == m.dtype, p
        assert torch.equal(x, y), p
        if weights.is_matrix(p, tuple(x.shape)):
            assert not torch.equal(x, z), p
    np.testing.assert_allclose(
        a["layers"]["ssm"]["A_log"][0, 0].numpy(), np.log(np.arange(1, 5)),
        rtol=1e-6)
