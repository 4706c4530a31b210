"""The ``jamba2-mini-prefill-b2-s64k`` cell's pieces on the CPU: a whole run
of ``drivers/prefill_layered.py`` at smoke width against
``reference/jamba.py`` (``correct`` on the program as it is, not with a
fault planted underneath), the FLOPs and kernel-bound counts of
``flops/jamba.py`` at the cell's configuration, and the two span readers on
a synthetic capture. The limits are 1e-3 on ``logit_gap`` (float32 smoke
runs read ~1e-6) and 0.05 on ``route_flip_share`` (they read 0: the
reference's router agrees with the program's on every token)."""
from __future__ import annotations

import json
import time

import pytest
import torch

import portbench.run as run
from portbench.flops import jamba as jamba_flops
from portbench.harness.bench import HERE, Cell, benchmark, load_json, \
    load_module
from portbench.rooflines import bound_s
from portbench.rooflines import kernels as rk

CELL = "jamba2-mini-prefill-b2-s64k"
CARD = "NVIDIA H100 80GB HBM3"
JAMBA_SMOKE = {
    "name": "jamba-smoke", "model_type": "jamba", "hidden_act": "silu",
    "num_hidden_layers": 8, "hidden_size": 128, "num_attention_heads": 4,
    "num_key_value_heads": 1, "intermediate_size": 64, "vocab_size": 256,
    "num_experts": 4, "num_experts_per_tok": 2, "experts_held": 2,
    "mamba_d_state": 4, "mamba_d_conv": 4, "mamba_expand": 2,
    "mamba_dt_rank": 4, "attn_layer_period": 8, "attn_layer_offset": 4,
    "expert_layer_period": 2, "expert_layer_offset": 1,
    "router_aux_loss_coef": 0.001, "sliding_window": None,
    "tie_word_embeddings": False, "param_dtype": "float32",
    "compute_dtype": "float32",
}
MIX_SMOKE = {"driver": "prefill_layered", "batch": 2, "seq": 64,
             "pool_requests": 3, "checked_requests": 2, "traced_requests": 1}


def smoke_cell():
    bench = benchmark()
    entry = {w["name"]: w for w in bench["workloads"]}[CELL]
    return Cell.from_parts(CELL, entry, dict(JAMBA_SMOKE), dict(MIX_SMOKE),
                           {"logit_gap": 1e-3, "route_flip_share": 0.05},
                           bench)


def execute(cell, seed=2**31 + 11):
    return run.execute(cell, seed, 0.2, False, "cpu", time.perf_counter())


def test_the_cell_finds_its_files():
    cell = Cell(CELL)
    assert cell.mix["driver"] == "prefill_layered"
    assert cell.driver().__name__ == "portbench_driver_prefill_layered"
    assert set(load_json(HERE / "cells" / f"{CELL}.json")["limits"]) == \
        {"logit_gap", "route_flip_share"}
    names = [m["name"] for m in cell.per_layer]
    assert {"ssm_mixer_device_ms.prefill", "moe_ffn_device_ms.prefill",
            "prefill_mfu", "k5_fwd_roofline.prefill",
            "k6_fwd_roofline.prefill", "device_idle_share.prefill"} \
        == set(names)
    assert [m["name"] for m in cell.end_to_end] == [
        "prefill_tokens_per_s", "peak_gib", "setup_s"]


def test_a_sound_run_is_correct():
    out = execute(smoke_cell())
    assert out["correct"], out["checks"]
    assert out["checks"]["route_flip_share"]["value"] == 0.0
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    json.dumps(out)


def renormalised(monkeypatch):
    import repro_torch.models.moe as moe

    real = moe.route_share

    def route(cfg, p, xf):
        probs, gates, ids = real(cfg, p, xf)
        return probs, gates / gates.sum(-1, keepdim=True), ids

    monkeypatch.setattr(moe, "route_share", route)


def routes_shifted(monkeypatch):
    """The program takes the experts ranked 2nd to (k+1)th: the
    reference runs the same choices, so only the flip share sees it."""
    import repro_torch.models.moe as moe

    def route(cfg, p, xf):
        probs = torch.softmax(xf.float() @ p["router"], dim=-1)
        vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
        k = cfg.experts_per_token
        return probs, vals[:, 1:k + 1], ids[:, 1:k + 1]

    monkeypatch.setattr(moe, "route_share", route)


def no_dt_norm(monkeypatch):
    import repro_torch.models.ssm as ssm

    def inputs(cfg, p, x):
        n, dtr = cfg.ssm_state, cfg.resolved_dt_rank
        dt, b_, c_ = torch.split((x @ p["x_proj"]).float(), [dtr, n, n], -1)
        b_ = ssm.rms_norm(b_, p["b_norm"]["w"])
        c_ = ssm.rms_norm(c_, p["c_norm"]["w"])
        return ssm.softplus(dt @ p["dt_proj"] + p["dt_bias"]), b_, c_

    monkeypatch.setattr(ssm, "normed_ssm_inputs", inputs)


def answer_altered(monkeypatch):
    from repro_torch.models.model import LayeredModel

    real = LayeredModel.prefill_logits

    def broken(self, params, batch, window=None):
        out = real(self, params, batch, window).clone()
        out[0, -1, 0] += 1.0
        return out

    monkeypatch.setattr(LayeredModel, "prefill_logits", broken)


@pytest.mark.parametrize("fault", [renormalised, routes_shifted, no_dt_norm,
                                   answer_altered],
                         ids=["gates-renormalised", "routes-shifted",
                              "dt-norm-dropped", "answer-altered"])
def test_a_broken_prefill_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = execute(smoke_cell())
    assert not out["correct"], out["checks"]


def test_flops_and_bounds_at_the_cell():
    cell = Cell(CELL)
    cfg, mix = cell.config, cell.mix
    assert jamba_flops.layer_counts(cfg) == {"attn": 2, "ssm": 14,
                                             "mlp": 8, "moe": 8}
    w = jamba_flops.kind_weights(cfg)
    d, ff = 4096, 3 * 4096 * 14336
    # the router over 16, and k x held / E = 2 x 8 / 16 = 1 expert a token
    assert w["moe"] == d * 16 + ff * 1.0
    assert w["mlp"] == ff
    b, s = 2, 65536
    bounds = jamba_flops.kernel_bounds(cfg, mix, CARD)
    assert bounds["k5_fwd"] == pytest.approx(
        2 * bound_s(rk.k5_fwd(b, s, 32, 8, 128, 0), CARD))
    assert bounds["k6_fwd"] == pytest.approx(
        14 * bound_s(rk.k6_fwd(b, s, 8192, 16), CARD))
    total = jamba_flops.prefill_request(cfg, mix)
    assert 1.28e15 < total < 1.30e15  # ~1.29 PFLOP a request
    attn = 2 * 4.0 * d * rk.visible_pairs(s, 0) * b
    assert 0.10 < attn / total < 0.12  # NoPE attention is ~11% of it


def reader(name):
    return load_module(HERE / "metrics" / f"{name}.py",
                       "m_" + name.replace(".", "_"))


@pytest.mark.parametrize("name,span", [
    ("ssm_mixer_device_ms.prefill", "ssm_mixer"),
    ("moe_ffn_device_ms.prefill", "moe_ffn")])
def test_span_readers_on_a_synthetic_capture(name, span):
    facts = {"spans": {"rounds": 2, "host_ns": {span: 5_000_000},
                       "device_ms": {"ssm_mixer": 1400.0, "moe_ffn": 600.0,
                                     "attn_mixer": 300.0}}}
    want = {"ssm_mixer": 700.0, "moe_ffn": 300.0}[span]
    assert reader(name).read(facts) == pytest.approx(want)
    # a program without the spans: nothing to read, no error
    assert reader(name).read({"spans": None}) is None
    assert reader(name).read({}) is None
    assert reader(name).read({"spans": {"rounds": 1, "host_ns": {},
                                        "device_ms": {}}}) is None
