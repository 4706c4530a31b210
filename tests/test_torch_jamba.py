"""Jamba2-Mini on the port: the layered stack (Mamba-1 and NoPE attention
mixers, MLP and MoE FFNs by a layer period), the inner dt/B/C norms, the
ungated top-k and the held share of the experts, against the benchmark's
plain reference (``portbench/reference/jamba.py``, which imports nothing of
the program) on the port's seeded weights, at smoke width in float32.

Tolerances: the program and the reference compute the same f32 maths in
different orders (the SSM scan step by step against the reference's
chunked closed form, attention through K5's plain version against query
blocks, experts as segments or a capacity buffer against one call per
expert), so logits, losses and gradients agree to ~1e-6 relative; they are
held at 1e-4 of the largest magnitude (rtol 1e-4 on scalars). Decode
against the full forward is the same f32 maths in other orders: 1e-4 of the
largest logit. The dropless and the capacity path share every product and
differ only in which rows a matmul sees: 1e-5.

The JAX package has no layered stack, so nothing here compares with it; the
file imports nothing of JAX. The ``cuda`` tests skip without a card.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.reference import jamba as ref  # noqa: E402
from portbench.reference.lm import fp32_copy  # noqa: E402
from portbench.reference.numerics import Numerics  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    get_arch,
    list_archs,
    smoke_variant,
)
from repro_torch.configs.jamba2_mini import (  # noqa: E402
    PUBLISHED,
    config_from_dict,
)
from repro_torch.configs.layered import LayeredConfig  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.model import LayeredModel, build_model  # noqa: E402
from repro_torch.obs.metrics import default_registry  # noqa: E402
from repro_torch.obs.trace import LAYER_SPAN_NAMES, Tracer  # noqa: E402
from repro_torch.utils import fold  # noqa: E402

F32 = Numerics("f32")


def smoke(**kw) -> LayeredConfig:
    return smoke_variant(get_arch("jamba2-mini").model).replace(**kw)


def ref_cfg(cfg: LayeredConfig) -> dict:
    """The reference's configuration (transformers' keys) of a config."""
    return {"num_hidden_layers": cfg.num_layers, "hidden_size": cfg.d_model,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "num_experts": cfg.num_experts,
            "num_experts_per_tok": cfg.experts_per_token,
            "experts_held": cfg.experts_held,
            "mamba_d_state": cfg.ssm_state, "mamba_expand": cfg.ssm_expand,
            "mamba_dt_rank": cfg.resolved_dt_rank,
            "attn_layer_period": cfg.attn_layer_period,
            "attn_layer_offset": cfg.attn_layer_offset,
            "expert_layer_period": cfg.expert_layer_period,
            "expert_layer_offset": cfg.expert_layer_offset,
            "router_aux_loss_coef": cfg.router_aux_coef}


def _perturb_norms(tree, gen):
    """Norm weights (the ``w`` leaves) off their init 0, so that the ``1 +
    w`` scale is exercised."""
    for key, val in tree.items():
        if isinstance(val, dict):
            _perturb_norms(val, gen)
        elif key == "w":
            val.add_(0.2 * torch.randn(val.shape, generator=gen))


def model_and_params(cfg, seed=0):
    model = build_model(cfg, "cpu")
    gen = torch.Generator().manual_seed(seed)
    params = model.init(gen)
    _perturb_norms(params, gen)
    return model, params


def tokens(cfg, b, s, seed=1):
    return torch.randint(0, cfg.vocab_size, (b, s),
                         generator=torch.Generator().manual_seed(seed))


def close(got, want, tol=1e-4):
    got, want = got.detach().float(), want.detach().float()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    assert err <= tol * scale, f"max err {err} vs {tol} x {scale}"


# ------------------------------------------------------------- the config


def test_config_published_and_registered():
    cfg = get_arch("jamba2-mini").model
    assert isinstance(cfg, LayeredConfig)
    assert "jamba2-mini" not in list_archs()
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.ssm_d_inner, cfg.ssm_state,
            cfg.resolved_dt_rank, cfg.num_experts, cfg.experts_per_token,
            cfg.resolved_moe_d_ff, cfg.vocab_size) == \
        (32, 4096, 32, 8, 128, 8192, 16, 256, 16, 2, 14336, 65536)
    assert not cfg.rope_theta  # and the layered model adds no sinusoid
    model = build_model(cfg, "cpu")
    assert isinstance(model, LayeredModel)
    # 52B-A12B as published (meta tensors: shapes only)
    params = model.init(None)
    assert model.param_count(params) == 51_570_323_328
    assert model.active_param_count(params) == 12_110_311_296
    with pytest.raises(ValueError, match="not a Jamba"):
        config_from_dict(dict(PUBLISHED, model_type="llama"))


def test_smoke_variant_keeps_the_subclass():
    cfg = smoke()
    assert isinstance(cfg, LayeredConfig)
    assert cfg.num_layers == 8 and cfg.num_kv_heads == 1
    assert cfg.resolved_dt_rank == 8
    assert smoke_variant(get_arch("jamba2-mini").model.replace(
        experts_held=8)).experts_held == 2
    plain = get_arch("hymba-1.5b").model
    assert type(smoke_variant(plain)) is type(plain)


@pytest.mark.parametrize("layers", [32, 16, 8])
def test_layer_schedule_matches_the_published_period(layers):
    """JambaConfig.layers_block_type / layers_num_experts: attention at i %
    8 == 4, the MoE at odd i."""
    cfg = get_arch("jamba2-mini").model.replace(num_layers=layers)
    attn = [i for i in range(layers) if i % 8 == 4]
    moe = [i for i in range(layers) if i % 2 == 1]
    sched = cfg.schedule
    assert [i for i, s in enumerate(sched) if s[0] == "attn"] == attn
    assert [i for i, s in enumerate(sched) if s[2] == "moe"] == moe
    assert cfg.layer_counts() == {"attn": len(attn),
                                  "ssm": layers - len(attn),
                                  "moe": len(moe), "mlp": layers - len(moe)}
    for i, (mixer, mi, ffn, fi) in enumerate(sched):
        assert (mixer, ffn) == ref.kinds(ref_cfg(cfg), i)
        same = [s for s in sched[:i] if s[0] == mixer]
        assert mi == len(same)
        assert fi == len([s for s in sched[:i] if s[2] == ffn])
    if layers == 16:  # the benchmark's cut: two whole periods
        assert (len(attn), layers - len(attn), len(moe)) == (2, 14, 8)


def test_params_grouped_by_kind_with_one_stack_axis():
    cfg = smoke(experts_held=2)
    params = build_model(cfg, "cpu").init(None)
    lay = params["layers"]
    assert set(lay) == {"norm1", "norm2", "ssm", "attn", "mlp", "moe"}
    assert lay["norm1"]["w"].shape == (8, cfg.d_model)
    assert lay["ssm"]["in_proj"].shape[0] == 7
    assert lay["attn"]["wq"].shape[0] == 1
    assert lay["mlp"]["w_gate"].shape[0] == 4
    assert lay["moe"]["w_gate"].shape[:2] == (4, 2)  # 2 of 4 held
    assert lay["moe"]["router"].shape == (4, cfg.d_model, 4)  # all routed
    assert lay["ssm"]["dt_norm"]["w"].shape == (7, cfg.resolved_dt_rank)
    assert lay["ssm"]["b_norm"]["w"].shape == (7, cfg.ssm_state)


# -------------------------------------------------- program vs reference


@pytest.mark.parametrize("held", [0, 2])
def test_prefill_logits_match_the_reference(held):
    cfg = smoke(experts_held=held)
    model, params = model_and_params(cfg)
    tok = tokens(cfg, 2, 32)
    with torch.no_grad():
        got = model.prefill_logits(params, {"tokens": tok})[:, -1]
        want = ref.last_logits(ref_cfg(cfg), params, tok, F32)
    close(got, want)


def test_loss_and_gradient_match_the_reference():
    cfg = smoke(experts_held=2)
    model, params = model_and_params(cfg, seed=3)
    tok = tokens(cfg, 2, 17, seed=4)
    batch = {"tokens": tok[:, :16], "labels": tok[:, 1:]}

    def loss_fn(p):
        return model.loss(p, batch)[0]

    got_grad = torch.func.grad(loss_fn)(params)
    got = loss_fn(params)
    leaves = fp32_copy(params, requires_grad=True)
    want = ref.loss(ref_cfg(cfg), leaves, batch, F32)
    want.backward()
    assert float(got) == pytest.approx(float(want.detach()), rel=1e-4)

    def walk(g, w, path=()):
        if isinstance(g, dict):
            for k in g:
                walk(g[k], w[k], path + (k,))
            return
        assert w.grad is not None, path
        close(g, w.grad)

    walk(got_grad, leaves)


@pytest.mark.parametrize("held", [2, 0], ids=["jamba", "all-held"])
def test_prefill_then_decode_matches_the_full_forward(held):
    cfg = smoke(experts_held=held)
    model, params = model_and_params(cfg, seed=5)
    b, s = 2, 12
    tok = tokens(cfg, b, s, seed=6)
    cache = model.init_cache(b, s)
    counts = cfg.layer_counts()
    assert set(cache) == {"attn", "ssm"}
    assert cache["attn"]["k"].shape == (counts["attn"], b, s,
                                        cfg.num_kv_heads,
                                        cfg.resolved_head_dim)
    assert cache["ssm"]["h"].shape == (counts["ssm"], b, cfg.ssm_d_inner,
                                       cfg.ssm_state)
    with torch.no_grad():
        steps = [model.decode_step(params, cache, tok[:, i:i + 1], i)[0]
                 for i in range(s)]
        full, _ = model.apply(params, {"tokens": tok})
        last = model.prefill_logits(params, {"tokens": tok})
    close(torch.cat(steps, dim=1), full)
    close(last, full[:, -1:])


def test_top2_gates_are_not_renormalised():
    cfg = smoke()
    _, params = model_and_params(cfg, seed=7)
    p = {k: v[0] for k, v in params["layers"]["moe"].items()}
    xf = torch.randn(24, cfg.d_model,
                     generator=torch.Generator().manual_seed(8))
    probs, gates, ids = moe_mod.route_share(cfg, p, xf)
    top = torch.sort(probs, dim=-1, descending=True).values[:, :2]
    torch.testing.assert_close(gates, top, rtol=0, atol=0)
    assert float(gates.sum(-1).max()) < 1.0 - 1e-3
    assert (ids[:, 0] != ids[:, 1]).all()
    # the layer's output weighs each held expert by the raw gate
    y, _ = moe_mod.moe_share_ffn(cfg, p, xf[None])
    yr, _ = ref.moe(ref_cfg(cfg), p, xf[None], F32)
    close(y, yr)


def _half(p, first: bool, e: int):
    """A layer holding experts [0, e/2) or, with the router's columns
    rotated so they come first, [e/2, e)."""
    h = e // 2
    if first:
        return {k: (v if k == "router" else v[:h]) for k, v in p.items()}
    perm = torch.cat([torch.arange(h, e), torch.arange(0, h)])
    return {k: (v[:, perm] if k == "router" else v[h:]) for k, v in p.items()}


@pytest.mark.parametrize("path", ["dropless", "capacity"])
def test_two_expert_shares_add_up_to_the_whole_layer(path):
    """The two halves' partial outputs (each holding 2 of 4 experts, the
    router whole) add up to the reference layer holding all 4; the
    capacity path runs under vmap, as in the cohort round."""
    cfg = smoke()
    _, params = model_and_params(cfg, seed=9)
    p = {k: v[1] for k, v in params["layers"]["moe"].items()}
    x = torch.randn(2, 16, cfg.d_model,
                    generator=torch.Generator().manual_seed(10))
    half = cfg.replace(experts_held=2)

    def run(pp):
        if path == "dropless":
            return moe_mod.moe_share_ffn(half, pp, x)[0]
        return torch.func.vmap(
            lambda xx: moe_mod.moe_share_ffn(half, pp, xx[None])[0][0])(x)

    parts = [run(_half(p, first, 4)) for first in (True, False)]
    whole, _ = ref.moe(ref_cfg(cfg), p, x, F32)
    close(parts[0] + parts[1], whole)
    # neither half alone is the whole layer
    assert float((parts[0] - whole).abs().max()) > 1e-2 * float(
        whole.abs().max())


def test_dropless_and_capacity_paths_agree_and_count_pairs():
    cfg = smoke(experts_held=3)
    _, params = model_and_params(cfg, seed=11)
    p = {k: v[0] for k, v in params["layers"]["moe"].items()}
    x = torch.randn(1, 40, cfg.d_model,
                    generator=torch.Generator().manual_seed(12))
    reg = default_registry()
    held0 = reg.counter("moe.pairs_held").value
    absent0 = reg.counter("moe.pairs_absent").value
    y_drop, aux_drop = moe_mod.moe_share_ffn(cfg, p, x)
    held = reg.counter("moe.pairs_held").value - held0
    absent = reg.counter("moe.pairs_absent").value - absent0
    _, _, ids = moe_mod.route_share(cfg, p, x[0])
    assert held == int((ids < 3).sum()) and held + absent == 80
    y_cap = torch.func.vmap(
        lambda xx: moe_mod.moe_share_ffn(cfg, p, xx)[0])(x[None])[0]
    close(y_drop, y_cap, tol=1e-5)


def test_vmap_grad_takes_the_capacity_path(monkeypatch):
    """Under ``vmap(grad)`` (the cohort round) the share FFN never reaches
    the segment dispatch, which reads on the host; outside a transform it
    does."""
    from repro_torch.models import moe_segments

    cfg = smoke(experts_held=2)
    _, params = model_and_params(cfg, seed=13)
    p = {k: v[0] for k, v in params["layers"]["moe"].items()}
    x = torch.randn(2, 1, 8, cfg.d_model,
                    generator=torch.Generator().manual_seed(14))
    real = moe_segments.dropless_share
    calls = []

    def watched(*args):
        calls.append(fold.level())
        return real(*args)

    monkeypatch.setattr(moe_segments, "dropless_share", watched)

    def loss(pp, xx):
        y, aux = moe_mod.moe_share_ffn(cfg, pp, xx)
        return y.square().sum() + aux

    g = torch.func.vmap(torch.func.grad(loss), in_dims=(None, 0))(p, x)
    assert not calls
    assert g["router"].shape == (2,) + p["router"].shape
    with torch.no_grad():
        moe_mod.moe_share_ffn(cfg, p, x[0])
    assert calls == [None]


def test_spans_of_the_layered_stack():
    cfg = smoke(experts_held=2)
    model, params = model_and_params(cfg)
    tracer = Tracer(annotate=False)
    with torch.no_grad(), tracer.activate():
        model.prefill_logits(params, {"tokens": tokens(cfg, 1, 16)})
    names = [e.name for e in tracer.edges]
    counts = cfg.layer_counts()
    assert names.count("ssm_mixer") == counts["ssm"]
    assert names.count("attn_mixer") == counts["attn"]
    assert names.count("moe_ffn") == counts["moe"]
    assert set(LAYER_SPAN_NAMES) <= set(names)
    # moe_dispatch / moe_combine lie inside moe_ffn
    ffn = [e for e in tracer.edges if e.name == "moe_ffn"]
    for e in tracer.edges:
        if e.name in ("moe_dispatch", "moe_combine"):
            assert any(f.start_ns <= e.start_ns and e.end_ns <= f.end_ns
                       for f in ffn)


def test_one_cohort_round_runs_and_stays_finite():
    from repro_torch.configs.base import FLConfig
    from repro_torch.launch.train import TrainLoop
    from repro_torch.utils.tree import tree_leaves

    cfg = smoke(experts_held=2)
    fl = FLConfig(buffer_size=2, local_steps=2, local_lr=5e-3,
                  weighting="paper", server_pass_mode="reference")
    loop = TrainLoop(cfg, fl, cohort=2, batch=1, seq=16, rounds=1,
                     device="cpu")
    before = [t.clone() for t in tree_leaves(loop.state.global_params)]
    metrics = loop.round(0)
    assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
    after = tree_leaves(loop.state.global_params)
    assert all(bool(torch.isfinite(t).all()) for t in after)
    assert any(not torch.equal(a, b) for a, b in zip(after, before))


def test_config_dict_fields_are_the_published_ones():
    """``config_from_dict`` reads transformers' keys; ``experts_held`` is the
    deployment's share."""
    cfg = config_from_dict(dict(PUBLISHED, num_hidden_layers=16,
                                experts_held=8))
    assert (cfg.num_layers, cfg.num_experts, cfg.experts_held) == (16, 16, 8)
    assert cfg.resolved_experts_held == 8
    fields = {f.name for f in dataclasses.fields(cfg)}
    assert {"attn_layer_period", "expert_layer_offset",
            "experts_held"} <= fields


# ----------------------------------------------------------------- card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_k6_at_the_cell_shape_reads_its_last_channels(cuda):
    """K6 at B x S x d_inner = 2 x 65,536 x 8,192 (2^30 elements): the last
    32 channels of the second sequence against the plain scan of those
    channels alone (channels are independent): rtol 1e-4 / atol 1e-5 times
    the largest |y|, as K6 against its plain version."""
    from repro_torch.kernels.ssm_scan import ops as ss_ops
    from repro_torch.kernels.ssm_scan import ref as ss_ref

    b, s, di, n = 2, 65536, 8192, 16
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(b, s, di, device=cuda, generator=gen)
    dt = torch.rand(b, s, di, device=cuda, generator=gen) * 0.02
    bm = torch.randn(b, s, n, device=cuda, generator=gen)
    cm = torch.randn(b, s, n, device=cuda, generator=gen)
    a = -torch.rand(di, n, device=cuda, generator=gen) - 0.5
    y = ss_ops.selective_scan(x, dt, bm, cm, a)
    lo = di - 32
    want = ss_ref.selective_scan_ref(
        x[1:, :, lo:].contiguous().cpu(), dt[1:, :, lo:].contiguous().cpu(),
        bm[1:].cpu(), cm[1:].cpu(), a[lo:].cpu())
    got = y[1:, :, lo:].cpu()
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.cuda
def test_smoke_jamba_on_the_card_matches_the_reference(cuda):
    """The smoke model's prefill on the card (K5, K6, the RMSNorm kernel at
    widths 8 and 16 for dt, B and C) against the reference on the CPU, f32:
    1e-4 of the largest logit."""
    cfg = smoke(experts_held=2)
    model, params = model_and_params(cfg)
    tok = tokens(cfg, 2, 64)
    want = ref.last_logits(ref_cfg(cfg), params, tok, F32)
    def to(t):
        return {k: to(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.to(cuda)

    with torch.no_grad():
        got = build_model(cfg, cuda).prefill_logits(
            to(params), {"tokens": tok.to(cuda)})[:, -1].cpu()
    close(got, want)
