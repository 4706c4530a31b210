"""The port's language-model serving path against the JAX package's.

Both packages get the same weights (the JAX init, carried across with
``lm_params_from_jax``) and the same numpy-made inputs, at f32 on the CPU,
where the port's attention runs K5's plain version and its SSM K6's plain
version. Every architecture of the registry runs at its smoke variant (2
layers, d_model 128): Hymba-1.5B (window 32) carries the hybrid block,
qwen3-1.7b (qk-norm, tied embeddings) and falcon-mamba-7b (SSM only) the
dense and SSM branches, deepseek-moe-16b and arctic-480b the MoE FFN (with
shared experts; with a dense residual FFN), whisper-tiny the encoder and
cross-attention (frames), pixtral-12b the projected patch prefix, and
stablelm-12b (layernorm), gemma-7b (GeGLU, head_dim 32 != d_model / H,
scaled tied embeddings) and qwen1.5-110b (QKV bias) the other dense configs.

Tolerance at f32: rtol 1e-5 with an atol of 1e-5 times the largest
magnitude of the compared output (the same f32 maths in other summation
orders: the JAX package runs its chunked associative scan and XLA's
matmuls, the port a sequential scan and PyTorch's). Greedy tokens are held
equal only where the top-2 logit margin exceeds that tolerance. bf16
forward: rtol and atol 2e-2 times the largest logit (both packages round to
bf16 at the same places, but each matmul's f32 sum may round to the
neighbouring bf16 value, one step of 2^-8 relative, and such steps add up
over 2 layers).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.configs import get_arch as j_get_arch
from repro.configs import list_archs as j_list_archs
from repro.configs import smoke_variant as j_smoke
from repro.models import attention as j_attn
from repro.models import blocks as j_blocks
from repro.models import ssm as j_ssm
from repro.models.model import build_model as j_build
from repro_torch.configs import base as t_base
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.configs import list_archs, smoke_variant
from repro_torch.launch import serve as t_serve
from repro_torch.models import attention as t_attn
from repro_torch.models import blocks as t_blocks
from repro_torch.models import lm_params_from_jax, lm_params_to_jax
from repro_torch.models import ssm as t_ssm
from repro_torch.models.model import build_model as t_build

RTOL = 1e-5
ATOL_REL = 1e-5
BF16_TOL = 2e-2
PORTED = tuple(j_list_archs())
# the architectures this slice brought, and their full-size counts (the JAX
# package's Model.init through jax.eval_shape): params, active params
NEW = {
    "deepseek-moe-16b": (16_879_568_896, 2_830_747_648),
    "arctic-480b": (476_850_275_328, 15_584_314_368),
    "whisper-tiny": (56_379_648, 56_379_648),
    "pixtral-12b": (12_273_996_800, 12_273_996_800),
    "stablelm-12b": (12_143_339_520, 12_143_339_520),
    "gemma-7b": (8_537_680_896, 8_537_680_896),
    "qwen1.5-110b": (111_209_914_368, 111_209_914_368),
}


def _close(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_REL * float(np.abs(want).max()))


def _cfg_pair(arch, **kw):
    jc = j_smoke(j_get_arch(arch).model).replace(**kw)
    tc = smoke_variant(t_get_arch(arch).model).replace(**kw)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def _params(jc, seed=0):
    """JAX init -> (JAX params, the port's params on the CPU)."""
    jp = jax.device_get(j_build(jc).init(jax.random.PRNGKey(seed)))
    return jp, lm_params_from_jax(jp, device="cpu")


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


def _x(b, s, d, seed=1):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(
        np.float32)


def _batch(cfg, b, s, seed=0):
    """tokens, plus the stub frontends' outputs: patches (VLM), frames
    (encoder-decoder); numpy."""
    batch = {"tokens": _tokens(cfg, b, s, seed)}
    if cfg.num_patches:
        batch["patches"] = _x(b, cfg.num_patches, cfg.d_model, seed + 1)
    if cfg.is_encdec:
        batch["frames"] = _x(b, cfg.encoder_seq_len, cfg.d_model, seed + 2)
    return batch


def _to_j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _to_t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def hymba():
    jc, tc = _cfg_pair("hymba-1.5b")
    jp, tp = _params(jc)
    return jc, tc, jp, tp


# ---------------------------------------------------------------- configs


def test_config_dataclasses_match_jax():
    for jcls, tcls in ((j_base.ModelConfig, t_base.ModelConfig),
                       (j_base.ArchConfig, t_base.ArchConfig),
                       (j_base.ShapeConfig, t_base.ShapeConfig)):
        jf = {f.name: (f.default, f.type) for f in dataclasses.fields(jcls)}
        tf = {f.name: (f.default, f.type) for f in dataclasses.fields(tcls)}
        assert jf == tf, tcls.__name__
    assert {k: dataclasses.asdict(v) for k, v in j_base.INPUT_SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in t_base.INPUT_SHAPES.items()}


@pytest.mark.parametrize("arch", PORTED + ("lenet",))
def test_ported_arch_configs_match_jax(arch):
    def prop_of(cfg, name):
        try:
            return getattr(cfg, name)
        except ZeroDivisionError:  # resolved_head_dim of an attention-free arch
            return ZeroDivisionError

    ja, ta = j_get_arch(arch), t_get_arch(arch)
    assert dataclasses.asdict(ja) == dataclasses.asdict(ta)
    jm, tm = ja.model, ta.model
    for prop in ("resolved_head_dim", "is_moe", "is_ssm_only", "is_hybrid",
                 "is_encdec", "ssm_d_inner", "resolved_dt_rank",
                 "resolved_moe_d_ff"):
        assert prop_of(jm, prop) == prop_of(tm, prop), prop
    if arch != "lenet":
        assert dataclasses.asdict(j_smoke(jm)) == \
            dataclasses.asdict(smoke_variant(tm))


def test_registry_knows_only_ported_archs():
    """Every architecture of the JAX registry is ported, in its order."""
    assert list_archs() == j_list_archs()
    with pytest.raises(KeyError, match="unknown arch"):
        t_get_arch("gpt-5")


def test_param_count_matches_jax():
    for arch in PORTED:
        jc, tc = _cfg_pair(arch)
        tm, jm = t_build(tc, "cpu"), j_build(jc)
        assert tm.param_count() == jm.param_count()
        assert tm.active_param_count() == jm.active_param_count()
    # the full-width Hymba-1.5B, shapes only (meta tensors)
    assert t_build(t_get_arch("hymba-1.5b").model, "cpu").param_count() \
        == 1_662_264_000


@pytest.mark.parametrize("arch", sorted(NEW))
def test_full_size_param_counts(arch):
    """The full configs' params and active params on ``meta`` tensors
    (shapes only), equal to the JAX package's counts."""
    tm = t_build(t_get_arch(arch).model, "cpu")
    params = tm.init(None)
    assert params["embed"].device.type == "meta"
    assert (tm.param_count(params), tm.active_param_count(params)) \
        == NEW[arch]


# ------------------------------------------------------------ conversion


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_converter_round_trip(dtype):
    jc, _ = _cfg_pair("hymba-1.5b", param_dtype=dtype, compute_dtype=dtype)
    jp = jax.device_get(j_build(jc).init(jax.random.PRNGKey(3)))
    tp = lm_params_from_jax(jp, device="cpu")
    assert tp["layers"]["attn"]["wq"].shape[0] == jc.num_layers
    want_dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert tp["embed"].dtype == want_dtype
    assert tp["layers"]["ssm"]["A_log"].dtype == torch.float32
    back = lm_params_to_jax(tp)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_b)
    for path, leaf in flat_j:
        got = flat_b[path]
        assert got.dtype == leaf.dtype and got.shape == leaf.shape, path
        assert got.tobytes() == np.asarray(leaf).tobytes(), path
    if dtype == "bfloat16":
        assert back["embed"].dtype == ml_dtypes.bfloat16


@pytest.mark.parametrize("arch,leaves", [
    ("deepseek-moe-16b", [("layers", "moe", "router"),
                          ("layers", "moe", "w_down"),
                          ("layers", "moe", "shared", "w_gate")]),
    ("arctic-480b", [("layers", "moe", "w_up"), ("layers", "mlp", "w_up")]),
    ("whisper-tiny", [("layers", "xattn", "wq"), ("layers", "norm_x", "b"),
                      ("encoder", "layers", "attn", "wk"),
                      ("encoder", "final_norm", "w")]),
    ("pixtral-12b", [("projector",)]),
])
def test_converter_carries_the_new_leaves(arch, leaves):
    """The MoE (f32 router, stacked experts, shared experts), cross-attention,
    encoder and projector leaves cross unchanged, bf16 kept bf16."""
    jc, _ = _cfg_pair(arch, param_dtype="bfloat16", compute_dtype="bfloat16")
    jp = jax.device_get(j_build(jc).init(jax.random.PRNGKey(4)))
    tp = lm_params_from_jax(jp, device="cpu")
    back = lm_params_to_jax(tp)
    for path in leaves:
        j_leaf, t_leaf, b_leaf = jp, tp, back
        for key in path:
            j_leaf, t_leaf, b_leaf = j_leaf[key], t_leaf[key], b_leaf[key]
        assert tuple(t_leaf.shape) == j_leaf.shape, path
        want = torch.float32 if j_leaf.dtype == np.float32 else torch.bfloat16
        assert t_leaf.dtype == want, path
        assert b_leaf.dtype == j_leaf.dtype, path
        assert b_leaf.tobytes() == np.asarray(j_leaf).tobytes(), path
    if jc.is_moe:
        assert tp["layers"]["moe"]["router"].dtype == torch.float32
        assert tp["layers"]["moe"]["w_gate"].shape == (
            jc.num_layers, jc.num_experts, jc.d_model, jc.resolved_moe_d_ff)


# --------------------------------------------------------------- modules


@pytest.mark.parametrize("heads,kv_heads", [(4, 4), (5, 1), (4, 2)])
@pytest.mark.parametrize("window", [None, 0, 16])
def test_attention_train_matches_jax(heads, kv_heads, window):
    jc, tc = _cfg_pair("hymba-1.5b", num_heads=heads, num_kv_heads=kv_heads,
                       head_dim=32)
    jp = jax.device_get(j_attn.init_attention(jax.random.PRNGKey(1), jc))
    tp = lm_params_from_jax(jp, device="cpu")
    x = _x(2, 64, jc.d_model)
    want = j_attn.attention_train(jc, jp, jnp.asarray(x), window=window)
    got = t_attn.attention_train(tc, tp, torch.from_numpy(x), window=window)
    _close(got, want)


def test_qk_norm_bias_attention_matches_jax():
    jc, tc = _cfg_pair("qwen3-1.7b", qkv_bias=True)
    jp = jax.device_get(j_attn.init_attention(jax.random.PRNGKey(2), jc))
    rng = np.random.default_rng(5)
    jp = {k: (v + rng.normal(size=v.shape).astype(np.float32) * 0.1)
          for k, v in jp.items()}  # non-zero biases and norm weights
    tp = lm_params_from_jax(jp, device="cpu")
    x = _x(2, 48, jc.d_model)
    _close(t_attn.attention_train(tc, tp, torch.from_numpy(x)),
           j_attn.attention_train(jc, jp, jnp.asarray(x)))


def test_ssm_train_matches_jax(hymba):
    jc, tc, jp, tp = hymba
    jl = jax.tree.map(lambda a: a[0], jp["layers"])
    tl = t_blocks.layer_view(tp["layers"], 0)
    x = _x(2, 64, jc.d_model)
    _close(t_ssm.ssm_train(tc, tl["ssm"], torch.from_numpy(x)),
           j_ssm.ssm_train(jc, jl["ssm"], jnp.asarray(x)))
    with pytest.raises(ValueError, match="ssm chunk"):
        t_ssm.ssm_train(tc, tl["ssm"], torch.zeros(1, 300, jc.d_model))


def test_softplus_has_no_linear_cutover():
    x = torch.tensor([-30.0, -1.0, 0.0, 5.0, 19.0, 21.0, 40.0])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(t_ssm.softplus(x).numpy(), want, rtol=1e-6,
                               atol=1e-12)


def test_hybrid_layer_matches_jax(hymba):
    jc, tc, jp, tp = hymba
    jl = jax.tree.map(lambda a: a[1], jp["layers"])
    tl = t_blocks.layer_view(tp["layers"], 1)
    x = _x(2, 64, jc.d_model, seed=4)
    jy, _ = j_blocks.decoder_layer_train(jc, jl, jnp.asarray(x))
    ty, _ = t_blocks.decoder_layer_train(tc, tl, torch.from_numpy(x))
    _close(ty, jy)


# ----------------------------------------------------------------- model


@pytest.mark.parametrize("arch", PORTED)
def test_model_apply_and_prefill_match_jax(arch):
    jc, tc = _cfg_pair(arch)
    jp, tp = _params(jc)
    batch = _batch(jc, 2, 64)
    jm, tm = j_build(jc), t_build(tc, device="cpu")
    jl, jaux = jm.apply(jp, _to_j(batch))
    tl, aux = tm.apply(tp, _to_t(batch))
    assert tl.shape == (2, 64, jc.vocab_size)  # text positions only
    if jc.is_moe:
        np.testing.assert_allclose(float(aux), float(jaux), rtol=RTOL)
    else:
        assert float(aux) == 0.0
    _close(tl, jl)
    jpre = jm.prefill_logits(jp, _to_j(batch))
    tpre = tm.prefill_logits(tp, _to_t(batch))
    assert tpre.shape == (2, 1, jc.vocab_size)
    _close(tpre, jpre)


@pytest.mark.parametrize("arch", ["whisper-tiny", "pixtral-12b",
                                  "gemma-7b", "stablelm-12b"])
def test_bf16_prefill_matches_jax(arch):
    """Not the MoE archs: a bf16 step in the router's input flips a near-tie
    expert, and one flipped expert moves its token's output far past any
    rounding tolerance; tests/test_torch_moe.py holds the bf16 MoE under one
    input."""
    jc, tc = _cfg_pair(arch, param_dtype="bfloat16", compute_dtype="bfloat16")
    jp, tp = _params(jc, seed=6)
    batch = _batch(jc, 2, 32, seed=4)
    jpre = j_build(jc).prefill_logits(jp, _to_j(batch))
    tpre = t_build(tc, device="cpu").prefill_logits(tp, _to_t(batch))
    assert tpre.dtype == torch.bfloat16
    np.testing.assert_allclose(
        tpre.float().numpy(), np.asarray(jpre, np.float32), rtol=BF16_TOL,
        atol=BF16_TOL * float(np.abs(np.asarray(jpre, np.float32)).max()))


def _decode_all(m, params, cache, tokens):
    outs = []
    for i in range(tokens.shape[1]):
        lg, cache = m.decode_step(params, cache, tokens[:, i:i + 1], i)
        outs.append(lg[:, 0])
    return torch.stack(outs, dim=1), cache


@pytest.mark.parametrize("arch", [a for a in NEW if a != "pixtral-12b"])
def test_decode_matches_forward(arch):
    """Step-by-step decode == the full forward, per family (as the JAX
    package's tests/test_models.py; the VLM's decode is text only, while its
    forward needs the patch prefix, so it is left out there and here). MoE
    decode is dropless; the smoke variant's cf 8 keeps the forward dropless
    too."""
    jc, tc = _cfg_pair(arch)
    jp, tp = _params(jc, seed=2)
    b, s = 2, 12
    batch = _to_t(_batch(jc, b, s, seed=5))
    tm = t_build(tc, device="cpu")
    cache = tm.init_cache(b, s)
    if tc.is_encdec:
        assert cache["cross"]["k"].shape == (
            tc.num_layers, b, tc.encoder_seq_len, tc.num_kv_heads,
            tc.resolved_head_dim)
        cache = tm.prefill_cross(tp, cache, batch["frames"])
    dec, _ = _decode_all(tm, tp, cache, batch["tokens"])
    full, _ = tm.apply(tp, batch)
    _close(dec, full.detach().numpy())
    jfull, _ = j_build(jc).apply(jp, {k: jnp.asarray(v.numpy())
                                      for k, v in batch.items()})
    _close(dec, jfull)


@pytest.mark.parametrize("arch", sorted(NEW))
def test_decode_step_matches_jax(arch):
    """``decode_step``'s logits at every step and the cache after 10 steps
    (self K/V, and the cross K/V of the encoder-decoder), pixtral included."""
    jc, tc = _cfg_pair(arch)
    jp, tp = _params(jc, seed=3)
    b, s = 2, 10
    batch = _batch(jc, b, s, seed=6)
    jm, tm = j_build(jc), t_build(tc, device="cpu")
    jcache, tcache = jm.init_cache(b, s), tm.init_cache(b, s)
    if jc.is_encdec:
        jcache = jm.prefill_cross(jp, jcache, jnp.asarray(batch["frames"]))
        tm.prefill_cross(tp, tcache, torch.from_numpy(batch["frames"]))
    step = jax.jit(jm.decode_step)
    tokens = batch["tokens"]
    for i in range(s):
        jl, jcache = step(jp, jcache, jnp.asarray(tokens[:, i:i + 1]),
                          jnp.int32(i))
        tl, _ = tm.decode_step(tp, tcache, torch.from_numpy(
            tokens[:, i:i + 1]), i)
        _close(tl, jl)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jcache):
        got = tcache
        for key in path:
            got = got[key.key]
        _close(got, leaf)


def test_decode_matches_forward_past_the_window(hymba):
    """The ring cache wraps: S = 80 tokens through a 32-slot cache."""
    jc, tc, jp, tp = hymba
    assert tc.attn_window == 32
    b, s = 2, 80
    tokens = _tokens(jc, b, s, seed=2)
    tm = t_build(tc, device="cpu")
    cache = tm.init_cache(b, s)
    assert cache["kv"]["k"].shape == (tc.num_layers, b, 32, tc.num_kv_heads,
                                      tc.resolved_head_dim)
    assert cache["ssm"]["h"].shape == (tc.num_layers, b, tc.ssm_d_inner,
                                       tc.ssm_state)
    t_tok = torch.from_numpy(tokens)
    outs = []
    for i in range(s):
        lg, cache = tm.decode_step(tp, cache, t_tok[:, i:i + 1], i)
        outs.append(lg[:, 0])
    dec = torch.stack(outs, dim=1)
    full, _ = tm.apply(tp, {"tokens": t_tok})
    _close(dec, full.detach().numpy())
    jfull, _ = j_build(jc).apply(jp, {"tokens": jnp.asarray(tokens)})
    _close(dec, jfull)


def test_decode_cache_matches_jax(hymba):
    """Cache contents (ring K/V, SSM state, conv tail) after 40 steps."""
    jc, tc, jp, tp = hymba
    b, s = 1, 40
    tokens = _tokens(jc, b, s, seed=3)
    jm, tm = j_build(jc), t_build(tc, device="cpu")
    jcache, tcache = jm.init_cache(b, s), tm.init_cache(b, s)
    step = jax.jit(jm.decode_step)
    for i in range(s):
        _, jcache = step(jp, jcache, jnp.asarray(tokens[:, i:i + 1]),
                         jnp.int32(i))
        tm.decode_step(tp, tcache, torch.from_numpy(tokens[:, i:i + 1]), i)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jcache):
        got = tcache
        for key in path:
            got = got[key.key]
        _close(got, leaf)


def _jax_serve_greedy(jc, jp, prompt, gen, frames=None):
    """The JAX launcher's loop (``repro/launch/serve.py``), greedy."""
    jm = j_build(jc)
    step = jax.jit(jm.decode_step)
    cache = jm.init_cache(prompt.shape[0], prompt.shape[1] + gen)
    if frames is not None:
        cache = jm.prefill_cross(jp, cache, jnp.asarray(frames))
    logits = None
    for i in range(prompt.shape[1]):
        logits, cache = step(jp, cache, jnp.asarray(prompt[:, i:i + 1]),
                             jnp.int32(i))
    tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    out, all_logits = [tok], [logits[:, -1]]
    for g in range(gen):
        logits, cache = step(jp, cache, tok, jnp.int32(prompt.shape[1] + g))
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        out.append(tok)
        all_logits.append(logits[:, -1])
    return (np.concatenate([np.asarray(t) for t in out], axis=1),
            np.stack([np.asarray(lg) for lg in all_logits], axis=1))


def _check_greedy(got, want, logits):
    batch, n = want.shape
    assert got.shape == (batch, n)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    tol = RTOL * np.abs(logits).max(axis=-1) + ATOL_REL * np.abs(logits).max()
    # a token decides the rest of its row: compare each row up to its first
    # near-tie
    checked = 0
    for r in range(batch):
        for t in range(n):
            if margin[r, t] <= 4 * tol[r, t]:
                break
            assert got[r, t] == want[r, t], (r, t)
            checked += 1
    assert checked >= batch * n // 2


def test_serve_greedy_ids_match_jax(hymba):
    jc, tc, jp, tp = hymba
    batch, prompt_len, gen = 4, 32, 16
    prompt = np.random.default_rng(0).integers(0, jc.vocab_size,
                                               (batch, prompt_len))
    want, logits = _jax_serve_greedy(jc, jp, prompt, gen)
    res = t_serve.generate(t_build(tc, device="cpu"), tp,
                           torch.from_numpy(prompt), gen)
    assert res["decode_tok_s"] > 0
    _check_greedy(res["tokens"], want, logits)


def test_serve_main_encdec_matches_jax_loop():
    """``serve.main`` for whisper-tiny (smoke) draws the frames, then the
    prompt, from ``default_rng(0)`` as the JAX launcher does and fills the
    cross cache; the JAX loop on the same weights (the port's init, carried
    to JAX) gives the same greedy ids."""
    res = t_serve.main(["--arch", "whisper-tiny", "--smoke", "--device",
                        "cpu"])
    jc, tc = _cfg_pair("whisper-tiny")
    init_gen, _ = t_serve.split_generator(0, torch.device("cpu"))
    jp = lm_params_to_jax(t_build(tc, device="cpu").init(init_gen))
    rng = np.random.default_rng(0)
    frames = rng.normal(size=(4, jc.encoder_seq_len, jc.d_model)).astype(
        np.float32)
    prompt = rng.integers(0, jc.vocab_size, (4, 32))
    want, logits = _jax_serve_greedy(jc, jp, prompt, 16, frames=frames)
    _check_greedy(res["tokens"], want, logits)


def test_serve_main_on_cpu(capsys):
    res = t_serve.main(["--arch", "falcon-mamba-7b", "--smoke", "--batch",
                        "2", "--prompt-len", "8", "--gen", "4",
                        "--temperature", "0.7", "--device", "cpu"])
    assert res["tokens"].shape == (2, 5)
    assert "decode:" in capsys.readouterr().out
