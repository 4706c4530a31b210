"""The port's language-model serving path against the JAX package's.

Both packages get the same weights (the JAX init, carried across with
``lm_params_from_jax``) and the same numpy-made inputs, at f32 on the CPU,
where the port's attention runs K5's plain version and its SSM K6's plain
version. The smoke variant of Hymba-1.5B (2 layers, d_model 128, window 32)
carries the hybrid block; those of qwen3-1.7b (dense, qk-norm, tied
embeddings) and falcon-mamba-7b (SSM only) carry its other two branches.

Tolerance at f32: rtol 1e-5 with an atol of 1e-5 times the largest
magnitude of the compared output (the same f32 maths in other summation
orders: the JAX package runs its chunked associative scan and XLA's
matmuls, the port a sequential scan and PyTorch's). Greedy tokens are held
equal only where the top-2 logit margin exceeds that tolerance.
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
PORTED = ("hymba-1.5b", "qwen3-1.7b", "falcon-mamba-7b")


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
    assert list_archs() == list(PORTED)
    with pytest.raises(KeyError, match="Slice F"):
        t_get_arch("arctic-480b")


def test_unported_branches_raise():
    jc = j_smoke(j_get_arch("deepseek-moe-16b").model)
    cfg = t_base.ModelConfig(**dataclasses.asdict(jc))
    with pytest.raises(NotImplementedError, match="Slice F"):
        t_build(cfg, device="cpu")


def test_param_count_matches_jax():
    for arch in PORTED:
        jc, tc = _cfg_pair(arch)
        assert t_build(tc, "cpu").param_count() == j_build(jc).param_count()
    # the full-width Hymba-1.5B, shapes only (meta tensors)
    assert t_build(t_get_arch("hymba-1.5b").model, "cpu").param_count() \
        == 1_662_264_000


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
    tokens = _tokens(jc, 2, 64)
    jm, tm = j_build(jc), t_build(tc, device="cpu")
    jl, _ = jm.apply(jp, {"tokens": jnp.asarray(tokens)})
    tl, aux = tm.apply(tp, {"tokens": torch.from_numpy(tokens)})
    assert float(aux) == 0.0
    _close(tl, jl)
    jpre = jm.prefill_logits(jp, {"tokens": jnp.asarray(tokens)})
    tpre = tm.prefill_logits(tp, {"tokens": torch.from_numpy(tokens)})
    assert tpre.shape == (2, 1, jc.vocab_size)
    _close(tpre, jpre)


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


def _jax_serve_greedy(jc, jp, prompt, gen):
    """The JAX launcher's loop (``repro/launch/serve.py``), greedy."""
    jm = j_build(jc)
    step = jax.jit(jm.decode_step)
    cache = jm.init_cache(prompt.shape[0], prompt.shape[1] + gen)
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


def test_serve_greedy_ids_match_jax(hymba):
    jc, tc, jp, tp = hymba
    batch, prompt_len, gen = 4, 32, 16
    prompt = np.random.default_rng(0).integers(0, jc.vocab_size,
                                               (batch, prompt_len))
    want, logits = _jax_serve_greedy(jc, jp, prompt, gen)
    res = t_serve.generate(t_build(tc, device="cpu"), tp,
                           torch.from_numpy(prompt), gen)
    got = res["tokens"]
    assert got.shape == (batch, gen + 1) and res["decode_tok_s"] > 0
    top2 = np.sort(logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    tol = RTOL * np.abs(logits).max(axis=-1) + ATOL_REL * np.abs(logits).max()
    # a token decides the rest of its row: compare each row up to its first
    # near-tie
    checked = 0
    for r in range(batch):
        for t in range(gen + 1):
            if margin[r, t] <= 4 * tol[r, t]:
                break
            assert got[r, t] == want[r, t], (r, t)
            checked += 1
    assert checked >= batch * (gen + 1) // 2


def test_serve_main_on_cpu(capsys):
    res = t_serve.main(["--arch", "falcon-mamba-7b", "--smoke", "--batch",
                        "2", "--prompt-len", "8", "--gen", "4",
                        "--temperature", "0.7", "--device", "cpu"])
    assert res["tokens"].shape == (2, 5)
    assert "decode:" in capsys.readouterr().out
