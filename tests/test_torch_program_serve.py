"""The prefill and decode steps of the port's ``launch/program.py``
Programs against the JAX package's ``prefill_logits`` and
``decode_step``, at ``smoke_variant`` width on the CPU, on JAX's init
carried across and the same numpy tokens
(``tests/test_torch_program_inputs.py``).
Tolerance: ``tests/test_torch_lm.py``'s for the logits (rtol 1e-5, atol
1e-5 of the largest).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models.model import build_model as j_build
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import program as t_program
from repro_torch.launch.mesh import ShapeMesh
from repro_torch.models.model import build_model
from test_torch_program_inputs import S, batch_like, smoke, tokens

RTOL, ATOL_REL = 1e-5, 1e-5


def _logits_close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=RTOL,
                               atol=ATOL_REL * float(np.abs(want).max()))


def test_prefill_and_decode_programs_match_jax():
    jc, over, jp, tp = smoke("hymba-1.5b")
    j_model = j_build(jc)
    j_params = jax.tree.map(jnp.asarray, jp)
    mesh = ShapeMesh((1, 1), ("data", "model"))
    rng = np.random.default_rng(2)

    pre = t_program.build_program(
        "hymba-1.5b", "prefill_32k", mesh, model_overrides=over,
        shape=ShapeConfig("prefill_32k", S, 2, "prefill"), device="cpu")
    batch = batch_like(pre.arg_sds[1], jc.vocab_size, rng)
    _logits_close(pre.step_fn(tp, batch), j_model.prefill_logits(
        j_params, jax.tree.map(jnp.asarray, batch)))

    dec = t_program.build_program(
        "hymba-1.5b", "decode_32k", mesh, model_overrides=over,
        shape=ShapeConfig("decode_32k", S, 2, "decode"), device="cpu")
    assert dec.meta["cache_len"] == min(S, jc.attn_window)
    cache = build_model(smoke_variant(get_arch("hymba-1.5b").model),
                        "cpu").init_cache(2, S)
    j_cache = j_model.init_cache(2, S)
    for pos in range(3):
        tok = tokens(rng, dec.arg_sds[2], jc.vocab_size)
        got, cache = dec.step_fn(tp, cache, torch.from_numpy(tok),
                                 torch.tensor(pos, dtype=torch.int32))
        want, j_cache = j_model.decode_step(j_params, j_cache,
                                            jnp.asarray(tok), pos)
        _logits_close(got, want)
