"""Shared inputs of ``tests/test_torch_program_{cohort,dist,serve}.py``: an
arch's ``smoke_variant`` config in both packages, JAX's init (jitted: only
the values matter, and both packages get the same ones) carried across
with ``lm_params_from_jax``, and numpy batches shaped like a Program's
``meta`` arguments."""
import dataclasses
import functools

import jax
import numpy as np
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs import smoke_variant as j_smoke
from repro.models.model import build_model as j_build
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.models import lm_params_from_jax
from repro_torch.utils.tree import tree_leaves

S = 40  # beyond the smoke window (32): the band mask runs


@functools.lru_cache(maxsize=None)
def smoke(arch):
    jc = j_smoke(j_get_arch(arch).model)
    tc = smoke_variant(get_arch(arch).model)
    overrides = dataclasses.asdict(tc)
    assert dataclasses.asdict(jc) == overrides
    jp = jax.device_get(jax.jit(j_build(jc).init)(jax.random.PRNGKey(0)))
    return jc, overrides, jp, lm_params_from_jax(jp, device="cpu")


def tokens(rng, like, vocab):
    """Random int32 tokens shaped like a meta tensor of ``arg_sds``."""
    return rng.integers(0, vocab, tuple(like.shape)).astype(np.int32)


def batch_like(sds, vocab, rng):
    if isinstance(sds, dict):
        return {k: batch_like(v, vocab, rng) for k, v in sds.items()}
    if sds.dtype == torch.int32:
        return tokens(rng, sds, vocab)
    return rng.normal(size=tuple(sds.shape)).astype(np.float32)


def close_trees(got, want, atol):
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=atol)
