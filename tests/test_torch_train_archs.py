"""Training of the MoE, encoder-decoder and patch archs in the port against
the JAX package's.

Both packages get the same weights (the JAX init, carried across with
``lm_params_from_jax``) and the same numpy-made batches, at f32 on the CPU
(K5's plain version and its plain backward on the port's side); the JAX
package differentiates its jnp paths with ``jax.value_and_grad``. The port
takes its gradients as the cohort round does: ``torch.func.vmap`` of
``torch.func.grad`` over 2 slots.

Tolerances, with their reasons:

* loss and aux values: rtol 1e-5 (the same f32 forward in other summation
  orders, as ``tests/test_torch_train.py``);
* gradients: atol 1e-4 times the largest |gradient| of the tree, as
  ``tests/test_torch_train.py`` (a backward through the smoke stack sums
  over every token and head in other orders);
* the MoE routing (expert ids, the dropped (token, choice) pairs) exact:
  a different drop would move a gradient by a whole token's term;
* vmap over slots against separate calls: rtol 1e-5, atol 1e-6 (the same
  arithmetic, batched);
* the cohort step, 2 rounds in ``reference`` mode against JAX's jitted
  ``make_cohort_step``: round metrics rtol 1e-3, final params atol 1e-5,
  as ``tests/test_torch_train.py`` holds the Hymba round.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from repro.configs import base as j_base
from repro.configs import get_arch as j_get_arch
from repro.configs import smoke_variant as j_smoke
from repro.core.cohort import init_cohort_state as j_init_cohort
from repro.core.cohort import make_cohort_step as j_make_cohort_step
from repro.models import moe as j_moe
from repro.models.model import build_model as j_build
from repro_torch.configs import base as t_base
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.configs import smoke_variant
from repro_torch.launch import train as t_train
from repro_torch.models import lm_params_from_jax
from repro_torch.models import moe as t_moe
from repro_torch.models.model import build_model as t_build
from repro_torch.utils.tree import tree_leaves, tree_map, tree_paths

LOSS_RTOL = 1e-5
GRAD_ATOL_REL = 1e-4
B, S = 2, 40
SLOTS = 2
MOE_ARCHS = ["deepseek-moe-16b", "arctic-480b"]


def _cfg_pair(arch, **kw):
    jc = j_smoke(j_get_arch(arch).model).replace(**kw)
    tc = smoke_variant(t_get_arch(arch).model).replace(**kw)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def _params(jc, seed=0):
    jp = jax.device_get(j_build(jc).init(jax.random.PRNGKey(seed)))
    return jp, lm_params_from_jax(jp, device="cpu")


def _batch(cfg, b=B, s=S, seed=0):
    rng = np.random.default_rng(seed)
    s = s - (cfg.num_patches or 0)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1))
    batch = {"tokens": toks[:, :s], "labels": toks[:, 1:]}
    if cfg.num_patches:
        batch["patches"] = rng.normal(
            size=(b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        batch["frames"] = rng.normal(
            size=(b, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    return batch


def _to_j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _to_t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _leaves_j(tree):
    """JAX leaves in the port's leaf order (sorted keys at every level)."""
    return [np.asarray(leaf, np.float32) for leaf in jax.tree.leaves(tree)]


def _close_tree(got, want, atol_rel=GRAD_ATOL_REL):
    paths = tree_paths(got)
    got = [g.detach().float().numpy() for g in tree_leaves(got)]
    want = _leaves_j(want)
    assert len(got) == len(want)
    scale = max(float(np.abs(w).max()) for w in want)
    for path, g, w in zip(paths, got, want):
        assert g.shape == w.shape, path
        np.testing.assert_allclose(g, w, rtol=0.0, atol=atol_rel * scale,
                                   err_msg="/".join(path))


def _skewed_batch(cfg, seed):
    """Tokens drawn from 3 ids: tokens that share an id share their route
    through the first MoE layer, so cf 1.25 overflows experts."""
    batch = _batch(cfg, seed=seed)
    ids = np.random.default_rng(seed).integers(0, cfg.vocab_size, 3)
    toks = ids[np.random.default_rng(seed + 7).integers(0, 3, (B, S + 1))]
    batch["tokens"], batch["labels"] = toks[:, :S], toks[:, 1:]
    return batch


class _Plans:
    """Records the dispatch plans the port's MoE layers make."""

    def __init__(self, monkeypatch):
        self.dropped = 0
        inner = t_moe.dispatch_plan

        def recorded(cfg, expert_ids, cap):
            plan = inner(cfg, expert_ids, cap)
            self.dropped += int((~plan.keep).sum())
            return plan

        monkeypatch.setattr(t_moe, "dispatch_plan", recorded)


def _slots_grad(model, tp, batches):
    """vmap(grad(Model.loss)) over the slots, each on its own batch, and
    the same params in every slot (as a freshly synced cohort)."""
    params = tree_map(lambda p: p[None].expand((len(batches),) + p.shape)
                      .clone(), tp)
    stacked = {k: torch.stack([_to_t(b)[k] for b in batches])
               for k in batches[0]}
    return vmap(grad(lambda p, b: model.loss(p, b)[0]))(params, stacked)


# ----------------------------------------------------------- MoE layer


def _jax_routing(jc, jp, xf, cap):
    """Expert ids and dropped (token, choice) pairs of one group, by the
    lines of ``repro/models/moe.py::_dispatch_group``."""
    e, k = jc.num_experts, jc.experts_per_token
    probs = jax.nn.softmax(jnp.asarray(xf) @ jp["router"], axis=-1)
    _, expert_ids = jax.lax.top_k(probs, k)
    flat_e = expert_ids.reshape(-1)
    sort_idx = jnp.argsort(flat_e)
    sorted_e = flat_e[sort_idx]
    counts = jax.ops.segment_sum(jnp.ones_like(sorted_e), sorted_e,
                                 num_segments=e)
    offsets = jnp.concatenate([jnp.zeros((1,), counts.dtype),
                               jnp.cumsum(counts)[:-1]])
    keep = (jnp.arange(flat_e.shape[0]) - offsets[sorted_e]) < cap
    return np.asarray(expert_ids), {
        (int(i) // k, int(i) % k)
        for i in np.asarray(sort_idx)[~np.asarray(keep)]}


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_moe_layer_vmap_grad_matches_jax(arch, cf):
    """The MoE layer alone: ``sum(y * w) + aux`` differentiated in the
    params and the input, vmapped over 2 slots with their own inputs,
    against ``jax.value_and_grad``. At cf 1.25 tokens are dropped (the
    keep mask and the spare row at e * cap take part), at the smoke's 8.0
    none; the router's gradient carries the aux loss's."""
    jc, tc = _cfg_pair(arch, moe_capacity_factor=cf)
    key = jax.random.PRNGKey(0)
    jp = jax.device_get(j_moe.init_moe(key, jc))
    tp = lm_params_from_jax(jp, device="cpu")
    rng = np.random.default_rng(1)
    # a direction shared by every token skews the routing toward a few
    # experts, so that cf 1.25 drops some of their tokens
    xs = (rng.normal(size=(SLOTS, B, S, jc.d_model))
          + 2.0 * rng.normal(size=jc.d_model)).astype(np.float32)
    w = rng.normal(size=(B, S, jc.d_model)).astype(np.float32)

    def j_loss(p, x):
        y, aux = j_moe.moe_ffn(jc, p, x)
        return jnp.sum(y * w) + aux

    def t_loss(p, x):
        y, aux = t_moe.moe_ffn(tc, p, x)
        return torch.sum(y * torch.from_numpy(w)) + aux

    stacked = tree_map(lambda p: p[None].expand((SLOTS,) + p.shape).clone(),
                       tp)
    t_gp, t_gx = vmap(grad(t_loss, argnums=(0, 1)))(stacked,
                                                     torch.from_numpy(xs))
    cap = t_moe.capacity(tc, B * S, cf)
    dropped = 0
    for i in range(SLOTS):
        j_val, (j_gp, j_gx) = jax.value_and_grad(j_loss, argnums=(0, 1))(
            jp, jnp.asarray(xs[i]))
        x_i = torch.from_numpy(xs[i])
        np.testing.assert_allclose(float(t_loss(tp, x_i)), float(j_val),
                                   rtol=LOSS_RTOL)
        _close_tree(tree_map(lambda g: g[i], t_gp), j_gp)
        scale = float(np.abs(np.asarray(j_gx)).max())
        np.testing.assert_allclose(t_gx[i].numpy(), np.asarray(j_gx),
                                   rtol=0, atol=GRAD_ATOL_REL * scale)
        xf = xs[i].reshape(B * S, -1)
        j_ids, j_drop = _jax_routing(jc, jp, xf, cap)
        _, _, t_ids = t_moe.route(tc, tp, torch.from_numpy(xf))
        plan = t_moe.dispatch_plan(tc, t_ids, cap)
        k = tc.experts_per_token
        np.testing.assert_array_equal(t_ids.numpy(), j_ids)
        assert {(int(e) // k, int(e) % k)
                for e in plan.sort_idx[~plan.keep].tolist()} == j_drop
        dropped += len(j_drop)
    assert (dropped > 0) == (cf < 8.0)


# ------------------------------------------------------ Model.loss, MoE


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_moe_model_loss_vmap_grad_matches_jax(arch, cf, monkeypatch):
    """``vmap(grad(Model.loss))`` of the MoE archs (arctic-480b with its
    dense residual FFN) over 2 slots, against ``jax.value_and_grad`` of
    ``Model.loss`` on each slot's batch; loss and aux values too. The
    batches' tokens are skewed so that cf 1.25 drops tokens (counted on the
    port's side)."""
    jc, tc = _cfg_pair(arch, moe_capacity_factor=cf)
    jp, tp = _params(jc)
    batches = [_skewed_batch(tc, seed=i) for i in range(SLOTS)]
    model = t_build(tc, "cpu")
    got = _slots_grad(model, tp, batches)
    plans = _Plans(monkeypatch)
    for i, batch in enumerate(batches):
        (j_loss, j_mets), j_grads = jax.value_and_grad(
            lambda p: j_build(jc).loss(p, _to_j(batch)), has_aux=True)(jp)
        t_loss, t_mets = model.loss(tp, _to_t(batch))
        np.testing.assert_allclose(float(t_loss), float(j_loss),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(t_mets["aux"]), float(j_mets["aux"]),
                                   rtol=LOSS_RTOL)
        _close_tree(tree_map(lambda g: g[i], got), j_grads)
    assert (plans.dropped > 0) == (cf < 8.0)


# ------------------------------------------ encoder-decoder and patches


@pytest.mark.parametrize("arch", ["whisper-tiny", "pixtral-12b"])
def test_encdec_and_patch_grads_match_jax(arch):
    """whisper-tiny (the encoder stack under remat, cross-attention) and
    pixtral-12b (the projected patches before the text): gradients against
    ``jax.value_and_grad``, and vmap over 2 slots against separate
    ``grad`` calls."""
    jc, tc = _cfg_pair(arch)
    jp, tp = _params(jc)
    batches = [_batch(tc, seed=i) for i in range(SLOTS)]
    model = t_build(tc, "cpu")
    together = _slots_grad(model, tp, batches)
    loss_grad = grad(lambda p, b: model.loss(p, b)[0])
    for i, batch in enumerate(batches):
        (j_loss, _), j_grads = jax.value_and_grad(
            lambda p: j_build(jc).loss(p, _to_j(batch)), has_aux=True)(jp)
        np.testing.assert_allclose(float(model.loss(tp, _to_t(batch))[0]),
                                   float(j_loss), rtol=LOSS_RTOL)
        one = loss_grad(tp, _to_t(batch))
        _close_tree(one, j_grads)
        for a, b in zip(tree_leaves(together), tree_leaves(one)):
            torch.testing.assert_close(a[i], b, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------- the cohort step


@pytest.mark.parametrize("arch,kw", [
    ("deepseek-moe-16b", {"moe_capacity_factor": 1.25}),
    ("whisper-tiny", {}),
    ("pixtral-12b", {}),
])
def test_cohort_step_matches_jax(arch, kw):
    """C = 3 slots, K = 2, M = 2, b = 1, 2 rounds of the launcher's arrival
    schedule in ``reference`` mode against JAX's jitted
    ``make_cohort_step`` on the same weights and batches."""
    jc, tc = _cfg_pair(arch, **kw)
    jp, tp = _params(jc)
    fl = dict(buffer_size=2, local_steps=2, local_lr=5e-3, weighting="paper",
              server_pass_mode="reference")
    seq = 24 + (tc.num_patches or 0)
    loop = t_train.TrainLoop(tc, t_base.FLConfig(**fl), cohort=3, batch=1,
                             seq=seq, rounds=2, device="cpu", params=tp)
    j_step = jax.jit(j_make_cohort_step(j_build(jc).loss,
                                        j_base.FLConfig(**fl)))
    j_state = j_init_cohort(jax.tree.map(jnp.asarray, jp), 3)
    for r in range(2):
        batch = loop.next_batch(r)
        loop.state, t_mets = loop.step(loop.state, batch)
        j_batch = jax.tree.map(jnp.asarray, {
            **batch, "data_sizes": np.asarray(batch["data_sizes"])})
        j_state, j_mets = j_step(j_state, j_batch)
        for key in ("fresh_loss_mean", "staleness_min", "weights_max",
                    "update_sq_norm"):
            np.testing.assert_allclose(float(t_mets[key]), float(j_mets[key]),
                                       rtol=1e-3, err_msg=f"round {r} {key}")
    np.testing.assert_array_equal(loop.state.client_version.numpy(),
                                  np.asarray(j_state.client_version))
    for name in ("global_params", "client_params", "client_base"):
        for a, b in zip(tree_leaves(getattr(loop.state, name)),
                        _leaves_j(getattr(j_state, name))):
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5,
                                       err_msg=name)
