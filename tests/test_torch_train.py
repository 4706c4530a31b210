"""LM training in the port against the JAX package's.

Both packages get the same weights (the JAX init, carried across with
``lm_params_from_jax``) and the same numpy-made batches, at f32 on the CPU,
where the port's attention and SSM run K5's and K6's plain versions, and
their backward the plain backward formulas (``ref.py``), through the
kernel ``autograd.Function``s and their ``vmap`` rules. The JAX package
differentiates its jnp paths with ``jax.grad``.

Tolerances, with their reasons:

* ``Model.loss`` value: rtol 1e-5 (the same f32 forward in other summation
  orders, as ``tests/test_torch_lm.py``); its gradients: atol 1e-4 times the
  largest |gradient| of the tree (a backward through 2 layers sums over
  every token and head in other orders; the remat paths change no number in
  either package).
* Optimizers and schedules: rtol 1e-6 over 5 steps (elementwise f32 maths).
* The cohort step over ``Model.loss``, 3 rounds in ``reference`` mode: the
  round metrics rtol 1e-3 and the final params atol 1e-5 (the local steps
  move the weights by lr * grad, so the gradient's 1e-4 relative error
  lands far below this on the params; eq. 3-5 weights amplify a relative
  difference of the probe losses and distances by at most a few times).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._C._functorch import is_functorch_wrapped_tensor
from torch.func import grad, vmap

from repro.configs import base as j_base
from repro.configs import get_arch as j_get_arch
from repro.configs import smoke_variant as j_smoke
from repro.core.cohort import init_cohort_state as j_init_cohort
from repro.core.cohort import make_cohort_step as j_make_cohort_step
from repro.core.simulator import LatencyModel as JLatencyModel
from repro.launch import train as j_train
from repro.models.model import build_model as j_build
from repro.optim import optimizers as j_opt
from repro.optim import schedules as j_sched
from repro_torch.configs import base as t_base
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.configs import smoke_variant
from repro_torch.kernels.flash_attn import ref as fa_ref
from repro_torch.kernels.ssm_scan import ref as ss_ref
from repro_torch.launch import train as t_train
from repro_torch.models import lm_params_from_jax
from repro_torch.models.model import build_model as t_build
from repro_torch.optim import optimizers as t_opt
from repro_torch.optim import schedules as t_sched
from repro_torch.sim.scenarios import LatencyModel as TLatencyModel
from repro_torch.utils.tree import tree_leaves, tree_map, tree_paths

LOSS_RTOL = 1e-5
GRAD_ATOL_REL = 1e-4
B, S = 2, 40  # S beyond the smoke window (32): the band mask runs


def _cfg_pair(arch, **kw):
    jc = j_smoke(j_get_arch(arch).model).replace(**kw)
    tc = smoke_variant(t_get_arch(arch).model).replace(**kw)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def _params(jc, seed=0):
    jp = jax.device_get(j_build(jc).init(jax.random.PRNGKey(seed)))
    return jp, lm_params_from_jax(jp, device="cpu")


def _batch(cfg, b=B, s=S, seed=0):
    """tokens, labels and the stub frontends' outputs; numpy."""
    rng = np.random.default_rng(seed)
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


def _close_tree(got, want, atol_rel, rtol=0.0):
    paths = tree_paths(got)
    got = [g.detach().float().numpy() for g in tree_leaves(got)]
    want = _leaves_j(want)
    assert len(got) == len(want)
    scale = max(float(np.abs(w).max()) for w in want)
    for path, g, w in zip(paths, got, want):
        assert g.shape == w.shape, path
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol_rel * scale,
                                   err_msg="/".join(path))


# ------------------------------------------------------------- Model.loss


@pytest.fixture(scope="module")
def hymba_params():
    jc, _ = _cfg_pair("hymba-1.5b")
    return _params(jc)


@pytest.mark.parametrize("ce_chunk,remat_block", [(0, 0), (7, 0), (0, 2),
                                                  (7, 2)])
def test_hymba_loss_and_grads_match_jax(hymba_params, ce_chunk, remat_block):
    """ce_chunk 7 over B * S = 80 tokens leaves a ragged last chunk of 3;
    remat_block 2 rematerialises the 2 layers as one group."""
    jc, tc = _cfg_pair("hymba-1.5b", ce_chunk=ce_chunk,
                       remat_block=remat_block)
    jp, tp = hymba_params
    batch = _batch(tc)
    (j_loss, j_mets), j_grads = jax.value_and_grad(
        lambda p: j_build(jc).loss(p, _to_j(batch)), has_aux=True)(jp)
    model = t_build(tc, "cpu")
    t_loss, t_mets = model.loss(tp, _to_t(batch))
    t_grads = grad(lambda p: model.loss(p, _to_t(batch))[0])(tp)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(t_mets["ce"]), float(j_mets["ce"]),
                               rtol=LOSS_RTOL)
    _close_tree(t_grads, j_grads, GRAD_ATOL_REL)


def test_remat_and_ce_chunk_change_no_number(hymba_params):
    """The port's four paths give the same gradients to f32 rounding of the
    logits' sums (the chunked cross-entropy sums its chunks in another
    order); remat alone changes no bit."""
    _, tp = hymba_params
    batch = _to_t(_batch(smoke_variant(t_get_arch("hymba-1.5b").model)))
    grads = {}
    for ce_chunk, remat_block in ((0, 0), (0, 2), (7, 0)):
        tc = smoke_variant(t_get_arch("hymba-1.5b").model).replace(
            ce_chunk=ce_chunk, remat_block=remat_block)
        model = t_build(tc, "cpu")
        grads[ce_chunk, remat_block] = tree_leaves(
            grad(lambda p: model.loss(p, batch)[0])(tp))
    for a, b in zip(grads[0, 0], grads[0, 2]):
        assert torch.equal(a, b)
    scale = max(float(g.abs().max()) for g in grads[0, 0])
    for a, b in zip(grads[0, 0], grads[7, 0]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "whisper-tiny",
                                  "pixtral-12b"])
def test_loss_value_matches_jax(arch):
    """A dense, an encoder-decoder and a patch arch: the loss value."""
    jc, tc = _cfg_pair(arch)
    jp, tp = _params(jc)
    s = S - (tc.num_patches or 0)
    batch = _batch(tc, s=s)
    j_loss, _ = j_build(jc).loss(jp, _to_j(batch))
    t_loss, mets = t_build(tc, "cpu").loss(tp, _to_t(batch))
    assert set(mets) == {"ce", "aux"}
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=LOSS_RTOL)


# ------------------------------------------------- the Functions under vmap


class _Counted:
    """Wraps the plain versions the kernel Functions call: each call is
    counted, and a batched or grad-tracking tensor fails the test."""

    def __init__(self, monkeypatch):
        self.calls = {}
        for mod, name in ((fa_ref, "flash_attention_ref"),
                          (fa_ref, "flash_attention_bwd_ref"),
                          (ss_ref, "selective_scan_ref"),
                          (ss_ref, "selective_scan_bwd_ref")):
            monkeypatch.setattr(mod, name, self._wrap(name,
                                                      getattr(mod, name)))

    def _wrap(self, name, fn):
        def wrapped(*args, **kwargs):
            for t in args:
                if isinstance(t, torch.Tensor):
                    assert not is_functorch_wrapped_tensor(t), \
                        f"{name} received a wrapped tensor"
            self.calls[name] = self.calls.get(name, 0) + 1
            return fn(*args, **kwargs)

        return wrapped

    def take(self):
        out, self.calls = self.calls, {}
        return out


def test_functions_see_plain_tensors_and_vmap_equals_separate_grads(
        hymba_params, monkeypatch):
    """vmap(grad(Model.loss)) over 3 clients, each with its own params (so
    K6's ``a`` is per client), equals 3 separate grads; each kernel
    Function is called once per layer per pass, with plain tensors only."""
    _, tc = _cfg_pair("hymba-1.5b")
    _, tp = hymba_params
    model = t_build(tc, "cpu")
    clients = 3
    g = torch.Generator().manual_seed(0)
    params = tree_map(lambda p: p[None] + 1e-3 * torch.randn(
        (clients,) + tuple(p.shape), generator=g), tp)
    batches = [_to_t(_batch(tc, seed=i)) for i in range(clients)]
    stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    counted = _Counted(monkeypatch)
    loss_grad = grad(lambda p, b: model.loss(p, b)[0])
    together = vmap(loss_grad)(params, stacked)
    layers = tc.num_layers
    assert counted.take() == {
        "flash_attention_ref": 2 * layers, "selective_scan_ref": 2 * layers,
        "flash_attention_bwd_ref": layers, "selective_scan_bwd_ref": layers}
    for i in range(clients):
        one = loss_grad(tree_map(lambda p: p[i], params), batches[i])
        for a, b in zip(tree_leaves(together), tree_leaves(one)):
            torch.testing.assert_close(a[i], b, rtol=1e-5, atol=1e-6)


def test_cohort_round_calls_each_kernel_function_as_the_card_launches(
        hymba_params, monkeypatch):
    """One cohort round at M = 2 local steps, remat on, L layers: K5's and
    K6's forward 5 L times each (M training forwards, the eq. 4 probe, the
    remat recompute), their backward 2 L times, one call per pass for all
    C slots (the vmap fold). On the card these are the launch counts."""
    _, tc = _cfg_pair("hymba-1.5b")
    _, tp = hymba_params
    fl = t_base.FLConfig(buffer_size=3, local_steps=2, local_lr=5e-3,
                         server_pass_mode="reference")
    loop = t_train.TrainLoop(tc, fl, cohort=4, batch=1, seq=S, rounds=1,
                             device="cpu", params=tp)
    counted = _Counted(monkeypatch)
    loop.round(0)
    layers = tc.num_layers
    assert counted.take() == {
        "flash_attention_ref": 5 * layers, "selective_scan_ref": 5 * layers,
        "flash_attention_bwd_ref": 2 * layers,
        "selective_scan_bwd_ref": 2 * layers}


# ------------------------------------------------- optimizers and schedules


def _opt_pairs():
    return {
        "sgd": (lambda lr: j_opt.sgd(lr), lambda lr: t_opt.sgd(lr)),
        "sgd_momentum_wd": (
            lambda lr: j_opt.sgd(lr, momentum=0.9, weight_decay=1e-2),
            lambda lr: t_opt.sgd(lr, momentum=0.9, weight_decay=1e-2)),
        "sgd_nesterov": (
            lambda lr: j_opt.sgd(lr, momentum=0.8, nesterov=True),
            lambda lr: t_opt.sgd(lr, momentum=0.8, nesterov=True)),
        "adamw": (lambda lr: j_opt.adamw(lr, weight_decay=1e-2),
                  lambda lr: t_opt.adamw(lr, weight_decay=1e-2)),
    }


SCHEDULES = {
    "float": (0.05, 0.05),
    "constant": (j_sched.constant_schedule(0.05),
                 t_sched.constant_schedule(0.05)),
    "cosine": (j_sched.cosine_schedule(0.1, 4),
               t_sched.cosine_schedule(0.1, 4)),
    "warmup_cosine": (j_sched.warmup_cosine_schedule(0.1, 2, 5),
                      t_sched.warmup_cosine_schedule(0.1, 2, 5)),
}


@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("opt", list(_opt_pairs()))
def test_optimizers_match_jax_over_five_steps(opt, schedule):
    j_make, t_make = _opt_pairs()[opt]
    j_lr, t_lr = SCHEDULES[schedule]
    jo, to = j_make(j_lr), t_make(t_lr)
    rng = np.random.default_rng(1)
    params = {"w": rng.normal(size=(3, 4)).astype(np.float32),
              "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree_map(torch.from_numpy, params)
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(5):
        g = {"w": rng.normal(size=(3, 4)).astype(np.float32),
             "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}
        ju, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = to.update(tree_map(torch.from_numpy, g), ts, tp)
        jp = j_opt.apply_updates(jp, ju)
        tp = t_opt.apply_updates(tp, tu)
        for a, b in zip(tree_leaves(tu), _leaves_j(ju)):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-8)
    assert int(ts.step) == int(js.step) == 5
    for a, b in zip(tree_leaves(tp), _leaves_j(jp)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["constant", "cosine", "warmup_cosine"])
def test_schedules_match_jax(name):
    jf, tf = SCHEDULES[name]
    for step in range(8):
        np.testing.assert_allclose(
            float(tf(torch.tensor(step, dtype=torch.int32))),
            float(jf(jnp.asarray(step, jnp.int32))), rtol=1e-7)


def test_bf16_sgd_update_is_computed_in_f32_like_jax():
    """A bf16 gradient times an f32 learning rate: JAX promotes to f32 and
    casts once when the update is applied; the port does the same."""
    g = np.linspace(-3, 3, 64).astype(np.float32)
    p = np.linspace(1, 2, 64).astype(np.float32)
    jp = {"w": jnp.asarray(p, jnp.bfloat16)}
    tp = {"w": torch.from_numpy(p).to(torch.bfloat16)}
    ju, _ = j_opt.sgd(0.0123).update({"w": jnp.asarray(g, jnp.bfloat16)},
                                     j_opt.sgd(0.0123).init(jp))
    tu, _ = t_opt.sgd(0.0123).update(
        {"w": torch.from_numpy(g).to(torch.bfloat16)},
        t_opt.sgd(0.0123).init(tp))
    assert tu["w"].dtype == torch.float32 and ju["w"].dtype == jnp.float32
    np.testing.assert_array_equal(tu["w"].numpy(), np.asarray(ju["w"]))
    np.testing.assert_array_equal(
        t_opt.apply_updates(tp, tu)["w"].float().numpy(),
        np.asarray(j_opt.apply_updates(jp, ju)["w"], np.float32))


# ---------------------------------------------- the launcher's host pieces


@pytest.mark.parametrize("slots,k,rounds,seed", [(4, 3, 10, 0), (16, 5, 7, 3)])
def test_arrival_schedule_matches_jax(slots, k, rounds, seed):
    want = j_train.arrival_schedule(
        slots, k, JLatencyModel.heterogeneous(slots, seed=seed), rounds,
        seed=seed)
    got = t_train.arrival_schedule(
        slots, k, TLatencyModel.heterogeneous(slots, seed=seed), rounds,
        seed=seed)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "pixtral-12b",
                                  "whisper-tiny"])
def test_make_batches_matches_jax(arch):
    jc, tc = _cfg_pair(arch)
    want = j_train.make_batches(jc, 3, 2, 2, 2, 48,
                                np.random.default_rng(7))
    got = t_train.make_batches(tc, 3, 2, 2, 2, 48, np.random.default_rng(7))
    assert jax.tree.structure(want) == jax.tree.structure(got)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_lm_token_stream_matches_jax():
    """At Hymba's full vocabulary: the port draws its unigram tokens from a
    precomputed CDF, the JAX package through ``rng.choice``; the same
    tokens."""
    from repro.data.synthetic import make_lm_token_stream as j_stream
    from repro_torch.data.synthetic import make_lm_token_stream as t_stream

    np.testing.assert_array_equal(t_stream(32001, 300, 5, seed=11),
                                  j_stream(32001, 300, 5, seed=11))


# ----------------------------------------------- the cohort step over LMs


def test_cohort_step_over_model_loss_matches_jax(hymba_params):
    """C = 4 slots, K = 3, M = 2, b = 1, 3 rounds of the launcher's arrival
    schedule, ``reference`` mode, JAX's jitted ``make_cohort_step`` on the
    same weights and batches."""
    jc, tc = _cfg_pair("hymba-1.5b")
    jp, tp = hymba_params
    kw = dict(buffer_size=3, local_steps=2, local_lr=5e-3, weighting="paper",
              server_pass_mode="reference")
    loop = t_train.TrainLoop(tc, t_base.FLConfig(**kw), cohort=4, batch=1,
                             seq=S, rounds=3, device="cpu", params=tp)
    j_step = jax.jit(j_make_cohort_step(j_build(jc).loss,
                                        j_base.FLConfig(**kw)))
    j_state = j_init_cohort(jax.tree.map(jnp.asarray, jp), 4)
    for r in range(3):
        batch = loop.next_batch(r)
        got = loop.step(loop.state, batch)
        loop.state, t_mets = got
        j_batch = jax.tree.map(jnp.asarray, {
            **batch, "data_sizes": np.asarray(batch["data_sizes"])})
        j_state, j_mets = j_step(j_state, j_batch)
        for key in ("fresh_loss_mean", "staleness_min", "weights_max",
                    "update_sq_norm"):
            np.testing.assert_allclose(float(t_mets[key]), float(j_mets[key]),
                                       rtol=1e-3, err_msg=f"round {r} {key}")
    assert int(loop.state.version) == int(j_state.version) == 3
    np.testing.assert_array_equal(loop.state.client_version.numpy(),
                                  np.asarray(j_state.client_version))
    for a, b in zip(tree_leaves(loop.state.global_params),
                    _leaves_j(j_state.global_params)):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5)


def test_train_launcher_runs_on_the_cpu():
    res = t_train.main(["--arch", "hymba-1.5b", "--smoke", "--device", "cpu",
                        "--rounds", "2", "--log-level", "warning"])
    assert res["version"] == 2 and len(res["history"]) == 2
    assert all(np.isfinite(h["fresh_loss_mean"]) for h in res["history"])
