"""The dist-train Program's step against the JAX package's jitted
``make_dist_step(model.loss)``, at ``smoke_variant`` width on the CPU, on
JAX's init carried across and the same numpy batches
(``tests/test_torch_program_inputs.py``): the port's first LM test of the
distributed-client round. Tolerances are ``tests/test_torch_train.py``'s
(metrics rtol 1e-3, params atol 1e-5).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

import repro.launch.program as j_program
from repro.core.cohort import init_dist_state as j_init_dist
from repro.core.cohort import make_dist_step as j_make_dist_step
from repro.models.model import build_model as j_build
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.cohort import init_dist_state
from repro_torch.launch import program as t_program
from repro_torch.launch.mesh import ShapeMesh
from test_torch_program_inputs import S, batch_like, close_trees, smoke

ROUND_RTOL, PARAM_ATOL = 1e-3, 1e-5


def test_dist_train_program_matches_jax():
    """qwen1.5-110b smoke, buffer 2: a held contribution, then one that
    fills the buffer and applies (the port's first LM test of
    ``make_dist_step``)."""
    jc, over, jp, tp = smoke("qwen1.5-110b")
    fl = dataclasses.replace(t_program.DRYRUN_FL, buffer_size=2)
    prog = t_program.build_program(
        "qwen1.5-110b", "train_4k", ShapeMesh((1, 1), ("data", "model")),
        fl=fl, model_overrides=over,
        shape=ShapeConfig("train_4k", S, 1, "train"), device="cpu")
    assert prog.meta["fl_mode"] == "distributed"
    j_fl = dataclasses.replace(j_program.DRYRUN_FL, buffer_size=2)
    j_step = jax.jit(j_make_dist_step(j_build(jc).loss, j_fl))
    state = init_dist_state(tp, fl)
    j_state = j_init_dist(jax.tree.map(jnp.asarray, jp), j_fl)
    rng = np.random.default_rng(1)
    for i, (tau, size) in enumerate(((0, 900.0), (1, 1300.0))):
        batch = {"local": batch_like(prog.arg_sds[1]["local"],
                                      jc.vocab_size, rng),
                 "probe": batch_like(prog.arg_sds[1]["probe"],
                                      jc.vocab_size, rng),
                 "tau": np.int32(tau), "data_size": np.float32(size)}
        state, mets = prog.step_fn(state, batch)
        j_state, j_mets = j_step(j_state, jax.tree.map(jnp.asarray, batch))
        for key in ("fresh_loss", "v_weight"):
            np.testing.assert_allclose(float(mets[key]), float(j_mets[key]),
                                       rtol=ROUND_RTOL, err_msg=key)
        assert (mets["buffered"], mets["applied"]) == (
            int(j_mets["buffered"]), int(j_mets["applied"])) == (i + 1, i)
    assert state.version == int(j_state.version) == 1
    assert state.count == int(j_state.count) == 0
    close_trees(state.global_params, j_state.global_params, PARAM_ATOL)
    np.testing.assert_allclose(state.update_norm_ring.numpy(),
                               np.asarray(j_state.update_norm_ring),
                               rtol=ROUND_RTOL)
