"""The cohort-train Program's step against the JAX package's jitted
``make_cohort_step(model.loss)``, at ``smoke_variant`` width on the CPU, on
JAX's init carried across and the same numpy batches
(``tests/test_torch_program_inputs.py``). Tolerances are
``tests/test_torch_train.py``'s (metrics rtol 1e-3, params atol 1e-5: the
local steps move the weights by lr * grad, and the gradients agree to 1e-4
of their largest).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

import repro.launch.program as j_program
from repro.core.cohort import init_cohort_state as j_init_cohort
from repro.core.cohort import make_cohort_step as j_make_cohort_step
from repro.models.model import build_model as j_build
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.cohort import init_cohort_state
from repro_torch.launch import program as t_program
from repro_torch.launch.mesh import ShapeMesh
from test_torch_program_inputs import S, batch_like, close_trees, smoke

ROUND_RTOL, PARAM_ATOL = 1e-3, 1e-5


def test_cohort_train_program_matches_jax():
    """C = 2 slots (a (2, 1) shape-only mesh: the global step), M = 2, b = 1,
    two rounds with a straggler in the first."""
    jc, over, jp, tp = smoke("hymba-1.5b")
    fl = dataclasses.replace(t_program.DRYRUN_FL,
                             server_pass_mode="reference")
    prog = t_program.build_program(
        "hymba-1.5b", "train_4k", ShapeMesh((2, 1), ("data", "model")),
        fl=fl, model_overrides=over, shape=ShapeConfig("train_4k", S, 2,
                                                       "train"),
        device="cpu")
    assert prog.meta["cohort"] == 2 and prog.meta["local_batch"] == 1
    j_fl = dataclasses.replace(j_program.DRYRUN_FL,
                               server_pass_mode="reference")
    j_step = jax.jit(j_make_cohort_step(j_build(jc).loss, j_fl))
    state = init_cohort_state(tp, 2)
    j_state = j_init_cohort(jax.tree.map(jnp.asarray, jp), 2)
    rng = np.random.default_rng(0)
    for arrival in ([1.0, 0.0], [1.0, 1.0]):
        batch = {"local": batch_like(prog.arg_sds[1]["local"],
                                      jc.vocab_size, rng),
                 "probe": batch_like(prog.arg_sds[1]["probe"],
                                      jc.vocab_size, rng),
                 "arrival": np.asarray(arrival, np.float32),
                 "data_sizes": np.asarray([600.0, 1400.0], np.float32)}
        state, mets = prog.step_fn(state, batch)
        j_state, j_mets = j_step(j_state, jax.tree.map(jnp.asarray, batch))
        for key in ("fresh_loss_mean", "staleness_min", "weights_max",
                    "update_sq_norm"):
            np.testing.assert_allclose(float(mets[key]), float(j_mets[key]),
                                       rtol=ROUND_RTOL, err_msg=key)
    assert int(state.version) == int(j_state.version) == 2
    np.testing.assert_array_equal(state.client_version.numpy(),
                                  np.asarray(j_state.client_version))
    close_trees(state.global_params, j_state.global_params, PARAM_ATOL)
    close_trees(state.client_params, j_state.client_params, PARAM_ATOL)
