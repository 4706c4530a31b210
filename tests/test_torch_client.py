"""The port's LeNet, SGD and client update against the JAX package's.

All from ``init_lenet(PRNGKey(0))`` converted with ``params_from_jax`` and
numpy batches from the shared synthetic data. Tolerances: forward and loss
rtol 1e-5 / atol 1e-5 (f32 convolutions and matmuls sum in different
orders on XLA's and PyTorch's CPU kernels); after M local steps the deltas
agree to atol 2e-6, far below the ~1e-2 size of a step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from repro.core.client import make_fresh_loss_fn as j_fresh
from repro.core.client import make_local_update_fn as j_update
from repro.data import synthetic_image_classes
from repro.models.lenet import apply_lenet as j_apply
from repro.models.lenet import init_lenet as j_init
from repro.models.lenet import lenet_loss as j_loss
from repro_torch.core.client import make_fresh_loss_fn as t_fresh
from repro_torch.core.client import make_local_update_fn as t_update
from repro_torch.models import (
    LeNet,
    apply_lenet,
    init_lenet,
    lenet_loss,
    params_from_jax,
    params_to_numpy,
)


@pytest.fixture(scope="module", autouse=True)
def _no_tf32():
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def params():
    jp = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0)))
    return jp, params_from_jax(jp, "cpu")


@pytest.fixture(scope="module")
def data():
    x, y = synthetic_image_classes(4 * 3 * 16, noise=1.0, seed=2)
    return x.reshape(4, 3, 16, 28, 28, 1), y.reshape(4, 3, 16)


def _close(t_tree, j_tree, atol):
    got = params_to_numpy(t_tree)
    for layer in j_tree:
        for key in j_tree[layer]:
            np.testing.assert_allclose(got[layer][key],
                                       np.asarray(j_tree[layer][key]),
                                       rtol=1e-5, atol=atol,
                                       err_msg=f"{layer}/{key}")


def test_forward_and_loss(params, data):
    jp, tp = params
    x, y = data[0][0, 0], data[1][0, 0]
    np.testing.assert_allclose(apply_lenet(tp, torch.from_numpy(x)).numpy(),
                               np.asarray(j_apply(jp, x)), rtol=1e-5,
                               atol=1e-5)
    t_ce, t_m = lenet_loss(tp, (torch.from_numpy(x), torch.from_numpy(y)))
    j_ce, j_m = j_loss(jp, (x, y))
    np.testing.assert_allclose(float(t_ce), float(j_ce), rtol=1e-5)
    assert float(t_m["acc"]) == float(j_m["acc"])
    # the module's forward is the functional forward on its own parameters
    np.testing.assert_array_equal(LeNet(tp)(torch.from_numpy(x)).detach()
                                  .numpy(),
                                  apply_lenet(tp, torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("momentum,prox_mu", [(0.0, 0.0), (0.9, 0.1)])
def test_local_update_batched_over_clients(params, data, momentum, prox_mu):
    """K=4 clients x M=3 steps: one vmapped port call vs JAX per client."""
    jp, tp = params
    x, y = data
    j_fn = jax.jit(j_update(j_loss, 3, 0.05, momentum, prox_mu))
    t_fn = t_update(lenet_loss, 3, 0.05, momentum, prox_mu)
    deltas = vmap(lambda b: t_fn(tp, b)[0])((torch.from_numpy(x),
                                             torch.from_numpy(y)))
    for c in range(4):
        j_delta, _ = j_fn(jp, (jnp.asarray(x[c]), jnp.asarray(y[c])))
        one = {l: {k: v[c] for k, v in d.items()} for l, d in deltas.items()}
        _close(one, j_delta, atol=2e-6)


def test_fresh_loss(params, data):
    jp, tp = params
    x, y = data[0][1, 2], data[1][1, 2]
    np.testing.assert_allclose(
        float(t_fresh(lenet_loss)(tp, (torch.from_numpy(x),
                                       torch.from_numpy(y)))),
        float(j_fresh(j_loss)(jp, (x, y))), rtol=1e-5)


def test_init_distributions():
    p = init_lenet(torch.Generator().manual_seed(0))
    j = j_init(jax.random.PRNGKey(0))
    for layer in j:
        for key in j[layer]:
            assert tuple(p[layer][key].shape) == j[layer][key].shape
            assert p[layer][key].dtype == torch.float32
    assert torch.count_nonzero(p["f1"]["b"]) == 0
    # N(0,1) * fan_in^-1/2: f1's 30720 draws have std ~ 256^-1/2
    std = float(p["f1"]["w"].std())
    assert abs(std - 256 ** -0.5) < 0.01 * 256 ** -0.5 * 5
