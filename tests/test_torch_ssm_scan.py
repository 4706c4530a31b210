"""The port's K6 wrapper and plain version against the JAX package's.

On the CPU the port's ``ops.selective_scan`` runs its plain sequential
scan (``ref.py``); the JAX side runs its Pallas kernel in interpret mode
(chunk 16, so the state is carried across chunks) and its jnp reference,
as the JAX package's own tests do. Tolerance rtol/atol 1e-5: the same f32
recurrence, with exp and the N-term sums of XLA and of PyTorch.

The CUDA kernel is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``. Its op order, which no
CPU run can execute, is emulated here step for step (``_kernel_order_scan``)
and held against the Pallas kernel, so a change of that order shows here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.ops import selective_scan as j_scan
from repro.kernels.ssm_scan.ref import selective_scan_ref as j_ref
from repro_torch.kernels.ssm_scan import ops as tops
from repro_torch.kernels.ssm_scan import ref as tref

RTOL = ATOL = 1e-5
SHAPES = [(2, 64, 32, 8), (1, 128, 48, 16), (2, 100, 30, 4), (1, 256, 16, 16),
          (2, 37, 70, 32)]


def _case(b, s, di, n, seed=0):
    """The JAX package's test inputs, from numpy: softplus'd steps, negative
    A, normal x, B, C."""
    rng = np.random.default_rng(seed + 1000 * b + 10 * s + di + n)
    x = rng.normal(size=(b, s, di)).astype(np.float32)
    dt = np.logaddexp(rng.normal(size=(b, s, di)) - 1.0, 0.0).astype(
        np.float32)
    bb = rng.normal(size=(b, s, n)).astype(np.float32)
    c = rng.normal(size=(b, s, n)).astype(np.float32)
    a = (-np.exp(rng.normal(size=(di, n)) * 0.5)).astype(np.float32)
    return x, dt, bb, c, a


@pytest.mark.parametrize("b,s,di,n", SHAPES)
def test_plain_matches_jax(b, s, di, n):
    arrays = _case(b, s, di, n)
    want_kernel = np.asarray(j_scan(*map(jnp.asarray, arrays), interpret=True,
                                    chunk=16, block_d=min(16, di)))
    want_ref = np.asarray(j_ref(*map(jnp.asarray, arrays)))
    t = [torch.from_numpy(a) for a in arrays]
    got_ref = tref.selective_scan_ref(*t)
    got_ops = tops.selective_scan(*t)
    assert got_ops.shape == (b, s, di) and got_ops.dtype == torch.float32
    assert torch.equal(got_ops, got_ref)
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got_ops.numpy(), want, rtol=RTOL,
                                   atol=ATOL)


def _kernel_order_scan(x, dt, b, c, a):
    """``csrc/ssm_scan.cu``'s arithmetic in its order: per state n,
    ``da = exp(dt * a_n)``, ``h = da * h + (dt * x) * B_n`` and
    ``p_n = h * C_n``, each product and sum rounded on its own; then
    ``y = (((0 + p_0) + p_1) + ...) + p_{N-1}``, states summed in order."""
    bsz, s, di = x.shape
    h = torch.zeros((bsz, di, a.shape[1]), dtype=torch.float32)
    ys = []
    for t in range(s):
        dtt = dt[:, t, :, None]
        dtx = dtt * x[:, t, :, None]
        h = torch.exp(dtt * a[None]) * h + dtx * b[:, t, None, :]
        p = h * c[:, t, None, :]
        y = torch.zeros((bsz, di), dtype=torch.float32)
        for k in range(a.shape[1]):
            y = y + p[..., k]
        ys.append(y)
    return torch.stack(ys, dim=1)


@pytest.mark.parametrize("b,s,di,n", SHAPES)
def test_kernel_op_order_matches_jax(b, s, di, n):
    arrays = _case(b, s, di, n)
    want = np.asarray(j_scan(*map(jnp.asarray, arrays), interpret=True,
                             chunk=16, block_d=min(16, di)))
    got = _kernel_order_scan(*(torch.from_numpy(a) for a in arrays))
    assert got.shape == (b, s, di) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_cpu_wrapper_launches_no_kernel():
    t = [torch.from_numpy(a) for a in _case(1, 8, 4, 4)]
    tops.reset_launches()
    tops.selective_scan(*t)
    assert tops.selective_scan.launches == 0


@pytest.mark.parametrize("bad", ["dtype", "state", "shape", "layout"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x, dt, bb, c, a = (torch.from_numpy(v) for v in _case(1, 8, 4, 8))
    if bad == "dtype":
        x = x.double()
    elif bad == "state":
        a = torch.zeros(4, 5)
        bb = c = torch.zeros(1, 8, 5)
    elif bad == "shape":
        dt = dt[:, :7]
    elif bad == "layout":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises((ValueError, TypeError)):
        tops.selective_scan(x, dt, bb, c, a)
