"""The port's K6 wrapper and plain version against the JAX package's.

On the CPU the port's ``ops.selective_scan`` runs its plain sequential
scan (``ref.py``); the JAX side runs its Pallas kernel in interpret mode
(chunk 16, so the state is carried across chunks) and its jnp reference,
as the JAX package's own tests do. Tolerance rtol/atol 1e-5: the same f32
recurrence, with exp and the N-term sums of XLA and of PyTorch.

The backward's plain version (``selective_scan_bwd_ref``, formulas, not
autograd) is held at f32 against ``torch.autograd`` of the plain forward
and against ``jax.vjp`` of the JAX package's sequential scan (its oracle,
``jax.lax.scan`` over the steps) and of the chunked associative scan of
its ``ssm_train``, with a shared ``a`` and with one ``a`` per batch row (the
JAX side then vmapped over the rows): rtol 1e-4, atol 1e-4 times the
largest gradient (the reverse recurrence summed in other orders).

The CUDA kernel is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``. Its op order, which no
CPU run can execute, is emulated here step for step (``_kernel_order_scan``)
and held against the Pallas kernel, so a change of that order shows here.
"""
import jax
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


# ------------------------------------------------------------------ backward

BWD_SHAPES = [(2, 40, 8, 4, 0), (1, 33, 5, 16, 0), (3, 17, 6, 8, 3),
              (4, 24, 3, 32, 2)]  # (b, s, di, n, groups of a; 0 = shared)


def _bwd_case(b, s, di, n, groups, seed=5):
    x, dt, bb, c, a = _case(b, s, di, n, seed)
    rng = np.random.default_rng(seed + s)
    if groups:
        a = (-np.exp(rng.normal(size=(groups, di, n)) * 0.5)).astype(
            np.float32)
    dy = rng.normal(size=(b, s, di)).astype(np.float32)
    return x, dt, bb, c, a, dy


def _close_rel(got, want, tol=1e-4):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize("b,s,di,n,groups", BWD_SHAPES)
def test_backward_plain_matches_autograd(b, s, di, n, groups):
    *inputs, dy = (torch.from_numpy(v) for v in _bwd_case(b, s, di, n,
                                                          groups))
    inputs = [t.requires_grad_() for t in inputs]
    y = tref.selective_scan_ref(*inputs)
    want = torch.autograd.grad(y, inputs, dy)
    got = tops.selective_scan_bwd(*(t.detach() for t in inputs), dy)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close_rel(g.numpy(), w.numpy(), 1e-5)


def _j_chunked_scan(x, dt, b, c, a, chunk):
    """The chunked associative scan of the JAX package's ``ssm_train``
    (src/repro/models/ssm.py), on the scan's inputs."""
    bsz, s, di = x.shape
    nc = s // chunk

    def reshape_c(t):
        return t.reshape(bsz, nc, chunk, *t.shape[2:]).transpose(
            1, 0, 2, *range(3, t.ndim + 1))

    def chunk_fn(h0, inp):
        xc, dtc, bc, cc = inp
        da = jnp.exp(dtc[..., None] * a[None, None])
        dbx = (dtc * xc)[..., None] * bc[:, :, None, :]

        def comb(left, right):
            return left[0] * right[0], left[1] * right[0] + right[1]

        a_cum, b_cum = jax.lax.associative_scan(comb, (da, dbx), axis=1)
        h = a_cum * h0[:, None] + b_cum
        return h[:, -1], jnp.einsum("bcdn,bcn->bcd", h, cc)

    h0 = jnp.zeros((bsz, di, a.shape[-1]), jnp.float32)
    _, ys = jax.lax.scan(jax.checkpoint(chunk_fn), h0,
                         tuple(map(reshape_c, (x, dt, b, c))))
    return ys.transpose(1, 0, 2, 3).reshape(bsz, s, di)


@pytest.mark.parametrize("jax_scan", ["oracle", "chunked"])
@pytest.mark.parametrize("b,s,di,n,groups", BWD_SHAPES)
def test_backward_plain_matches_jax_grad(b, s, di, n, groups, jax_scan):
    x, dt, bb, c, a, dy = _bwd_case(b, s, di, n, groups)
    if jax_scan == "oracle":
        scan = j_ref
    else:
        chunk = next(k for k in (8, s) if s % k == 0)

        def scan(*args):
            return _j_chunked_scan(*args, chunk=chunk)

    if groups:  # one a per group of rows: vmap the JAX scan over the groups
        rows = b // groups

        def grouped(x, dt, bb, c, a):
            def split(t):
                return t.reshape(groups, rows, *t.shape[1:])

            ys = jax.vmap(scan)(split(x), split(dt), split(bb), split(c), a)
            return ys.reshape(b, *ys.shape[2:])

        fn = grouped
    else:
        fn = scan
    _, pullback = jax.vjp(fn, *map(jnp.asarray, (x, dt, bb, c, a)))
    want = pullback(jnp.asarray(dy))
    got = tops.selective_scan_bwd(*(torch.from_numpy(v) for v in
                                    (x, dt, bb, c, a, dy)))
    for g, w in zip(got, want):
        _close_rel(g.numpy(), w)


def test_per_row_a_forward_matches_separate_calls():
    x, dt, bb, c, a, _ = (torch.from_numpy(v) for v in
                          _bwd_case(4, 20, 6, 8, 2))
    y = tops.selective_scan(x, dt, bb, c, a)
    for g in range(2):
        rows = slice(2 * g, 2 * g + 2)
        assert torch.equal(y[rows], tops.selective_scan(
            x[rows], dt[rows], bb[rows], c[rows], a[g]))
