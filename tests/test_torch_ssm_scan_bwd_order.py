"""K6's backward kernel (``csrc/ssm_scan_bwd.cu``) emulated on the CPU in
its own op order, against ``jax.vjp`` of the JAX package's scan and
against the port's plain backward (``selective_scan_bwd_ref``).

No CPU run can execute the CUDA kernel, so ``_kernel_order_bwd`` repeats
its arithmetic step for step in torch f32 (each product and sum rounded on
its own, as ``__fmul_rn`` / ``__fadd_rn``):

- pass 1 walks the sequence forward in the forward kernel's op order and
  keeps h at the start of every 16-step chunk (the checkpoints);
- pass 2 walks the chunks backward; each rebuilds its 16 steps' h and a_t
  from its checkpoint, then walks them back with g and a_{t+1} carried;
- dx / ddt: each thread adds its two states' g B_ and g h_{t-1} a_t A,
  then the warps are summed in order: dx = dt * (sum of g B_), ddt = x *
  (sum of g B_) + (sum of g h_{t-1} a_t A);
- dB_ / dC_: the butterfly reduce-scatter over the 32 lanes of a channel
  block, lane by lane: every exchange (keep one half, add the partner's
  copy of it, send the other) and the lane that stores each sum, as the
  kernel maps them (kind ``k & 1``, step ``k >> 1``, both states);
- the reduce kernel: the channel blocks summed in order, dA over the rows
  of each A group in order.

A change of that order, or of the lane a sum lands on, shows here.
Tolerance: rtol 1e-4, atol 1e-4 times the largest gradient, as
``tests/test_torch_ssm_scan.py::test_backward_plain_matches_jax_grad`` (the
reverse recurrence summed in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.ref import selective_scan_ref as j_ref
from repro_torch.kernels.ssm_scan import ref as tref

CHUNK, LANES, STATES_PER_THREAD = 16, 32, 2
TOL = 1e-4


def _exchange(lo, hi, off):
    """One butterfly round over the last (lane) axis: lanes whose bit
    ``off`` is clear keep ``lo``, the others ``hi``; each adds its partner's
    copy of what it keeps."""
    lane = torch.arange(LANES)
    up = (lane & off) != 0
    keep = torch.where(up, hi, lo)
    send = torch.where(up, lo, hi)
    return keep + send[..., lane ^ off]


def _kernel_order_bwd(x, dt, b, c, a, dy):
    """The kernel's gradients (dx, ddt, db, dc, da) in its op order."""
    bsz, s, di = x.shape
    n = a.shape[-1]
    blocks = -(-di // LANES)
    chunks = -(-s // CHUNK)
    sp, dp = chunks * CHUNK, blocks * LANES
    a_rows = bsz if a.dim() == 2 else bsz // a.shape[0]

    def pad(t, last):  # zeros past S (and past di for the channel arrays)
        out = torch.zeros((bsz, sp, last), dtype=torch.float32)
        out[:, :s, :t.shape[-1]] = t
        return out

    xp, dtp, dyp = (pad(t, dp) for t in (x, dt, dy))
    bp, cp = pad(b, n), pad(c, n)
    ar = a.expand(bsz, di, n) if a.dim() == 2 \
        else a.repeat_interleave(a_rows, dim=0)
    ap = torch.zeros((bsz, dp, n), dtype=torch.float32)
    ap[:, :di] = ar

    def step(h, t):
        """h (B, dp, N) one step forward; returns (h, a_t)."""
        dtt = dtp[:, t, :, None]
        da = torch.exp(dtt * ap)
        u = dtt * xp[:, t, :, None]
        return da * h + u * bp[:, t, None, :], da

    # pass 1: the checkpoints
    h = torch.zeros((bsz, dp, n), dtype=torch.float32)
    ckpt = []
    for ch in range(chunks):
        ckpt.append(h)
        for j in range(CHUNK):
            h, _ = step(h, ch * CHUNK + j)

    # pass 2
    g = torch.zeros_like(h)
    a_next = torch.zeros_like(h)
    da_acc = torch.zeros_like(h)
    dx = torch.zeros((bsz, sp, dp), dtype=torch.float32)
    ddt = torch.zeros_like(dx)
    # partial sums of a channel block: (B, blocks, N, S)
    pb = torch.zeros((bsz, blocks, n, sp), dtype=torch.float32)
    pc = torch.zeros_like(pb)
    lane = torch.arange(LANES)

    def lanes(t):  # (B, dp, N) -> (B, blocks, N, 32 lanes)
        return t.reshape(bsz, blocks, LANES, n).permute(0, 1, 3, 2)

    for ch in range(chunks - 1, -1, -1):
        t0 = ch * CHUNK
        hh = ckpt[ch]
        hs, as_ = [], []
        for j in range(CHUNK):
            hh, da = step(hh, t0 + j)
            hs.append(hh)
            as_.append(da)
        pend = [None] * 4
        for j in range(CHUNK - 1, -1, -1):
            t = t0 + j
            xv, dtv, dyv = (v[:, t, :, None] for v in (xp, dtp, dyp))
            g = cp[:, t, None, :] * dyv + a_next * g
            hp = hs[j - 1] if j else ckpt[ch]
            gh = (g * hp) * as_[j]
            px = g * bp[:, t, None, :]
            ga = gh * ap
            da_acc = da_acc + gh * dtv
            a_next = as_[j]
            # a thread's two states, then the warps in order
            qx = px[..., 0::2] + px[..., 1::2]
            qd = ga[..., 0::2] + ga[..., 1::2]
            sx, sd = qx[..., 0], qd[..., 0]
            for w in range(1, n // STATES_PER_THREAD):
                sx = sx + qx[..., w]
                sd = sd + qd[..., w]
            dx[:, t] = dtp[:, t] * sx
            ddt[:, t] = xp[:, t] * sx + sd
            # dB_ / dC_ terms into the butterfly, lane by lane: offset 1
            # splits the kinds, offset 2 << l bit l of the step
            cur = _exchange(lanes(g * (dtv * xv)), lanes(hs[j] * dyv), 1)
            for lvl in range(4):
                if (j >> lvl) & 1:
                    pend[lvl] = cur
                    break
                cur = _exchange(cur, pend[lvl], 2 << lvl)
        # j == 0 left the chunk's sums in cur, (B, blocks, N, 32 lanes):
        # lane k holds kind k & 1 of step k >> 1, for every state
        for k in range(LANES):
            dst = pc if k & 1 else pb
            dst[:, :, :, t0 + (k >> 1)] = cur[..., k]

    # the reduce kernel: channel blocks in order; A's rows in order
    db, dc = pb[:, 0], pc[:, 0]
    for k in range(1, blocks):
        db = db + pb[:, k]
        dc = dc + pc[:, k]
    rows = da_acc[:, :di].reshape(bsz // a_rows, a_rows, di, n)
    da = rows[:, 0]
    for r in range(1, a_rows):
        da = da + rows[:, r]
    da = da[0] if a.dim() == 2 else da
    return (dx[:, :s, :di], ddt[:, :s, :di], db.transpose(1, 2)[:, :s],
            dc.transpose(1, 2)[:, :s], da)


def _case(b, s, di, n, groups, seed=11):
    rng = np.random.default_rng(seed + 1000 * b + 10 * s + di + n + groups)
    x = rng.normal(size=(b, s, di)).astype(np.float32)
    dt = np.logaddexp(rng.normal(size=(b, s, di)) - 1.0, 0.0).astype(
        np.float32)
    bb = rng.normal(size=(b, s, n)).astype(np.float32)
    c = rng.normal(size=(b, s, n)).astype(np.float32)
    a = (-np.exp(rng.normal(size=(groups,) * bool(groups) + (di, n)) * 0.5)
         ).astype(np.float32)
    dy = rng.normal(size=(b, s, di)).astype(np.float32)
    return x, dt, bb, c, a, dy


def _jax_grads(x, dt, bb, c, a, dy, groups):
    """``jax.vjp`` of the JAX package's sequential scan, vmapped over the
    groups of rows where each has its own a."""
    b = x.shape[0]
    if groups:
        rows = b // groups

        def fn(x, dt, bb, c, a):
            def split(t):
                return t.reshape(groups, rows, *t.shape[1:])

            ys = jax.vmap(j_ref)(split(x), split(dt), split(bb), split(c), a)
            return ys.reshape(b, *ys.shape[2:])
    else:
        fn = j_ref
    _, pullback = jax.vjp(fn, *map(jnp.asarray, (x, dt, bb, c, a)))
    return [np.asarray(g) for g in pullback(jnp.asarray(dy))]


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=TOL,
                               atol=TOL * float(np.abs(want).max()))


# (b, s, di, n, groups of a; 0 = shared): S one past a chunk, di one past a
# channel block, N 4 and 32, a shared and per group of rows
CASES = [(2, 17, 33, 4, 0), (4, 17, 33, 32, 2), (3, 20, 64, 8, 3),
         (1, 40, 31, 16, 0)]


@pytest.mark.parametrize("b,s,di,n,groups", CASES)
def test_kernel_order_backward_matches_jax_and_plain(b, s, di, n, groups):
    arrays = _case(b, s, di, n, groups)
    tensors = [torch.from_numpy(v) for v in arrays]
    got = _kernel_order_bwd(*tensors)
    plain = tref.selective_scan_bwd_ref(*tensors)
    want = _jax_grads(*arrays, groups)
    for name, g, p, w in zip(("dx", "ddt", "db", "dc", "da"), got, plain,
                             want):
        assert g.shape == p.shape == w.shape, name
        _close(g.numpy(), w)
        _close(g.numpy(), p.numpy())
