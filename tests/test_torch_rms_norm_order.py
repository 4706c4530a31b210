"""The RMSNorm kernels (``csrc/rms_norm.cu``) emulated on the CPU in their
own op order, against ``jax.vjp`` of the JAX package's ``rms_norm``
(``src/repro/models/layers.py``) and against the port's plain version
(``kernels/rms_norm/ref.py``).

No CPU run can execute the CUDA kernels, so ``_forward`` and ``_backward``
repeat their arithmetic step for step in torch f32 (each product and sum
rounded on its own, as ``__fmul_rn`` / ``__fadd_rn``; ``fmaf`` rounded
once):

- the "rows" kernels (bf16 d <= 2,048 or f32 d <= 1,024, d a whole number
  of 16-byte vectors): lane l of a row's ``lanes`` threads holds vectors
  k = 0 .. NV-1 at columns (k lanes + l) VEC and sums its squares with
  ``fmaf``; the lanes' sums meet in a butterfly;
- the "block" kernels (any other d): thread t takes columns t VEC + m 256
  VEC; ``block_sum`` is a ``__shfl_down`` tree in each warp, then warp 0
  over the 8 warp sums;
- r = rsqrt(sum (1 / d) + eps), y = (x r)(1 + w) rounded once to x's dtype;
- backward: s = sum of (dy (1 + w)) x in the same lane order, dx = r (dy
  (1 + w)) - x (r^3 s / d) in one ``fmaf``, and dw as the kernels tile it:
  a dw group is cut into tiles (about 4 blocks an SM of an H100's 132); in
  the "rows" kernel each group of lanes of a block sums its rows in order,
  then the block sums its groups in order; the tiles are summed in order.

Tolerances, for sums taken in another order than JAX's (and ``rsqrtf``
within 2 ulp): y within 1 bf16 ulp (f32: 1e-6 of its largest); dx within 2^-8
(bf16) or 1e-5 (f32) of its largest entry; dw within 1e-5 of its largest.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import rms_norm as j_rms_norm
from repro_torch.kernels.rms_norm import ref as tref

EPS = 1e-6
SMS = 132  # an H100 SXM's SMs: the backward's tiling depends on them
ROW_THREADS, BLOCK_THREADS, MAX_VECTORS, TILES_PER_SM = 128, 256, 8, 4


def _fma(a, b, c):
    """fmaf: a b + c rounded once (the f32 product is exact in f64)."""
    return (a.double() * b.double() + c.double()).float()


def _layout(d, dtype):
    """("rows", VEC, lanes, NV) or ("block", VEC, 0, 0), as the host side
    of the kernels picks them for contiguous rows."""
    vec = 8 if dtype == torch.bfloat16 else 4
    if d % vec == 0 and d // vec <= 32 * MAX_VECTORS:
        vectors = d // vec
        lanes = 1
        while lanes < 32 and lanes < vectors:
            lanes *= 2
        return "rows", vec, lanes, -(-vectors // lanes)
    return "block", (vec if d % vec == 0 else 1), 0, 0


def _columns(d, kind, vec, lanes, nv):
    """[threads, terms] column of each of a thread's terms in its order
    (-1 past the row's end)."""
    if kind == "rows":
        cols = [[(k * lanes + l) * vec + j for k in range(nv)
                 for j in range(vec)] for l in range(lanes)]
    else:
        steps = -(-d // (BLOCK_THREADS * vec))
        cols = [[t * vec + m * BLOCK_THREADS * vec + j for m in range(steps)
                 for j in range(vec)] for t in range(BLOCK_THREADS)]
    idx = torch.tensor(cols)
    return torch.where(idx < d, idx, -1)


def _thread_sums(terms_a, terms_b, idx):
    """Each thread's fmaf chain of a * b over its columns: (R, threads)."""
    rows = terms_a.shape[0]
    acc = torch.zeros(rows, idx.shape[0])
    for i in range(idx.shape[1]):
        col = idx[:, i]
        ok = col >= 0
        a = terms_a[:, col.clamp(min=0)]
        b = terms_b[:, col.clamp(min=0)]
        acc = torch.where(ok, _fma(a, b, acc), acc)
    return acc


def _butterfly(v, lanes):
    lane = torch.arange(lanes)
    off = lanes // 2
    while off:
        v = v + v[:, lane ^ off]
        off //= 2
    return v[:, 0]


def _warp_sum(v):
    """``__shfl_down`` tree over the last axis (32 lanes); lane 0's sum."""
    lane = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        src = torch.where(lane + off < 32, lane + off, lane)
        v = v + v[..., src]
    return v[..., 0]


def _block_sum(v):
    warps = _warp_sum(v.reshape(v.shape[0], BLOCK_THREADS // 32, 32))
    first = torch.zeros(v.shape[0], 32)
    first[:, :BLOCK_THREADS // 32] = warps
    return _warp_sum(first)


def _row_sum(a, b, d, layout):
    kind, vec, lanes, nv = layout
    per_thread = _thread_sums(a, b, _columns(d, kind, vec, lanes, nv))
    return _butterfly(per_thread, lanes) if kind == "rows" \
        else _block_sum(per_thread)


def _rstd(x32, d, layout):
    inv_d = torch.tensor(1.0 / d, dtype=torch.float32)
    return torch.rsqrt(_row_sum(x32, x32, d, layout) * inv_d + EPS)


def _forward(x, gain):
    """(y in x's dtype, r) for x (R, d) and gain (R, d) = 1 + w per row."""
    d = x.shape[-1]
    x32 = x.float()
    r = _rstd(x32, d, _layout(d, x.dtype))
    return ((x32 * r[:, None]) * gain).to(x.dtype), r


def _tiles(rows, dw_rows):
    """(tiles a dw group, rows a tile), as ``plan_tiles``."""
    groups = rows // dw_rows
    want = min(max(-(-(TILES_PER_SM * SMS) // groups), 1), dw_rows)
    tile_rows = -(-dw_rows // want)
    return -(-dw_rows // tile_rows), tile_rows


def _backward(x, gain, r, dy, dw_rows):
    """(dx in x's dtype, dw (rows / dw_rows, d) f32)."""
    rows, d = x.shape
    layout = _layout(d, x.dtype)
    x32, dy32 = x.float(), dy.float()
    dyg = dy32 * gain
    s = _row_sum(dyg, x32, d, layout)
    inv_d = torch.tensor(1.0 / d, dtype=torch.float32)
    c = ((r * r * r) * s) * inv_d
    dx = _fma(-x32, c[:, None], r[:, None] * dyg).to(x.dtype)
    # dw: the terms dy (x r), summed as the tiles, groups and blocks do
    xr = x32 * r[:, None]
    tiles, tile_rows = _tiles(rows, dw_rows)
    subs = ROW_THREADS // layout[2] if layout[0] == "rows" else 1
    dw = torch.zeros(rows // dw_rows, d)
    for g in range(rows // dw_rows):
        total = torch.zeros(d)
        for t in range(tiles):
            lo = g * dw_rows + t * tile_rows
            hi = min(lo + tile_rows, (g + 1) * dw_rows)
            part = torch.zeros(d)
            for q in range(subs):  # each group of lanes, its rows in order
                acc = torch.zeros(d)
                for row in range(lo + q, hi, subs):
                    acc = _fma(dy32[row], xr[row], acc)
                part = part + acc
            total = total + part
        dw[g] = total
    return dx, dw


CASES = [  # (dtype, d, calls, rows a call, weight a call)
    (torch.bfloat16, 1600, 2, 37, True),   # rows: 7 vectors a lane
    (torch.bfloat16, 2048, 2, 24, True),   # rows: 8 vectors a lane
    (torch.bfloat16, 64, 3, 40, False),    # rows: 8 lanes a row
    (torch.bfloat16, 5120, 1, 9, False),   # block, 16-byte vectors
    (torch.bfloat16, 100, 2, 11, True),    # block, one element
    (torch.float32, 1024, 2, 19, True),    # rows: 8 vectors a lane
    (torch.float32, 100, 2, 13, False),    # rows: 25 vectors, 32 lanes
    (torch.float32, 1600, 1, 7, False),    # block, 16-byte vectors
]


def _draw(dtype, d, calls, n, per_call, seed):
    g = torch.Generator().manual_seed(seed)
    x = (3 * torch.randn(calls, n, d, generator=g)).to(dtype)
    dy = torch.randn(calls, n, d, generator=g).to(dtype)
    w = 0.1 * torch.randn((calls, d) if per_call else (d,), generator=g)
    return x, dy, w


def _jax_grads(x, dy, w):
    """jax.vjp of the JAX package's rms_norm, the calls vmapped."""
    def to_j(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(t.numpy())

    jx, jdy, jw = to_j(x), to_j(dy), to_j(w)
    w_axis = 0 if w.dim() == 2 else None
    f = jax.vmap(lambda a, b: j_rms_norm(a, b, EPS), in_axes=(0, w_axis))
    y, pullback = jax.vjp(f, jx, jw)
    dx, dw = pullback(jdy)

    def to_t(a, dtype):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(dtype)

    return to_t(y, x.dtype), to_t(dx, x.dtype), to_t(dw, torch.float32)


def _emulate(x, dy, w):
    calls, n, d = x.shape
    wr = w if w.dim() == 2 else w.expand(calls, d)
    gain = (1.0 + wr).repeat_interleave(n, dim=0)
    xf, dyf = x.reshape(-1, d), dy.reshape(-1, d)
    y, r = _forward(xf, gain)
    dx, dw = _backward(xf, gain, r, dyf, n)
    if w.dim() == 1:  # a shared weight's dw sums the calls' dw
        dw = dw.sum(0)
    return y.reshape(x.shape), dx.reshape(x.shape), dw


def _ulps(a, b):
    """bf16 ulps between a and b, at most."""
    return int((a.view(torch.int16).int() - b.view(torch.int16).int())
               .abs().max())


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()) / float(
        b.float().abs().max())


def _check(got, want, what):
    y, dx, dw = got
    wy, wdx, wdw = want
    bf16 = y.dtype == torch.bfloat16
    if bf16:
        assert _ulps(y, wy) <= 1, f"y vs {what}"
    else:
        assert _rel(y, wy) <= 1e-6, f"y vs {what}"
    assert _rel(dx, wdx) <= (2.0 ** -8 if bf16 else 1e-5), f"dx vs {what}"
    assert _rel(dw, wdw) <= 1e-5, f"dw vs {what}"


@pytest.mark.parametrize("dtype,d,calls,n,per_call", CASES)
def test_kernel_order_matches_jax_vjp(dtype, d, calls, n, per_call):
    x, dy, w = _draw(dtype, d, calls, n, per_call, seed=d + n)
    _check(_emulate(x, dy, w), _jax_grads(x, dy, w), "jax.vjp")


@pytest.mark.parametrize("dtype,d,calls,n,per_call", CASES)
def test_kernel_order_matches_plain_version(dtype, d, calls, n, per_call):
    x, dy, w = _draw(dtype, d, calls, n, per_call, seed=d + n + 1)
    rows = x.reshape(-1, d)
    y, _ = tref.rms_norm_ref(rows, w, EPS)
    dx, dw = tref.rms_norm_bwd_ref(rows, w, dy.reshape(-1, d), EPS)
    _check(_emulate(x, dy, w), (y.reshape(x.shape), dx.reshape(x.shape), dw),
           "the plain version")


def test_tiles_cover_each_group_once():
    for rows, dw_rows in ((8192, 2048), (65536, 65536), (9, 9), (74, 37)):
        tiles, tile_rows = _tiles(rows, dw_rows)
        assert (tiles - 1) * tile_rows < dw_rows <= tiles * tile_rows
