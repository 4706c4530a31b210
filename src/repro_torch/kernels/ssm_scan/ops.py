"""Public wrapper: K6 and its backward, as CUDA kernels for CUDA tensors and
plain versions for CPU tensors.

As in the other kernel packages, the device decides: CPU tensors take the
plain versions (``ref.py``), CUDA tensors launch the kernels or raise.
There is no fallback and no switch. ``selective_scan.launches`` counts the
forward kernel's launches, ``selective_scan_bwd.launches`` the backward's.
On ``meta`` tensors (the dry run) both return empty ``meta`` outputs of
the plain versions' shapes and dtypes: no arithmetic, no launch counted.

``selective_scan`` is differentiable, under ``torch.autograd`` and under
``torch.func`` (``grad``, ``vjp``, ``vmap``): it is an
``autograd.Function`` whose backward is a second ``autograd.Function``,
the backward op. Each has a ``vmap`` rule that folds the vmapped dimension
into the batch (B) and makes one launch. ``a`` may differ between the
vmapped calls (each client's own ``A_log`` in a round's local update): the
fold then hands the kernel one matrix per call, each read by that call's
B rows. A kernel or plain version never sees a batched or grad-tracking
tensor: the Functions check that and raise.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.ssm_scan import kernel as _k
from repro_torch.kernels.ssm_scan import ref as _ref
from repro_torch.utils.device import on_cuda, on_meta
from repro_torch.utils.fold import fold_batch, require_plain, unfold_batch

STATE_SIZES = (4, 8, 16, 32)


def _check_inputs(x, dt, b, c, a) -> None:
    for name, t in (("x", x), ("dt", dt), ("b", b), ("c", c), ("a", a)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32; got {t.dtype}")
    if x.dim() != 3 or x.shape[0] < 1 or x.shape[1] < 1 or x.shape[2] < 1:
        raise ValueError(f"x must be (B, S, di) with B, S, di >= 1; got "
                         f"{tuple(x.shape)}")
    bsz, s, di = x.shape
    if a.dim() not in (2, 3) or tuple(a.shape[-2:-1]) != (di,) \
            or a.shape[-1] not in STATE_SIZES \
            or (a.dim() == 3 and (a.shape[0] < 1 or bsz % a.shape[0])):
        raise ValueError(f"a must be ({di}, N) or (G, {di}, N) with G "
                         f"dividing {bsz} and N in {STATE_SIZES}; got "
                         f"{tuple(a.shape)}")
    n = a.shape[-1]
    if dt.shape != x.shape:
        raise ValueError(f"dt must be {tuple(x.shape)}; got {tuple(dt.shape)}")
    for name, t in (("b", b), ("c", c)):
        if tuple(t.shape) != (bsz, s, n):
            raise ValueError(f"{name} must be ({bsz}, {s}, {n}); got "
                             f"{tuple(t.shape)}")


def _check_contiguous(**tensors) -> None:
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _forward(x, dt, b, c, a) -> torch.Tensor:
    require_plain("selective_scan", x, dt, b, c, a)
    _check_contiguous(x=x, dt=dt, b=b, c=c, a=a)
    if on_meta(x, dt, b, c, a):  # shapes only: the plain version's output
        return torch.empty_like(x)
    if not on_cuda(x, dt, b, c, a):
        return _ref.selective_scan_ref(x, dt, b, c, a)
    y = _k.selective_scan(x, dt, b, c, a)
    selective_scan.launches += 1
    return y


def _backward(x, dt, b, c, a, dy):
    require_plain("selective_scan_bwd", x, dt, b, c, a, dy)
    dy = dy.contiguous()
    _check_contiguous(x=x, dt=dt, b=b, c=c, a=a)
    if on_meta(x, dt, b, c, a, dy):
        return tuple(torch.empty_like(t) for t in (x, dt, b, c, a))
    if not on_cuda(x, dt, b, c, a, dy):
        return _ref.selective_scan_bwd_ref(x, dt, b, c, a, dy)
    grads = _k.selective_scan_bwd(x, dt, b, c, a, dy)
    selective_scan_bwd.launches += 1
    return grads


def _fold_a(a: torch.Tensor, in_dim: Optional[int], n: int,
            logical_dim: int, per_call: bool) -> torch.Tensor:
    """``a`` for n folded calls: a shared (di, N) stays shared unless
    ``per_call``; otherwise one matrix (or group of G) per call, in the
    calls' order."""
    if in_dim is None and logical_dim == 2 and not per_call:
        return a
    if logical_dim == 3:
        return fold_batch(a, in_dim, n)
    a = a.expand(n, *a.shape) if in_dim is None else a.movedim(in_dim, 0)
    return a.contiguous()


class _SelectiveScanBwd(torch.autograd.Function):
    """(x, dt, b, c, a, dy) -> (dx, ddt, db, dc, da); not differentiable
    again."""

    @staticmethod
    def forward(x, dt, b, c, a, dy):
        return _backward(x, dt, b, c, a, dy)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("selective_scan has no second derivative")

    @staticmethod
    def vmap(info, in_dims, x, dt, b, c, a, dy):
        n = info.batch_size
        logical_a = a.dim() - (in_dims[4] is not None)
        args = [fold_batch(t, d, n) for t, d in zip((x, dt, b, c, dy),
                                                      in_dims[:4] + in_dims[5:])]
        # da is per call: each vmapped call gets its own matrix, even where
        # they share one
        af = _fold_a(a, in_dims[4], n, logical_a, per_call=True)
        dx, ddt, db, dc, da = _SelectiveScanBwd.apply(*args[:4], af, args[4])
        da = da.reshape(n, *da.shape[1:]) if logical_a == 2 \
            else unfold_batch(da, n)
        return (tuple(unfold_batch(t, n) for t in (dx, ddt, db, dc)) + (da,),
                (0, 0, 0, 0, 0))


class _SelectiveScan(torch.autograd.Function):
    @staticmethod
    def forward(x, dt, b, c, a):
        return _forward(x, dt, b, c, a)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, dy):
        return _SelectiveScanBwd.apply(*ctx.saved_tensors, dy)

    @staticmethod
    def vmap(info, in_dims, x, dt, b, c, a):
        n = info.batch_size
        logical_a = a.dim() - (in_dims[4] is not None)
        args = [fold_batch(t, d, n) for t, d in zip((x, dt, b, c), in_dims)]
        af = _fold_a(a, in_dims[4], n, logical_a, per_call=False)
        return unfold_batch(_SelectiveScan.apply(*args, af), n), 0


def selective_scan(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Mamba-1 selective scan from a zero state.

    x, dt: (B, S, di); b, c: (B, S, N); a: (di, N), or (G, di, N) with G
    dividing B (row r reads ``a[r // (B // G)]``); all f32 and contiguous
    -> y (B, S, di) f32 with ``y_t = C_t . h_t``, ``h_t = exp(dt_t A) h_{t-1}
    + (dt_t x_t) B_t``. Any S and di; N in ``STATE_SIZES``.
    """
    _check_inputs(x, dt, b, c, a)
    return _SelectiveScan.apply(x, dt, b, c, a)


def selective_scan_bwd(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, a: torch.Tensor, dy: torch.Tensor):
    """The backward of ``selective_scan`` for the cotangent ``dy`` (B, S,
    di): (dx, ddt, db, dc, da), da shaped like ``a``."""
    _check_inputs(x, dt, b, c, a)
    if dy.shape != x.shape:
        raise ValueError(f"dy must be {tuple(x.shape)}; got {tuple(dy.shape)}")
    return _SelectiveScanBwd.apply(x, dt, b, c, a, dy)


selective_scan.launches = 0
selective_scan_bwd.launches = 0


def reset_launches() -> None:
    """Set the wrappers' launch counts to 0."""
    selective_scan.launches = 0
    selective_scan_bwd.launches = 0
