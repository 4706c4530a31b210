"""Public wrapper: the models' RMSNorm as CUDA kernels for CUDA tensors and
as the plain eager chain for CPU tensors.

As in the other kernel packages, the device decides: CPU tensors take the
plain versions (``ref.py``: today's op chain, and ``torch.func.vjp`` of it
for the backward, so the CPU's numbers are those of the chain bit for bit),
CUDA tensors launch the kernels or raise. There is no fallback and no
switch. ``rms_norm.launches`` counts the forward kernel's launches,
``rms_norm_bwd.launches`` the backward's (one call of its two kernels). On
``meta`` tensors (the dry run) both return empty ``meta`` outputs: no
arithmetic, no launch counted.

``rms_norm`` is differentiable under ``torch.autograd`` and ``torch.func``
(``grad``, ``vjp``, ``vmap``); the forward saves x, w and the per-row rstd,
and the backward is an op of its own (a second kernel), not differentiable
again. Under ``torch.func`` the norm takes each transform level itself (see
``_fwd``): a vmap level folds the vmapped calls into the rows and makes one
launch. The weight may differ between the calls (each client's own params
in a round's local update): the fold then hands the kernel a (G, d) weight,
row r reading ``w[r // (rows // G)]``; dw comes back per call, also where
the calls share one weight. On a batch-first contiguous input the fold is a
view. A kernel or plain version never sees a batched or grad-tracking
tensor: ``require_plain`` checks that and raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.rms_norm import kernel as _k
from repro_torch.kernels.rms_norm import ref as _ref
from repro_torch.utils import fold
from repro_torch.utils.device import on_cuda, on_meta
from repro_torch.utils.fold import GRAD, VMAP, require_plain

MAX_D = 32768  # the backward's block kernels keep d floats in shared memory
DTYPES = (torch.bfloat16, torch.float32)


def _check_inputs(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dtype not in DTYPES:
        raise TypeError(f"x must be bfloat16 or float32; got {x.dtype}")
    if w.dtype != torch.float32:
        raise TypeError(f"w must be float32; got {w.dtype}")
    if x.dim() < 1 or not 1 <= x.shape[-1] <= MAX_D:
        raise ValueError(f"x must be (..., d) with 1 <= d <= {MAX_D}; got "
                         f"{tuple(x.shape)}")
    d = x.shape[-1]
    rows = x.numel() // d
    if w.dim() not in (1, 2) or w.shape[-1] != d or \
            (w.dim() == 2 and (w.shape[0] < 1 or rows % w.shape[0])):
        raise ValueError(f"w must be ({d},) or (G, {d}) with G dividing the "
                         f"{rows} rows; got {tuple(w.shape)}")


def _dw_shape(w: torch.Tensor, dw_groups: int):
    return tuple(w.shape) if dw_groups == _k.groups(w) \
        else (dw_groups, w.shape[-1])


def _forward(x, w, eps: float):
    require_plain("rms_norm", x, w)
    if on_meta(x, w):  # shapes only
        return (torch.empty_like(x),
                torch.empty(x.shape[:-1], dtype=torch.float32, device="meta"))
    if not on_cuda(x, w):
        return _ref.rms_norm_ref(x, w, eps)
    if x.numel() == 0:  # no rows (a VLM's text past its patches): no launch
        return torch.empty_like(x), x.new_empty(x.shape[:-1],
                                                dtype=torch.float32)
    y, rstd = _k.rms_norm(x, w, eps)
    rms_norm.launches += 1
    return y, rstd


def _backward(x, w, rstd, dy, eps: float, dw_groups: int):
    require_plain("rms_norm_bwd", x, w, rstd, dy)
    dw_shape = _dw_shape(w, dw_groups)
    if on_meta(x, w, rstd, dy):
        return (torch.empty_like(x),
                torch.empty(dw_shape, dtype=torch.float32, device="meta"))
    if not on_cuda(x, w, rstd, dy):
        return _ref.rms_norm_bwd_ref(x, w, dy, eps, dw_groups)
    if x.numel() == 0:
        return torch.empty_like(x), w.new_zeros(dw_shape)
    dx, dw = _k.rms_norm_bwd(x, w, rstd, dy, dw_groups)
    rms_norm_bwd.launches += 1
    return dx, dw.view(dw_shape)


def _batch_first(t: torch.Tensor, in_dim: Optional[int], n: int):
    """(n, ...): the vmapped dim moved first (a view), or an input that is
    not vmapped repeated n times."""
    return t.expand(n, *t.shape) if in_dim is None else t.movedim(in_dim, 0)


def _per_call(w: torch.Tensor, in_dim: Optional[int], n: int):
    """One weight row (or group of G rows) per folded call: (n * G, d)."""
    w = _batch_first(w, in_dim, n)
    return w.reshape(-1, w.shape[-1])


# --------------------------------------------------------------------------
# One level of torch.func at a time. An autograd.Function under torch.func
# goes through functorch's generic rule for it at every level (pytrees of
# its inputs and outputs, a class made per call): on an H100 machine's host
# that made a Hymba training round's step call ~630 ms longer than with the
# eager ops it replaced. So the norm handles the levels itself with
# ``utils/fold.py``'s helpers, as functorch's own rules do (the same unwrap,
# lower and wrap calls), and the step call came out ~220 ms shorter than
# with the eager ops: a vmap level folds the calls into the rows (a view on
# a batch-first contiguous input) and wraps the result; a grad level
# applies a single-level Function whose backward takes the backward op the
# same way. Below the last level the kernel (CUDA) or the plain version
# (CPU) runs on plain tensors. Other transforms (jvp, functionalize) raise.
# --------------------------------------------------------------------------


def _unsupported(ci):
    return NotImplementedError(
        f"rms_norm supports vmap, grad and vjp; got {ci.key()}")


def _fwd(x, w, eps: float):
    """(y, rstd) at the current transforms."""
    x, w = fold.alive(x, w)
    ci = fold.level()
    if ci is None:
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            return _RmsNorm.apply(x, w, eps)
        return _forward(x, w, eps)
    key = ci.key()
    if key == GRAD:
        return fold.apply_single_level(_GradFwd, x, w, eps, ci)
    if key != VMAP:
        raise _unsupported(ci)
    n, ((xp, xd), (wp, wd)) = fold.vmap_unwrap(ci, x, w)
    if xd is None and wd is None:  # nothing vmapped at this level
        return fold.below(ci, _fwd, xp, wp, eps)
    if wd is None and wp.dim() == 1 and xd is not None and xd < xp.dim() - 1:
        # one weight for every row: the rows stay where they lie
        y, rstd = fold.below(ci, _fwd, xp, wp, eps)
        out = xd
    else:
        shared = wd is None and wp.dim() == 1
        y, rstd = fold.below(ci, _fwd, _batch_first(xp, xd, n),
                             wp if shared else _per_call(wp, wd, n), eps)
        out = 0
    return fold.vmap_wrap(ci, out, y, rstd)


def _bwd(x, w, rstd, dy, eps: float, dw_groups: int):
    """(dx, dw) at the current transforms; dw summed per group of
    ``dw_groups`` row groups."""
    # saved tensors outlive the grad level that wrapped them (a vjp's
    # pullback runs after its level ended): drop such dead wrappers
    x, w, rstd, dy = fold.alive(x, w, rstd, dy)
    ci = fold.level()
    if ci is None:
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, w, rstd, dy)):
            return _RmsNormBwd.apply(x, w, rstd, dy, eps, dw_groups)
        return _backward(x, w, rstd, dy, eps, dw_groups)
    key = ci.key()
    if key == GRAD:
        return fold.apply_single_level(_GradBwd, x, w, rstd, dy, eps,
                                       dw_groups, ci)
    if key != VMAP:
        raise _unsupported(ci)
    n, ((xp, xd), (wp, wd), (rp, rd), (dp, dd)) = fold.vmap_unwrap(
        ci, x, w, rstd, dy)
    if xd is None and wd is None and rd is None and dd is None:
        return fold.below(ci, _bwd, xp, wp, rp, dp, eps, dw_groups)
    shape = list(wp.shape)  # w's shape inside one call
    if wd is not None:
        del shape[wd]
    groups = shape[0] if len(shape) == 2 else 1
    shared = wd is None and len(shape) == 1
    # dw is per call, also where the calls share one weight
    dx, dw = fold.below(ci, _bwd, _batch_first(xp, xd, n),
                        wp if shared else _per_call(wp, wd, n),
                        _batch_first(rp, rd, n), _batch_first(dp, dd, n), eps,
                        n * dw_groups)
    inner = (shape[-1],) if len(shape) == 1 and dw_groups == groups \
        else (dw_groups, shape[-1])
    return fold.vmap_wrap(ci, 0, dx, dw.reshape(n, *inner))


class _GradFwd(fold.SingleLevelFunction):
    """The forward at one grad level: unwrap, run below, wrap."""

    @staticmethod
    def forward(x, w, eps, ci):
        with torch.enable_grad():
            y, rstd = fold.below(ci, _fwd, *fold.grad_unwrap(ci, x, w), eps)
        return fold.grad_wrap(ci, y, rstd)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, ctx.eps, _ = inputs
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_backward(x, w, output[1])

    @staticmethod
    def backward(ctx, dy, _drstd):
        x, w, rstd = ctx.saved_tensors
        dx, dw = _bwd(x, w, rstd, dy, ctx.eps, _k.groups(w))
        return dx, dw, None, None


class _GradBwd(fold.SingleLevelFunction):
    """The backward op at one grad level; not differentiable again."""

    @staticmethod
    def forward(x, w, rstd, dy, eps, dw_groups, ci):
        args = fold.grad_unwrap(ci, x, w, rstd, dy)
        with torch.enable_grad():
            dx, dw = fold.below(ci, _bwd, *args, eps, dw_groups)
        return fold.grad_wrap(ci, dx, dw)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("rms_norm has no second derivative")


class _RmsNormBwd(torch.autograd.Function):
    """(x, w, rstd, dy) -> (dx, dw) under plain autograd; not
    differentiable again."""

    @staticmethod
    def forward(ctx, x, w, rstd, dy, eps, dw_groups):
        return _backward(x, w, rstd, dy, eps, dw_groups)

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("rms_norm has no second derivative")


class _RmsNorm(torch.autograd.Function):
    """(x, w) -> (y, rstd) under plain autograd; rstd is not
    differentiable."""

    @staticmethod
    def forward(ctx, x, w, eps):
        y, rstd = _forward(x, w, eps)
        ctx.eps = eps
        ctx.mark_non_differentiable(rstd)
        ctx.save_for_backward(x, w, rstd)
        return y, rstd

    @staticmethod
    def backward(ctx, dy, _drstd):
        x, w, rstd = ctx.saved_tensors
        dx, dw = _bwd(x, w, rstd, dy, ctx.eps, _k.groups(w))
        return dx, dw, None


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """``(x.float() * rsqrt(mean(x.float()**2, -1) + eps) * (1 +
    weight.float())).to(x.dtype)``, in f32, in that order.

    x: (..., d) bf16 or f32, d <= ``MAX_D``; weight: (d,) f32, or (G, d)
    with G dividing the rows of x (row r of ``x.reshape(-1, d)`` reads
    ``weight[r // (rows // G)]``).
    """
    _check_inputs(x, weight)
    return _fwd(x, weight, eps)[0]


def rms_norm_rstd(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6):
    """``rms_norm`` and its per-row rstd (f32, ``x.shape[:-1]``)."""
    _check_inputs(x, weight)
    return _fwd(x, weight, eps)


def rms_norm_bwd(x: torch.Tensor, weight: torch.Tensor, rstd: torch.Tensor,
                 dy: torch.Tensor, eps: float = 1e-6):
    """The backward of ``rms_norm`` for the cotangent ``dy`` (x's shape and
    dtype), given the forward's rstd: (dx in x's dtype, dw f32 shaped like
    ``weight``)."""
    _check_inputs(x, weight)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy must be {tuple(x.shape)} {x.dtype}; got "
                         f"{tuple(dy.shape)} {dy.dtype}")
    if rstd.shape != x.shape[:-1] or rstd.dtype != torch.float32:
        raise ValueError(f"rstd must be {tuple(x.shape[:-1])} float32; got "
                         f"{tuple(rstd.shape)} {rstd.dtype}")
    return _bwd(x, weight, rstd, dy, eps, _k.groups(weight))


rms_norm.launches = 0
rms_norm_bwd.launches = 0


def reset_launches() -> None:
    """Set the wrappers' launch counts to 0."""
    rms_norm.launches = 0
    rms_norm_bwd.launches = 0
