"""Public wrapper: K5 and its backward, as CUDA kernels for CUDA tensors and
plain versions for CPU tensors.

As in the other kernel packages, the device decides: CPU tensors take the
plain versions (``ref.py``), CUDA tensors launch the kernels or raise.
There is no fallback and no switch. ``flash_attention.launches`` counts the
forward kernel's launches, ``flash_attention_bwd.launches`` the backward's.
On ``meta`` tensors (the dry run) both return empty ``meta`` outputs of
the plain versions' shapes and dtypes: no arithmetic, no launch counted;
``flash_attention.meta_calls`` records each such call's shapes instead, so
the dry run can count the work a launch would do.

``flash_attention`` is differentiable, under ``torch.autograd`` and under
``torch.func`` (``grad``, ``vjp``, ``vmap``): it is an
``autograd.Function`` whose backward is a second ``autograd.Function``,
the backward op. The forward Function has two outputs, the attention and
each row's log-sum-exp (f32 (B, H, S), not differentiable), which it saves
for the backward op, so the backward kernel does not recompute it;
``flash_attention`` returns the first, ``flash_attention_lse`` both. Each
Function has a ``vmap`` rule that folds the vmapped dimension into the
batch (B) and makes one launch, so the clients of a round run as one call.
A kernel or plain version never sees a batched or grad-tracking tensor:
the Functions check that and raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attn import kernel as _k
from repro_torch.kernels.flash_attn import ref as _ref
from repro_torch.utils.device import on_cuda, on_meta
from repro_torch.utils.fold import fold_batch, require_plain, unfold_batch

HEAD_DIMS = (32, 64, 128, 160, 256)  # the forward's and the backward's


def _check_inputs(q, k, v, window: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, H, D) and (B, S, Hkv, D)")
    b, s, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != s \
            or k.shape[3] != d:
        raise ValueError(f"k, v must be ({b}, {s}, Hkv, {d}); got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if b < 1 or s < 1 or k.shape[2] < 1 or h % k.shape[2]:
        raise ValueError(f"need B, S >= 1 and H % Hkv == 0; got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if q.dtype not in _k.DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of {list(_k.DTYPES)}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if window < 0:
        raise ValueError(f"window must be >= 0; got {window}")


def _check_contiguous(**tensors) -> None:
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _forward(q, k, v, causal: bool, window: int):
    require_plain("flash_attention", q, k, v)
    _check_contiguous(q=q, k=k, v=v)
    if on_meta(q, k, v):  # shapes only: the plain version's outputs, empty
        b, s, h, _ = q.shape
        flash_attention.meta_calls.append(
            ("forward", tuple(q.shape), k.shape[2], causal, window))
        return (torch.empty_like(q),
                torch.empty((b, h, s), dtype=torch.float32, device="meta"))
    if not on_cuda(q, k, v):
        return _ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                        with_lse=True)
    out = _k.flash_attention(q, k, v, causal, window)
    flash_attention.launches += 1
    return out


def _backward(q, k, v, o, do, lse, causal: bool, window: int):
    require_plain("flash_attention_bwd", q, k, v, o, do, lse)
    o, do = o.contiguous(), do.to(q.dtype).contiguous()
    _check_contiguous(q=q, k=k, v=v)
    if on_meta(q, k, v, o, do, lse):
        flash_attention.meta_calls.append(
            ("backward", tuple(q.shape), k.shape[2], causal, window))
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if not on_cuda(q, k, v, o, do):
        return _ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal=causal,
                                            window=window)
    grads = _k.flash_attention_bwd(q, k, v, o, do, lse, causal, window)
    flash_attention_bwd.launches += 1
    return grads


class _FlashAttentionBwd(torch.autograd.Function):
    """(q, k, v, o, do, lse) -> (dq, dk, dv); not differentiable again."""

    @staticmethod
    def forward(q, k, v, o, do, lse, causal, window):
        return _backward(q, k, v, o, do, lse, causal, window)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("flash_attention has no second derivative")

    @staticmethod
    def vmap(info, in_dims, q, k, v, o, do, lse, causal, window):
        n = info.batch_size
        args = [fold_batch(t, d, n)
                for t, d in zip((q, k, v, o, do, lse), in_dims)]
        grads = _FlashAttentionBwd.apply(*args, causal, window)
        return tuple(unfold_batch(g, n) for g in grads), (0, 0, 0)


class _FlashAttention(torch.autograd.Function):
    """(q, k, v) -> (out, lse); lse is not differentiable."""

    @staticmethod
    def forward(q, k, v, causal, window):
        return _forward(q, k, v, causal, window)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window = inputs
        out, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _FlashAttentionBwd.apply(q, k, v, o, do, lse, ctx.causal,
                                              ctx.window)
        return dq, dk, dv, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window):
        n = info.batch_size
        args = [fold_batch(t, d, n) for t, d in zip((q, k, v), in_dims)]
        out, lse = _FlashAttention.apply(*args, causal, window)
        return (unfold_batch(out, n), unfold_batch(lse, n)), (0, 0)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Attention over a full sequence with an online softmax.

    q: (B, S, H, D), k, v: (B, S, Hkv, D) with H % Hkv == 0 (query head h
    reads kv head h // (H // Hkv)); key j visible to query i where
    ``(not causal or i >= j) and (window == 0 or j > i - window)``. Returns
    (B, S, H, D) in q's dtype. Any S; D in ``HEAD_DIMS`` (the forward's and
    the backward's); f32 or bf16; contiguous.
    """
    return flash_attention_lse(q, k, v, causal=causal, window=window)[0]


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0):
    """``flash_attention``'s output and each row's log-sum-exp of its masked,
    scaled scores, f32 (B, H, S), from one launch: the pair
    ``flash_attention_bwd`` takes. Differentiable in the output."""
    _check_inputs(q, k, v, window)
    return _FlashAttention.apply(q, k, v, bool(causal), int(window))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        *, causal: bool = True, window: int = 0):
    """The backward of ``flash_attention`` for the output ``o``, its rows'
    ``lse`` (both as ``flash_attention_lse`` gives them) and the cotangent
    ``do``: (dq, dk, dv) in the inputs' dtype."""
    _check_inputs(q, k, v, window)
    b, s, h, _ = q.shape
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o and do must be {tuple(q.shape)}; got "
                         f"{tuple(o.shape)} and {tuple(do.shape)}")
    if lse.shape != (b, h, s) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous f32 ({b}, {h}, {s}); got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    return _FlashAttentionBwd.apply(q, k, v, o, do, lse, bool(causal),
                                    int(window))


flash_attention.launches = 0
flash_attention_bwd.launches = 0
# (direction, q's (B, S, H, D), Hkv, causal, window) of each meta call
flash_attention.meta_calls = []


def reset_launches() -> None:
    """Set the wrappers' launch counts to 0 and forget the meta calls."""
    flash_attention.launches = 0
    flash_attention_bwd.launches = 0
    flash_attention.meta_calls.clear()
