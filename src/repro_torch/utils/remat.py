"""Rematerialisation: the port's counterpart of ``jax.checkpoint``.

``remat(fn)`` returns a function that computes ``fn(*args)`` without
keeping ``fn``'s intermediate activations for the backward: only its
inputs are saved, and the backward runs ``fn`` again under
``torch.func.vjp`` to get the cotangents. It changes no number, only what
is kept alive between the forward and the backward.

``torch.utils.checkpoint`` does not serve here: the round body takes
gradients with ``torch.func.grad`` under ``vmap``, and ``torch.func``
does not support the saved-tensor hooks that checkpointing relies on. So
``remat`` is an ``autograd.Function`` (``setup_context`` form, with a
generated ``vmap`` rule), which ``torch.func`` transforms compose with.

``remat_scan(fn)`` is ``jax.lax.scan`` of a checkpointed body inside a
checkpoint, the grouped remat of the layer stack: it runs ``carry = fn(x,
carry, *consts)`` over a list of steps ``xs`` (a group's layers) keeping
only the group's input carry; its backward rebuilds the group's carries
and then runs each step's ``vjp`` in reverse, so each step is recomputed
once more there, as in the JAX package's nested checkpoints. It is one
Function, not a ``remat`` inside a ``remat``: ``torch.func`` does not take
a rematerialising Function nested in another's backward.

Arguments may be nested dicts, lists and tuples of tensors (a layer's
params) or anything else (``None``, ints), which pass through as they are;
the tensors are the Function's inputs, and those of a floating dtype get
gradients. ``fn`` returns a tensor or a tuple of tensors (``remat_scan``:
the carry, a tuple of tensors).
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence

import torch
from torch.func import vjp


def _flatten(tree: Any, out: List[torch.Tensor]) -> Any:
    """Replace each tensor of ``tree`` by its index in ``out``."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
        return _Slot(len(out) - 1)
    if isinstance(tree, dict):
        return {k: _flatten(v, out) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_flatten(v, out) for v in tree)
    return tree


def _fill(tree: Any, tensors) -> Any:
    if isinstance(tree, _Slot):
        return tensors[tree.index]
    if isinstance(tree, dict):
        return {k: _fill(v, tensors) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fill(v, tensors) for v in tree)
    return tree


class _Slot:
    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index


def _pullback(run: Callable, tensors: Sequence[torch.Tensor], cotangent,
              grads: List[Any], which: Sequence[int]) -> None:
    """vjp of ``run(*tensors)`` for ``cotangent``; the gradient of each
    floating tensor among ``which`` is added into ``grads`` at its index."""
    diff = [i for i in which if tensors[i].is_floating_point()]

    def run_diff(*primals):
        full = list(tensors)
        for i, p in zip(diff, primals):
            full[i] = p
        return run(*full)

    _, pullback = vjp(run_diff, *(tensors[i] for i in diff))
    for i, g in zip(diff, pullback(cotangent)):
        grads[i] = g if grads[i] is None else grads[i] + g


class _Plan:
    """What a rematerialising Function runs: ``forward(tensors)`` and
    ``backward(tensors, cotangent)`` -> one gradient (or None) per tensor."""

    def __init__(self, forward: Callable, backward: Callable):
        self.forward, self.backward = forward, backward


class _Remat(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(plan, *tensors):
        return plan.forward(tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.plan = inputs[0]
        ctx.single = not isinstance(output, tuple)
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, *grads):
        cotangent = grads[0] if ctx.single else tuple(grads)
        # torch.func.grad differentiates with create_graph=True, so a
        # backward that records its ops keeps every layer's recomputed
        # activations and cotangents alive until the whole gradient is
        # done. Nothing here is differentiated twice: record nothing (the
        # vjp inside keeps its own level, which ignores this no_grad)
        with torch.no_grad():
            return (None, *ctx.plan.backward(ctx.saved_tensors, cotangent))


def remat(fn: Callable) -> Callable:
    """``fn`` with its activations recomputed in the backward."""

    def wrapped(*args):
        tensors: List[torch.Tensor] = []
        shape = _flatten(args, tensors)

        def run(*ts: torch.Tensor) -> Any:
            return fn(*_fill(shape, ts))

        def backward(ts, cotangent):
            grads: List[Any] = [None] * len(ts)
            _pullback(run, ts, cotangent, grads, range(len(ts)))
            return grads

        return _Remat.apply(_Plan(lambda ts: run(*ts), backward), *tensors)

    return wrapped


def remat_scan(fn: Callable) -> Callable:
    """``scan(xs, carry, *consts)``: ``carry = fn(x, carry, *consts)`` for
    each x of the list ``xs``, in order; returns the last carry (a tuple of
    tensors), with only ``xs``, the first carry and ``consts`` kept for the
    backward."""

    def scan(xs, carry, *consts):
        tensors: List[torch.Tensor] = []
        xs_shape, carry_shape, consts_shape = _flatten(
            (list(xs), tuple(carry), consts), tensors)
        const_idx = _slots(consts_shape)

        def forward(ts):
            c = _fill(carry_shape, ts)
            for x in xs_shape:
                c = tuple(fn(_fill(x, ts), c, *_fill(consts_shape, ts)))
            return c

        def backward(ts, cotangent):
            cs = _fill(consts_shape, ts)
            carries = [_fill(carry_shape, ts)]
            for x in xs_shape[:-1]:
                carries.append(tuple(fn(_fill(x, ts), carries[-1], *cs)))
            grads: List[Any] = [None] * len(ts)
            for step in range(len(xs_shape) - 1, -1, -1):
                # the step's inputs: the saved tensors, then its carry
                local = list(ts) + list(carries[step])
                carry_idx = list(range(len(ts), len(local)))
                x_shape = xs_shape[step]

                def run(*full, x_shape=x_shape, carry_idx=carry_idx):
                    return tuple(fn(_fill(x_shape, full),
                                    tuple(full[i] for i in carry_idx),
                                    *_fill(consts_shape, full)))

                step_grads: List[Any] = [None] * len(local)
                _pullback(run, local, cotangent, step_grads,
                          _slots(x_shape) + carry_idx + const_idx)
                for i in _slots(x_shape):
                    grads[i] = step_grads[i]
                for i in const_idx:
                    if step_grads[i] is not None:
                        grads[i] = step_grads[i] if grads[i] is None \
                            else grads[i] + step_grads[i]
                cotangent = tuple(
                    torch.zeros_like(local[i]) if step_grads[i] is None
                    else step_grads[i] for i in carry_idx)
            for i, g in zip(_slots(carry_shape), cotangent):
                grads[i] = g
            return grads

        return _Remat.apply(_Plan(forward, backward), *tensors)

    return scan


def _slots(tree: Any) -> List[int]:
    """The tensor indices of a flattened tree, in order."""
    if isinstance(tree, _Slot):
        return [tree.index]
    if isinstance(tree, dict):
        return [i for v in tree.values() for i in _slots(v)]
    if isinstance(tree, (list, tuple)):
        return [i for v in tree for i in _slots(v)]
    return []
