"""Helpers of the kernel Functions' ``vmap`` rules and their input guard.

A kernel is launched through ``ctypes`` on plain tensors: a ``torch.func``
wrapper (a batched tensor of ``vmap``, a grad-tracking tensor of ``grad``)
has no device pointer of its own. So each kernel Function has a ``vmap``
rule that folds the vmapped dimension into the batch dimension and makes
one call on plain tensors, and ``require_plain`` raises if a wrapper ever
reaches a kernel or its plain version.

Two ways in. K5's and K6's Functions are ``autograd.Function``s with a
``vmap`` staticmethod, which functorch's generic rule applies at every
transform level (pytrees of the inputs and outputs, a class made per
call). A kernel called often from the host can instead take the levels
itself, as functorch's own rules do, with the helpers under "One level at
a time" below (the RMSNorm, ``kernels/rms_norm/ops.py``): ``level`` names
the innermost transform, ``below`` runs a function with that level popped,
``vmap_unwrap`` / ``vmap_wrap`` and ``grad_unwrap`` / ``grad_wrap`` take a
level's tensors apart and put them back, and ``apply_single_level``
applies a ``SingleLevelFunction`` (a grad level's forward and backward).
These use functorch's private API (``torch._C._functorch``); where a torch
release lacks a name of it, importing this module raises and names the
release and the missing names, and ``tests/test_torch_rms_norm.py`` fails
on it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

FUNCTORCH_NAMES = (
    "CGradInterpreterPtr", "CVmapInterpreterPtr", "TransformType",
    "_add_batch_dim", "_unwrap_batched", "_unwrap_for_grad", "_wrap_for_grad",
    "get_single_level_autograd_function_allowed",
    "is_functorch_wrapped_tensor", "peek_interpreter_stack",
    "pop_dynamic_layer_stack", "push_dynamic_layer_stack",
    "set_single_level_autograd_function_allowed", "unwrap_if_dead")


def missing_functorch_names() -> Tuple[str, ...]:
    """The names of functorch's private API that this module uses and this
    torch lacks (empty where all are there)."""
    import torch.autograd.function as fn_mod
    from torch._C import _functorch

    missing = tuple(n for n in FUNCTORCH_NAMES if not hasattr(_functorch, n))
    if not hasattr(fn_mod, "_SingleLevelFunction"):
        missing += ("torch.autograd.function._SingleLevelFunction",)
    return missing


if missing_functorch_names():
    raise ImportError(
        f"repro_torch.utils.fold: torch {torch.__version__} lacks functorch's "
        f"private API that the kernel Functions' transform rules use: "
        f"{', '.join(missing_functorch_names())}")

from torch._C._functorch import (  # noqa: E402
    CGradInterpreterPtr,
    CVmapInterpreterPtr,
    TransformType,
    _add_batch_dim,
    _unwrap_batched,
    _unwrap_for_grad,
    _wrap_for_grad,
    get_single_level_autograd_function_allowed,
    is_functorch_wrapped_tensor,
    peek_interpreter_stack,
    pop_dynamic_layer_stack,
    push_dynamic_layer_stack,
    set_single_level_autograd_function_allowed,
    unwrap_if_dead,
)
from torch.autograd.function import _SingleLevelFunction  # noqa: E402

SingleLevelFunction = _SingleLevelFunction


def require_plain(what: str, *tensors: torch.Tensor) -> None:
    """Raise if any input is a ``torch.func`` wrapper."""
    if any(is_functorch_wrapped_tensor(t) for t in tensors):
        raise RuntimeError(f"{what} received a batched or grad-tracking "
                           "tensor: its autograd.Function must unwrap it")


def fold_batch(t: torch.Tensor, in_dim: Optional[int], n: int) -> torch.Tensor:
    """(vmapped n at ``in_dim``, B, ...) -> contiguous (n * B, ...); an input
    that is not vmapped (``in_dim`` None) is repeated n times."""
    t = t.expand(n, *t.shape) if in_dim is None else t.movedim(in_dim, 0)
    return t.reshape(n * t.shape[1], *t.shape[2:]).contiguous()


def unfold_batch(t: torch.Tensor, n: int) -> torch.Tensor:
    """(n * B, ...) -> (n, B, ...)."""
    return t.reshape(n, t.shape[0] // n, *t.shape[1:])


# --------------------------------------------------------------------------
# One level at a time: what functorch's own rules do at a transform level
# (unwrap, lower, wrap), for a Function that handles the levels itself.
# --------------------------------------------------------------------------

VMAP, GRAD = TransformType.Vmap, TransformType.Grad


def level():
    """The innermost ``torch.func`` transform, or None outside any:
    ``ci.key()`` is ``VMAP``, ``GRAD`` or another ``TransformType``."""
    return peek_interpreter_stack()


def alive(*tensors: torch.Tensor):
    """The tensors with the wrappers of levels that have ended dropped (a
    vjp's pullback runs after its grad level ended)."""
    return tuple(unwrap_if_dead(t) for t in tensors)


def below(ci, fn, *args):
    """``fn(*args)`` with the innermost transform ``ci`` popped, as
    functorch's ``lower()`` does: a grad level brings back the grad mode it
    began under."""
    layer = pop_dynamic_layer_stack()
    try:
        if ci.key() == GRAD and not CGradInterpreterPtr(ci).prevGradMode():
            with torch.no_grad():
                return fn(*args)
        return fn(*args)
    finally:
        push_dynamic_layer_stack(layer)


def vmap_unwrap(ci, *tensors: torch.Tensor):
    """(vmap's batch size, [(plain tensor, its vmapped dim or None), ...])
    at the vmap level ``ci``."""
    lvl = ci.level()
    return (CVmapInterpreterPtr(ci).batchSize(),
            [_unwrap_batched(t, lvl) for t in tensors])


def vmap_wrap(ci, out_dim: int, *tensors: torch.Tensor):
    """The plain tensors as batched at the vmap level ``ci``, vmapped at
    ``out_dim``."""
    lvl = ci.level()
    return tuple(_add_batch_dim(t, out_dim, lvl) for t in tensors)


def grad_unwrap(ci, *tensors: torch.Tensor):
    """The tensors below the grad level ``ci``."""
    lvl = ci.level()
    return [_unwrap_for_grad(t, lvl) for t in tensors]


def grad_wrap(ci, *tensors: torch.Tensor):
    """Plain tensors as tracked at the grad level ``ci``."""
    lvl = ci.level()
    return tuple(_wrap_for_grad(t, lvl) for t in tensors)


def apply_single_level(fn, *args):
    """``fn.apply(*args)`` for a ``SingleLevelFunction`` under the
    transforms (functorch refuses one unless told it is allowed)."""
    allowed = get_single_level_autograd_function_allowed()
    set_single_level_autograd_function_allowed(True)
    try:
        return fn.apply(*args)
    finally:
        set_single_level_autograd_function_allowed(allowed)
