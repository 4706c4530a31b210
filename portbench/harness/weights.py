"""Model weights made by the benchmark from ``--seed``, on the device.

The layout (paths, shapes, dtypes) is the program's parameter tree, read
from its shape-only init; the values are the benchmark's own. Every matrix
is drawn from one standard-normal stream per dtype, in chunks of
``CHUNK`` elements on a ``torch.Generator`` on the device, and scaled by
``fan_in ** -0.5`` (the embedding and the MoE router by 0.02), in the type
it is served in. Vectors take the constants of a fresh model: norm weights
0 (the norms scale by ``1 + w``), biases 0, SSM ``D`` 1, ``dt_bias`` -4.6
(softplus^-1 of 0.01), ``A_log`` the S4D-real table ``log(1..N)``.

The same seed gives the same tensors on the same device, so the reference
makes its copy again after the program's state is freed.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

CHUNK = 1 << 27  # elements a draw: 512 MiB of f32 scratch

Path = Tuple[str, ...]

# vector leaves by their last key: the value of a fresh model
VECTOR_VALUES = {"w": 0.0, "b": 0.0, "conv_b": 0.0, "D": 1.0,
                 "dt_bias": -4.6, "bq": 0.0, "bk": 0.0, "bv": 0.0,
                 "q_norm": 0.0, "k_norm": 0.0, "b_up": 0.0, "b_down": 0.0}
SMALL_SCALE = {"embed": 0.02, "router": 0.02}


def leaves(tree: Any, prefix: Path = ()) -> List[Tuple[Path, torch.Tensor]]:
    """(path, leaf) in sorted-key order."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out.extend(leaves(tree[key], prefix + (key,)))
        return out
    return [(prefix, tree)]


def set_leaf(tree: Dict, path: Path, value: torch.Tensor) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def is_matrix(path: Path, shape: Tuple[int, ...]) -> bool:
    """A weight matrix (drawn) rather than a vector (constant); stacked
    layer leaves carry a leading layer axis."""
    per_item = len(shape) - (1 if path[0] in ("layers",) else 0)
    return per_item >= 2 and path[-1] != "A_log"


def scale_of(path: Path, shape: Tuple[int, ...]) -> float:
    if path[-1] in SMALL_SCALE:
        return SMALL_SCALE[path[-1]]
    return shape[-2] ** -0.5


def make_weights(layout: Any, seed: int, device: torch.device) -> Dict:
    """A parameter tree shaped like ``layout`` (a tree of tensors, e.g.
    meta), drawn from ``seed`` on ``device``."""
    items = leaves(layout)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    out: Dict = {}
    by_dtype: Dict[torch.dtype, List[Tuple[Path, Tuple[int, ...]]]] = {}
    for path, leaf in items:
        shape = tuple(leaf.shape)
        if is_matrix(path, shape):
            by_dtype.setdefault(leaf.dtype, []).append((path, shape))
        elif path[-1] == "A_log":
            n = shape[-1]
            row = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                         device=device))
            set_leaf(out, path, row.expand(shape).to(leaf.dtype).clone())
        else:
            if path[-1] not in VECTOR_VALUES:
                raise KeyError(f"no value for the vector leaf {'.'.join(path)}")
            set_leaf(out, path, torch.full(shape, VECTOR_VALUES[path[-1]],
                                           dtype=leaf.dtype, device=device))
    for dtype in sorted(by_dtype, key=str):
        group = by_dtype[dtype]
        total = sum(math.prod(s) for _, s in group)
        flat = torch.empty(total, dtype=dtype, device=device)
        # one stream: chunk after chunk, each leaf scaled on its segment
        bounds, off = [], 0
        for path, shape in group:
            bounds.append((off, off + math.prod(shape), scale_of(path, shape)))
            off += math.prod(shape)
        for lo in range(0, total, CHUNK):
            hi = min(total, lo + CHUNK)
            z = torch.randn(hi - lo, generator=gen, device=device,
                            dtype=torch.float32)
            for a, b, scale in bounds:
                s, e = max(a, lo), min(b, hi)
                if s < e:
                    flat[s:e] = (z[s - lo:e - lo] * scale).to(dtype)
            del z
        for (path, shape), (a, b, _) in zip(group, bounds):
            set_leaf(out, path, flat[a:b].view(shape))
    return out


def param_count(tree: Any) -> int:
    return sum(leaf.numel() for _, leaf in leaves(tree))
