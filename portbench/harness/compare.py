"""The numbers that decide ``correct``, computed the same way for every
cell of a kind.

Training (a cohort round is one step): the fresh loss of each of the
first rounds, and per leaf the norm of the first round's update to the
global model and of its change over the first rounds. A norm is compared
as the gap between the program's and the reference's, over the larger of
the reference leaf's norm and the median leaf's; the number is the worst
leaf's, or the median leaf's (a cell's limits file names which it
holds). A stacked layer leaf counts as one leaf a layer. Leaves whose
reference update is under ``SKIP_BELOW`` of the median leaf's move by
round-off alone and are left out (of that comparison).

Serving: the widest gap between the program's and the reference's logits
of a checked answer, over the reference row's standard deviation.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

SKIP_BELOW = 1e-3

Path = Tuple


def leaf_items(tree: Any, prefix: Path = ()) -> List[Tuple[Path, torch.Tensor]]:
    """(path, tensor) in sorted-key order; a stacked layer leaf gives one
    item a layer."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out.extend(leaf_items(tree[key], prefix + (key,)))
        return out
    if prefix and prefix[0] == "layers":
        return [(prefix + (i,), tree[i]) for i in range(tree.shape[0])]
    return [(prefix, tree)]


@torch.no_grad()
def diff_norms(new: Any, old: Any) -> Dict[Path, float]:
    """Per leaf: ``||new - old||`` in f32."""
    a, b = leaf_items(new), leaf_items(old)
    vals = torch.stack([torch.linalg.vector_norm(x.float() - y.float())
                        for (_, x), (_, y) in zip(a, b)])
    return dict(zip([p for p, _ in a], vals.cpu().tolist()))


def leaf_gaps(prog: Dict[Path, float], ref: Dict[Path, float]
              ) -> Dict[Path, float]:
    """Per compared leaf: |prog - ref| / max(ref, median ref)."""
    vals = sorted(ref.values())
    med = vals[len(vals) // 2]
    return {path: abs(prog[path] - r) / max(r, med)
            for path, r in ref.items() if r >= SKIP_BELOW * med}


def norm_gap(prog: Dict[Path, float], ref: Dict[Path, float]) -> float:
    """The worst leaf's gap."""
    return max(leaf_gaps(prog, ref).values())


def median_gap(prog: Dict[Path, float], ref: Dict[Path, float]) -> float:
    """The median leaf's gap: steady where one small leaf's rounding sets
    the worst."""
    gaps = sorted(leaf_gaps(prog, ref).values())
    return gaps[len(gaps) // 2]


def worst_leaf(prog: Dict[Path, float], ref: Dict[Path, float]) -> str:
    gaps = leaf_gaps(prog, ref)
    return ".".join(map(str, max(gaps, key=gaps.get)))


def loss_gap(prog: List[float], ref: List[float]) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))


@torch.no_grad()
def logit_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """Rows (n, V): the widest |prog - ref| over each reference row's std,
    worst row."""
    prog, ref = prog.float(), ref.float()
    err = (prog - ref).abs().amax(-1) / ref.std(-1)
    return float(err.max())
