"""The plain reference of the contribution-aware cohort round.

From the same inputs as the program (weights, batches, arrival masks, data
sizes), one round is:

* each of the C slots trains M local SGD steps from its current local
  parameters (``p <- p - lr * grad``, the step rounded to the parameter's
  storage dtype and added there); its upload is ``base - end``;
* the eq. 4 probe: ``P_i = N_i * loss(x^t, probe_i)``;
* eq. 3: ``S_i = (min_j d_j + eps) / (d_i + eps)`` clipped to [0, 1],
  ``d_i = ||x^t - base_i||^2`` over the whole flat vector, the minimum over
  the slots that arrived;
* the paper's weights ``w_i = P_i / max(S_i, s_min)`` on the arrived
  slots, scaled to mean 1 over them;
* eq. 5: ``x^{t+1} = x^t - eta_g / k_eff * sum_i w_i Delta_i``;
* arrived slots take the new model as their state and base; stragglers
  keep their local progress and their old base (the paper's weighting
  reads staleness from the distances alone, so versions are not kept).

The state is a dict of parameter trees in their storage dtypes; the
arithmetic is float32 (``numerics.Numerics``). ``half_batch`` plants a
fault (each local step and probe sees the first half of each sequence's
tokens, the mean over the rest), for the control readings.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

from portbench.reference import lm
from portbench.reference.numerics import Numerics

EPS = 1e-12


def tree_map(fn: Callable, *trees: Any) -> Any:
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def index_batch(batch: Dict, *idx) -> Dict:
    return {k: v[idx] for k, v in batch.items()}


def cut_half(batch: Dict) -> Dict:
    s = batch["tokens"].shape[-1] // 2
    return {k: v[..., :s] for k, v in batch.items()}


class Round:
    """The cohort round over ``params`` (a tree in storage dtypes)."""

    def __init__(self, cfg: Dict, mix: Dict, params: Any, num: Numerics,
                 half_batch: bool = False):
        self.cfg, self.mix, self.num = cfg, mix, num
        self.half = half_batch
        c = mix["cohort"]
        self.glob = params
        self.slot_params = [params] * c  # immutable trees: shared until set
        self.slot_base = [params] * c

    def _loss(self, params, batch, grad: bool):
        if self.half:
            batch = cut_half(batch)
        return lm.loss(self.cfg, params, batch, self.num, remat=grad)

    def local_train(self, start: Any, batches: Dict) -> Any:
        """M SGD steps from ``start``; returns the end parameters."""
        lr = self.mix["local_lr"]
        p = start
        for m in range(self.mix["local_steps"]):
            leaves = lm.fp32_copy(p, requires_grad=True)
            value = self._loss(leaves, index_batch(batches, m), grad=True)
            grads = torch.autograd.grad(value, tree_leaves(leaves))
            g_it = iter(grads)
            flat_g = {id(x): next(g_it) for x in tree_leaves(leaves)}
            num = self.num

            def step(pv, lv):
                upd = num.store(-lr * flat_g[id(lv)], pv.dtype).float()
                return num.store(pv.float() + upd, pv.dtype)

            p = tree_map(step, p, leaves)
            del leaves, grads, flat_g, value
        # the upload's bookkeeping in the storage dtype: delta, then end
        delta = tree_map(lambda a, b: self.num.store(a.float() - b.float(),
                                                      a.dtype), start, p)
        return tree_map(lambda a, d: self.num.store(a.float() - d.float(),
                                                     a.dtype), start, delta)

    @torch.no_grad()
    def probe(self, probe: Dict) -> torch.Tensor:
        return torch.stack([
            self._loss(self.glob, index_batch(probe, c), grad=False)
            for c in range(self.mix["cohort"])]).float()

    def step(self, batch: Dict) -> Dict:
        mix = self.mix
        c = mix["cohort"]
        arrival = [float(a) for a in batch["arrival"]]
        ends = []
        for i in range(c):
            ends.append(self.local_train(
                self.slot_params[i],
                {k: v[i] for k, v in batch["local"].items()}))
        with torch.no_grad():
            losses = self.probe(batch["probe"])
            sizes = torch.as_tensor(batch["data_sizes"], dtype=torch.float32,
                                    device=losses.device)
            mask = torch.tensor(arrival, dtype=torch.float32,
                                device=losses.device)
            dists = torch.stack([
                sum(torch.sum((x.float() - b.float()) ** 2)
                    for x, b in zip(tree_leaves(self.glob),
                                    tree_leaves(self.slot_base[i])))
                for i in range(c)])
            p_stat = sizes * losses
            d_min = torch.min(torch.where(mask > 0, dists, dists.max()))
            s = torch.clamp((d_min + EPS) / (dists + EPS), 0.0, 1.0)
            w = p_stat / torch.clamp(s, min=mix["s_min"]) * mask
            n_arr = torch.clamp(mask.sum(), min=1.0)
            w = w * n_arr / torch.clamp(w.sum(), min=1e-12)
            coef = w * (mix["global_lr"] / n_arr)

            def apply(x, *bases_ends):
                upd = torch.zeros_like(x, dtype=torch.float32)
                for i in range(c):
                    if arrival[i] > 0:
                        base, end = bases_ends[i], bases_ends[c + i]
                        delta = self.num.store(base.float() - end.float(),
                                               base.dtype).float()
                        upd = upd + coef[i] * delta
                return self.num.store(x.float() - upd, x.dtype)

            new = tree_map(apply, self.glob, *self.slot_base, *ends)
            fresh = torch.sum(losses * mask) / n_arr
        for i in range(c):
            if arrival[i] > 0:
                self.slot_params[i] = new
                self.slot_base[i] = new
            else:
                self.slot_params[i] = ends[i]
        self.glob = new
        return {"fresh_loss_mean": float(fresh), "weights": w.tolist(),
                "staleness": s.tolist()}
