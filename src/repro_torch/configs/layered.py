"""A config whose layers differ: a mixer kind and an FFN kind per layer.

``LayeredConfig`` is a port-only frozen subclass of ``ModelConfig``: the
fields the JAX package's ``ModelConfig`` has keep their meaning, and the
ones below are new. ``models/model.py::build_model`` gives such a config
the layered stack (``models/blocks.py``, ``LayeredModel``); a plain
``ModelConfig`` keeps the homogeneous one. The layered stack is Jamba's
throughout: no positions (NoPE), RMSNorms on the Mamba layers' dt, B and C,
top-k gates as the softmax gives them, and a dropless MoE.

The layer types follow transformers' ``JambaConfig``: layer ``i`` is
attention where ``i % attn_layer_period == attn_layer_offset`` and Mamba
elsewhere (``layers_block_type``); its FFN is the MoE where ``i %
expert_layer_period == expert_layer_offset`` and the dense MLP elsewhere
(``layers_num_experts``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

from repro_torch.configs.base import ModelConfig

MIXERS = ("ssm", "attn")
FFNS = ("mlp", "moe")


@dataclasses.dataclass(frozen=True)
class LayeredConfig(ModelConfig):
    attn_layer_period: int = 1  # layer i is attention where
    attn_layer_offset: int = 0  # i % period == offset, else Mamba-1
    expert_layer_period: int = 1  # layer i's FFN is the MoE where
    expert_layer_offset: int = 0  # i % period == offset, else the MLP
    experts_held: int = 0  # experts [0, held) on this device; 0 = all

    def mixer_kind(self, i: int) -> str:
        return "attn" if i % self.attn_layer_period == self.attn_layer_offset \
            else "ssm"

    def ffn_kind(self, i: int) -> str:
        if self.num_experts and \
                i % self.expert_layer_period == self.expert_layer_offset:
            return "moe"
        return "mlp"

    @functools.cached_property
    def schedule(self) -> Tuple[Tuple[str, int, str, int], ...]:
        """Per layer: (mixer kind, its index in that kind's stack, FFN
        kind, its index in that kind's stack); worked out once a config."""
        seen: Dict[str, int] = {}
        out = []
        for i in range(self.num_layers):
            mixer, ffn = self.mixer_kind(i), self.ffn_kind(i)
            out.append((mixer, seen.get(mixer, 0), ffn, seen.get(ffn, 0)))
            seen[mixer] = seen.get(mixer, 0) + 1
            seen[ffn] = seen.get(ffn, 0) + 1
        return tuple(out)

    def layer_counts(self) -> Dict[str, int]:
        """Layers of each mixer and FFN kind."""
        counts = dict.fromkeys(MIXERS + FFNS, 0)
        for mixer, _, ffn, _ in self.schedule:
            counts[mixer] += 1
            counts[ffn] += 1
        return counts

    @property
    def resolved_experts_held(self) -> int:
        return self.experts_held or self.num_experts

    def smoke_overrides(self, kw: Dict) -> Dict:
        """What ``smoke_variant`` changes beyond its common cuts: one whole
        period of layers (every kind present), the GQA ratio, dt_rank from
        the smoke width, and the held share of the smoke's experts."""
        heads = kw["num_heads"]
        out = {"num_layers": max(self.attn_layer_period,
                                 self.expert_layer_period),
               "num_kv_heads": max(1, heads * self.num_kv_heads
                                   // self.num_heads),
               "ssm_dt_rank": None}
        if self.experts_held:
            e = kw["num_experts"]
            out["experts_held"] = max(1, e * self.experts_held
                                      // self.num_experts)
        return out
