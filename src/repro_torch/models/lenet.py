"""LeNet-5 (the paper's Fashion-MNIST backbone) in PyTorch.

Conv(6,5x5) -> avgpool -> Conv(16,5x5) -> avgpool -> FC120 -> FC84 -> FC10.

Parameters keep the JAX package's layout: conv weights HWIO, fc weights
``(din, dout)``, inputs NHWC ``(B, 28, 28, 1)``. The forward permutes
internally (``w.permute(3, 2, 0, 1)`` for ``conv2d``, ``x @ w`` for the fc
layers), so the flat parameter vector and the version-ring rows are the
JAX package's, and carrying weights across is a plain copy.

``apply_lenet``/``lenet_loss`` are pure functions of a nested parameter
dict, which is what ``torch.func.grad``/``vmap`` transform in the client
update; ``LeNet.forward`` is ``apply_lenet`` on the module's own
parameters.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.utils.device import DeviceLike


def init_lenet(generator: Optional[torch.Generator] = None,
               num_classes: int = 10, in_channels: int = 1,
               device: DeviceLike = "cpu") -> Dict[str, Dict[str, torch.Tensor]]:
    """Random parameters with the JAX package's distributions (N(0,1) scaled
    by fan_in^-1/2, zero biases). Draws on the CPU from ``generator``."""

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32)

    def conv_w(kh, kw, cin, cout):
        return normal(kh, kw, cin, cout) * (kh * kw * cin) ** -0.5

    def fc(din, dout):
        return normal(din, dout) * din ** -0.5

    params = {
        "c1": {"w": conv_w(5, 5, in_channels, 6), "b": torch.zeros(6)},
        "c2": {"w": conv_w(5, 5, 6, 16), "b": torch.zeros(16)},
        "f1": {"w": fc(16 * 4 * 4, 120), "b": torch.zeros(120)},
        "f2": {"w": fc(120, 84), "b": torch.zeros(84)},
        "f3": {"w": fc(84, num_classes), "b": torch.zeros(num_classes)},
    }
    return {name: {k: v.to(device) for k, v in layer.items()}
            for name, layer in params.items()}


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """NCHW activations, HWIO weights, VALID padding."""
    return F.conv2d(x, w.permute(3, 2, 0, 1), b)


def apply_lenet(params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """x: (B, 28, 28, 1) NHWC -> logits (B, num_classes)."""
    h = x.permute(0, 3, 1, 2)  # NCHW for conv2d
    h = torch.tanh(_conv(h, params["c1"]["w"], params["c1"]["b"]))  # (B,6,24,24)
    h = F.avg_pool2d(h, 2)  # (B,6,12,12)
    h = torch.tanh(_conv(h, params["c2"]["w"], params["c2"]["b"]))  # (B,16,8,8)
    h = F.avg_pool2d(h, 2)  # (B,16,4,4)
    # f1 consumes the NHWC flatten (h, w, c), as in the JAX model
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = torch.tanh(h @ params["f1"]["w"] + params["f1"]["b"])
    h = torch.tanh(h @ params["f2"]["w"] + params["f2"]["b"])
    return h @ params["f3"]["w"] + params["f3"]["b"]


def lenet_loss(params: Dict[str, Any], batch: Tuple[torch.Tensor, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: (x (B,28,28,1), y (B,)) -> (mean CE, metrics)."""
    x, y = batch
    y = y.long()
    logits = apply_lenet(params, x)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y[:, None])[:, 0]
    ce = torch.mean(lse - gold)
    acc = torch.mean((torch.argmax(logits, -1) == y).to(torch.float32))
    return ce, {"ce": ce, "acc": acc}


class LeNet(nn.Module):
    """LeNet as a module; its parameters are the JAX-layout tensors."""

    def __init__(self, params: Dict[str, Dict[str, torch.Tensor]]):
        super().__init__()
        for name in sorted(params):
            self.add_module(name, nn.ParameterDict(
                {k: nn.Parameter(v) for k, v in params[name].items()}))

    def param_tree(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The parameters as the nested dict the functional API takes."""
        return {name: dict(layer.items())
                for name, layer in self.named_children()}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_lenet(self.param_tree(), x)
