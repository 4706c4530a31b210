"""moe_ffn_device_ms.prefill: device milliseconds a request between the
CUDA events at the edges of the program's ``moe_ffn`` spans (every MoE
layer's router, dispatch, experts and combine), over the traced requests
(``harness/spans.py``'s ``device_ms``)."""
from portbench.harness.spans import device_ms


def read(facts):
    return device_ms(facts, "moe_ffn")
