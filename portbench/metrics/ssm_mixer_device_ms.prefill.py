"""ssm_mixer_device_ms.prefill: device milliseconds a request between the
CUDA events at the edges of the program's ``ssm_mixer`` spans (every Mamba
layer's mixer), over the traced requests (``harness/spans.py``'s
``device_ms``)."""
from portbench.harness.spans import device_ms


def read(facts):
    return device_ms(facts, "ssm_mixer")
