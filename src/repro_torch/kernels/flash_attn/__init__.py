"""K5: causal / sliding-window attention with an online softmax (``csrc/flash_attn.cu``)."""
