"""K1-K3: the server pass kernels (``csrc/weighted_agg.cu``)."""
