"""The models' RMSNorm, forward and backward (``csrc/rms_norm.cu``)."""
