"""K4: the fused int8 dequantize-distance kernel (``csrc/ring_codec.cu``)."""
