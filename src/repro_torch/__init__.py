"""PyTorch/CUDA port of the contribution-aware buffered-async FL system.

A second package beside the JAX package ``repro``, which stays the
reference. It imports ``torch`` and numpy, never ``jax`` and nothing of
``repro``; its layout mirrors ``repro`` so each module's counterpart is
found by name. Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""
