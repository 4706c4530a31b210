"""Hand-written CUDA kernels, each beside its plain-PyTorch version.

One package per kernel family, as in the JAX package: ``kernel.py`` builds
and launches the CUDA source, ``ref.py`` holds the plain versions and
``ops.py`` is the public wrapper that picks between them by device.
"""
