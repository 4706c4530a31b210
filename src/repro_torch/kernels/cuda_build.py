"""Build and load a CUDA source of ``csrc/`` as a plain-C shared library.

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
at first use and loaded with ``ctypes``. The build lands in
``build/repro_torch/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of the source, the headers of ``csrc/``
and the flags (the common ones and the library's own), so a changed
source rebuilds and concurrent first uses (``pytest -n 6``) never see a
half-written library: each builds to a private temp name, then renames it
into place atomically.

Nothing here runs at import time: the CPU tests import the kernel modules
on machines without ``nvcc`` or a card.

Under a traced call (``obs.trace.active_tracer()``) a library's first load
in a process is a ``kernel_load`` span (args: ``library``, and ``built``:
whether no build was there) and its nvcc run a ``kernel_build`` span.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from repro_torch.obs.trace import (
    SPAN_KERNEL_BUILD,
    SPAN_KERNEL_LOAD,
    active_tracer,
)

PKG = Path(__file__).resolve().parents[1]  # src/repro_torch
CSRC = PKG / "csrc"
BUILD_DIR = PKG.parents[1] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

Signatures = Dict[str, Tuple[object, List[object]]]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found on PATH or under {cuda_home}; the "
                           "CUDA kernels cannot be built")
    return str(path)


class CudaLibrary:
    """One ``csrc/<name>.cu`` source, built once per process and bound.

    ``signatures`` maps each exported C function to ``(restype,
    argtypes)``. Every C entry point returns a ``cudaError_t`` as an int,
    and the library exports ``<prefix>_error_string`` to name it.
    """

    def __init__(self, name: str, signatures: Signatures, error_fn: str,
                 extra_flags: Tuple[str, ...] = ()):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.signatures = signatures
        self.error_fn = error_fn
        self.flags = NVCC_FLAGS + tuple(extra_flags)
        self.ptxas_info: List[str] = []  # ptxas's report, from a build here
        self._lock = threading.Lock()
        self._lib = None

    def path(self) -> Path:
        """Where the built library for the current sources and flags lives."""
        digest = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):
            digest.update(header.read_bytes())
        digest.update(" ".join(self.flags).encode())
        return BUILD_DIR / f"lib{self.name}_{digest.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile the library if it is not built yet; return its path."""
        out = self.path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=out.stem + ".", suffix=".tmp",
                                   dir=BUILD_DIR)
        os.close(fd)
        try:
            with active_tracer().span(SPAN_KERNEL_BUILD, cat="kernel",
                                      library=self.name):
                proc = subprocess.run(
                    [nvcc(), *self.flags, "-I", str(CSRC), "-o", tmp,
                     str(self.source)], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) on {self.source}:\n"
                    f"{proc.stdout}\n{proc.stderr}")
            self.ptxas_info = ptxas_report(proc.stdout + proc.stderr)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return out

    def load(self) -> ctypes.CDLL:
        """Build (once per process) and load the library, its C functions
        bound to their signatures."""
        with self._lock:
            if self._lib is None:
                tracer = active_tracer()
                args = ({"library": self.name,
                         "built": not self.path().exists()}
                        if tracer.enabled else {})
                with tracer.span(SPAN_KERNEL_LOAD, cat="kernel", **args):
                    lib = ctypes.CDLL(str(self.build()))
                for fn_name, (restype, argtypes) in self.signatures.items():
                    fn = getattr(lib, fn_name)
                    fn.restype = restype
                    fn.argtypes = argtypes
                self._lib = lib
            return self._lib

    def check(self, lib: ctypes.CDLL, code: int, what: str) -> None:
        """Raise if a C entry point reported a refused launch."""
        if code != 0:
            err = getattr(lib, self.error_fn)(code).decode()
            raise RuntimeError(f"{what} launch failed: {err} ({code})")


def ptxas_report(log: str) -> List[str]:
    """The lines of ``-Xptxas -v`` output that name a kernel and give its
    registers, shared memory and spills (ptxas prints the spill line without
    its ``ptxas info`` prefix)."""
    keep = ("Compiling entry function", "Used", "spill stores")
    return [line.strip() for line in log.splitlines()
            if any(k in line for k in keep)]


def stream(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream
