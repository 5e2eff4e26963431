"""Build and load the port's hand-written native code.

Each CUDA kernel is one CUDA C++ source under ``csrc/`` with a plain C
interface of one or more launch functions; each host routine is one C
source there. At first use a source is compiled (``nvcc`` for Hopper,
``sm_90a``, or the host C compiler) into a shared library under
``build/torch_kernels/`` beside the package (a directory ``.gitignore``
covers), named by a hash of the source and the flags so an edited source
is rebuilt, and loaded with ``ctypes``. Nothing here runs at import time:
importing the port needs no toolkit, no compiler and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Mapping, Optional, Sequence

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")

# --fmad=false: no multiply-add contraction, so float results follow the
# source's rounding order (the NMS keep masks must match bit for bit).
# No --use_fast_math: division and square root stay IEEE.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
CC_FLAGS = ("-std=c99", "-O2", "-shared", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built at first use with "
        "the CUDA toolkit's nvcc (put it on PATH or set CUDA_HOME)"
    )


def _cc() -> str:
    found = shutil.which(os.environ.get("CC", "cc")) or shutil.which("gcc")
    if found:
        return found
    raise RuntimeError(
        "no C compiler found: the port's host routines are built at first use "
        "with the host C compiler (put cc or gcc on PATH, or set CC)"
    )


class NativeLibrary:
    """One ``csrc/<name><suffix>`` source and its C entry points.

    ``entry_points`` maps each C function of the source to its argument
    types; every one returns an int status."""

    suffix = ".c"
    flags: Sequence[str] = CC_FLAGS

    def __init__(self, name: str, entry_points: Mapping[str, Sequence]):
        self.name = name
        self.source = os.path.join(CSRC_DIR, name + self.suffix)
        self.entry_points = {sym: list(args) for sym, args in entry_points.items()}
        self.build_log = ""
        self._lib: Optional[ctypes.CDLL] = None

    def compiler(self) -> str:
        return _cc()

    def library_path(self) -> str:
        with open(self.source, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(self.flags).encode()).hexdigest()
        return os.path.join(BUILD_DIR, f"lib{self.name}-{digest[:16]}.so")

    def build(self) -> ctypes.CDLL:
        """Compile (unless this source and these flags were built before)
        and load the library. Raises with the compiler's output when it
        fails."""
        if self._lib is not None:
            return self._lib
        path = self.library_path()
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(
                    [self.compiler(), *self.flags, "-o", tmp, self.source],
                    capture_output=True, text=True,
                )
                self.build_log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"{self.compiler()} failed to build {self.source}:\n{self.build_log}"
                    )
                os.replace(tmp, path)  # atomic: concurrent builds agree
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(path)
        for symbol, argtypes in self.entry_points.items():
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self._lib = lib
        return lib

    def call(self, symbol: str, *args) -> int:
        """Call one C entry point; returns its status."""
        return getattr(self.build(), symbol)(*args)


class CudaKernel(NativeLibrary):
    """One ``csrc/<name>.cu`` source, its C launch functions (each returns
    cudaGetLastError) and its launch count. ``launches`` is incremented by
    the Python wrapper once for each call that launches the kernel, and by
    nothing else, so a run can show that its main path went through the
    kernel."""

    suffix = ".cu"
    flags = NVCC_FLAGS

    def __init__(self, name: str, entry_points: Mapping[str, Sequence]):
        super().__init__(name, entry_points)
        self.launches = 0

    def compiler(self) -> str:
        return _nvcc()
