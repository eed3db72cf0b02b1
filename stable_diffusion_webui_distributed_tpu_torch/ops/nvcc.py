"""Build and load the port's CUDA kernels.

Each kernel source in ``csrc/`` is compiled with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, at first use, into
``_build/`` beside the package's sources, and loaded with ``ctypes``. A
library is named by the hash of its source and of the shared headers in
``csrc/``, so an edited source builds anew and an unchanged one is built
once. Nothing here runs when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def build(source: Path) -> Tuple[Path, str]:
    """Compile ``source`` into a shared library, once per content of it and
    of the headers in ``csrc/``. Returns the library's path and the
    compiler's output (``-Xptxas -v``: registers, shared memory and spills
    per instantiation, kept beside the library for a later call)."""
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    lib = BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"
    log = lib.with_suffix(".ptxas.txt")
    if lib.exists():
        return lib, log.read_text() if log.exists() else ""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(source)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} "
                           f"({proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr}")
    log.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


class KernelLibrary:
    """One kernel's library: built and loaded at the first call of
    :meth:`function`, once per process."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = CSRC / source
        self._symbol = symbol
        self._argtypes = list(argtypes)
        self._lock = threading.Lock()
        self._fn = None  # written under _lock

    def build(self) -> Tuple[Path, str]:
        return build(self.source)

    def function(self):
        """The kernel's C entry point, which returns an int."""
        fn = self._fn
        if fn is not None:
            return fn
        with self._lock:
            if self._fn is None:
                path, _ = self.build()
                fn = getattr(ctypes.CDLL(str(path)), self._symbol)
                fn.argtypes = self._argtypes
                fn.restype = ctypes.c_int
                self._fn = fn
            return self._fn
