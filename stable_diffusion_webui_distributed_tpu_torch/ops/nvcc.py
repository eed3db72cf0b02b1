"""Build and load the port's CUDA kernels.

Each kernel source in ``csrc/`` is compiled with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, at first use, into
``_build/`` beside the package's sources, and loaded with ``ctypes``. A
library is named by the hash of its source, of the shared headers in
``csrc/`` and of the toolchain (:func:`toolchain`: the compiler's flags,
``nvcc --version``, ``torch.version.cuda`` and the card's compute
capability), so an edited source, a changed flag or another toolchain or
card builds anew and never loads a stale library; an unchanged one is
built once. Nothing here runs when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


#: ``nvcc --version``'s output, read once per process
_NVCC_VERSION: Optional[str] = None
_VERSION_LOCK = threading.Lock()


def nvcc_path() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def nvcc_version() -> str:
    """``nvcc --version``'s output (read once per process; "" when the
    compiler cannot be run)."""
    global _NVCC_VERSION
    with _VERSION_LOCK:
        if _NVCC_VERSION is None:
            try:
                proc = subprocess.run([nvcc_path(), "--version"],
                                      capture_output=True, text=True)
                _NVCC_VERSION = proc.stdout + proc.stderr
            except OSError:
                _NVCC_VERSION = ""
        return _NVCC_VERSION


def toolchain() -> str:
    """What besides the sources decides a library's bytes: the flags,
    the compiler's version, the CUDA runtime PyTorch was built for and
    the card's compute capability ("none" without a card)."""
    import torch

    try:
        cap = (".".join(map(str, torch.cuda.get_device_capability()))
               if torch.cuda.is_available() else "none")
    except Exception:  # noqa: BLE001 — no usable card
        cap = "none"
    return "\n".join([" ".join(_NVCC_FLAGS), nvcc_version(),
                      f"torch.version.cuda={torch.version.cuda}",
                      f"sm={cap}"])


def library_path(source: Path) -> Path:
    """The library of ``source``: named by the hash of it, of the headers
    in ``csrc/`` and of :func:`toolchain`."""
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(toolchain().encode())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def build(source: Path) -> Tuple[Path, str]:
    """Compile ``source`` into a shared library, once per content of it, of
    the headers in ``csrc/`` and of the toolchain. Returns the library's
    path and the compiler's output (``-Xptxas -v``: registers, shared
    memory and spills per instantiation, kept beside the library for a
    later call)."""
    lib = library_path(source)
    log = lib.with_suffix(".ptxas.txt")
    if lib.exists():
        return lib, log.read_text() if log.exists() else ""
    nvcc = nvcc_path()
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
