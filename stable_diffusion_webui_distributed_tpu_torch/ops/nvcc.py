"""Build and load the port's CUDA kernels.

Each kernel source in ``csrc/`` is compiled with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, at first use, and loaded
with ``ctypes``. Nothing here runs when a module is imported.

With ``SDTPU_AOT`` off (the default) a library lives in ``_build/`` beside
the package's sources, named by the hash of its source, of the shared
headers in ``csrc/`` and of the toolchain (:func:`toolchain`: the
compiler's flags, ``nvcc --version``, ``torch.version.cuda`` and the
card's compute capability), so an edited source, a changed flag or
another toolchain or card builds anew and never loads a stale library; an
unchanged one is built once. With it on, a library goes through the
artifact store (``serving/aot.py``): loaded from its content-named file
after its sha256 is checked, or built by nvcc and saved there when its
cell is missing, damaged or of another runtime fingerprint (journaled
``aot_fallback``). Either way, a library whose ``ctypes`` load fails is
rebuilt once and loaded again; a second failure raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
import time
import weakref
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

from stable_diffusion_webui_distributed_tpu_torch.obs import (
    journal as obs_journal,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    prometheus as obs_prom,
)
from stable_diffusion_webui_distributed_tpu_torch.serving import aot
from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
    METRICS,
)

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

log = logging.getLogger(__name__)


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


def source_digest(source: Path) -> str:
    """The sha256 of ``source`` and of the headers in ``csrc/``."""
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return digest.hexdigest()


def library_path(source: Path) -> Path:
    """The library of ``source`` in ``_build/``: named by the hash of it,
    of the headers in ``csrc/`` and of :func:`toolchain`."""
    digest = hashlib.sha256(source_digest(source).encode())
    digest.update(toolchain().encode())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def _compile(source: Path, out: Path) -> str:
    """Run nvcc on ``source`` into ``out``; its output (``-Xptxas -v``:
    registers, shared memory and spills per instantiation)."""
    proc = subprocess.run(
        [nvcc_path(), *_NVCC_FLAGS, "-o", str(out), str(source)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} "
                           f"({proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr}")
    return proc.stdout + proc.stderr


def build(source: Path) -> Tuple[Path, str]:
    """Compile ``source`` into ``_build/``, once per content of it, of the
    headers in ``csrc/`` and of the toolchain. Returns the library's path
    and the compiler's output (kept beside the library for a later
    call)."""
    lib = library_path(source)
    log_file = lib.with_suffix(".ptxas.txt")
    if lib.exists():
        return lib, log_file.read_text() if log_file.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    out = _compile(source, tmp)
    log_file.write_text(out)
    os.replace(tmp, lib)
    return lib, out


#: every KernelLibrary of this process (the warmup report reads their
#: store outcomes)
_LIBRARIES: "weakref.WeakSet[KernelLibrary]" = weakref.WeakSet()


def store_outcomes() -> Dict[str, str]:
    """The artifact store's outcome of each library loaded through it,
    by kind: ``hit``, ``miss``, ``corrupt`` or ``fingerprint_mismatch``."""
    return {lib.kind: lib.outcome for lib in list(_LIBRARIES)
            if lib.outcome is not None}


class KernelLibrary:
    """One kernel's library: built and loaded at the first call of
    :meth:`function`, once per process."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = CSRC / source
        self.kind = self.source.stem
        self._symbol = symbol
        self._argtypes = list(argtypes)
        self._lock = threading.Lock()
        self._fn = None  # written under _lock
        #: what the last build gave: :meth:`function` loads it
        self._built: Optional[Tuple[Path, str]] = None
        #: the store's outcome of the last build (None with the gate off)
        self.outcome: Optional[str] = None
        _LIBRARIES.add(self)

    def build(self, damaged: bool = False) -> Tuple[Path, str]:
        """The library's path and the compiler's output ("" when nothing
        was compiled), which :meth:`function` then loads. ``damaged``: the
        library there failed to load, so it is dropped and compiled
        again."""
        if aot.enabled():
            self._built = self._build_stored(aot.get_store(), damaged)
        else:
            self.outcome = None
            if damaged:
                library_path(self.source).unlink(missing_ok=True)
            self._built = build(self.source)
        return self._built

    def _build_stored(self, store, damaged: bool) -> Tuple[Path, str]:
        """Load before build: the store's artifact on a hit; else nvcc,
        and the library saved to the store."""
        key, sig = source_digest(self.source), toolchain()
        if damaged:
            store.discard(key, sig)
            outcome, path = "corrupt", None
        else:
            outcome, path = store.load_path(key, sig)
        self.outcome = outcome
        if path is not None:
            return Path(path), ""
        if outcome == "miss":
            store.count("miss")
        else:
            # another runtime's or a damaged library: built again, never
            # loaded
            store.count("fallback")
            obs_journal.emit("aot_fallback", f"aot-{self.kind}",
                             reason=outcome, key=key, sig=sig[:128])
        os.makedirs(store.root, exist_ok=True)
        tmp = Path(store.root) / f"{self.kind}.{os.getpid()}.build.tmp"
        out = _compile(self.source, tmp)
        blob = tmp.read_bytes()
        if not store.save(key, sig, self.kind, blob):
            return tmp, out  # the disk refused: load the build itself
        tmp.unlink()
        sha = hashlib.sha256(blob).hexdigest()
        return Path(store.artifact_path(sha)), out

    def _bind(self, path: Path):
        fn = getattr(ctypes.CDLL(str(path)), self._symbol)
        fn.argtypes = self._argtypes
        fn.restype = ctypes.c_int
        return fn

    def _load(self):
        t0 = time.perf_counter()
        path, _ = self._built or self.build()
        try:
            fn = self._bind(path)
        except (OSError, AttributeError) as e:
            log.warning("%s: %s does not load (%s); rebuilding it",
                        self.kind, path, e)
            path, _ = self.build(damaged=True)
            return self._bind(path)  # a second failure raises
        if self.outcome == "hit":
            aot.get_store().count("hit")
            METRICS.record_aot_load(self.kind)
            obs_prom.observe_aot_load(self.kind, time.perf_counter() - t0)
        return fn

    def function(self):
        """The kernel's C entry point, which returns an int."""
        fn = self._fn
        if fn is not None:
            return fn
        with self._lock:
            if self._fn is None:
                self._fn = self._load()
            return self._fn
