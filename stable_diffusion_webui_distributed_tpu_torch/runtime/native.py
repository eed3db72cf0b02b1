"""Native runtime components: the PNG encoder, built at first use.

Port of the JAX package's ``runtime/native.py``. Every finished image is
encoded to PNG on the host; ``native/png_encoder.cpp`` (the port's own
copy) writes it straight through zlib. The library is compiled with
``g++`` at first use into ``_build/`` beside the package's sources, named
by the hash of its source, its flags and ``g++ --version`` (as
``ops/nvcc.py`` names the kernel libraries), so an edited source or
another compiler builds anew and an unchanged one is built once.

:func:`encode_png` returns None where the library cannot be built or
loaded (no ``g++``, no ``zlib.h``), and the caller then encodes with PIL
(``pipeline/payload.py``). That fallback is never silent: the first
failure logs the compiler's error at warning level, and :func:`stats`
counts native encodes and fallbacks.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" \
    / "png_encoder.cpp"
BUILD_DIR = SOURCE.parent.parent / "_build"
_FLAGS = ("-O3", "-shared", "-fPIC")

log = logging.getLogger(__name__)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None  # guarded-by: _lock
_lib_failed = False  # guarded-by: _lock
#: native encodes and PIL fallbacks of this process
_stats = {"native": 0, "fallback": 0}  # guarded-by: _lock


def gxx_version() -> str:
    """``g++ --version``'s output ("" when the compiler cannot be run)."""
    gxx = shutil.which("g++")
    if gxx is None:
        return ""
    try:
        proc = subprocess.run([gxx, "--version"], capture_output=True,
                              text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return proc.stdout + proc.stderr


def library_path() -> Path:
    """The encoder's library in ``_build/``: named by the hash of its
    source, the flags and the compiler's version."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(_FLAGS).encode())
    digest.update(gxx_version().encode())
    return BUILD_DIR / f"{SOURCE.stem}-{digest.hexdigest()[:16]}.so"


def _build_library() -> Path:
    """Compile the encoder into ``_build/`` once per source, flags and
    compiler; raises with the compiler's error when it cannot."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("no g++ on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *_FLAGS, str(SOURCE), "-lz", "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(_build_library()))
            lib.sdtpu_encode_png.restype = ctypes.c_long
            lib.sdtpu_encode_png.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_char_p, ctypes.c_long,
            ]
        except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
            _lib_failed = True
            log.warning("native PNG encoder unavailable, encoding with "
                        "PIL: %s", e)
            return None
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native encoder is built and loaded (builds it)."""
    return _get_lib() is not None


def warm_up(background: bool = True) -> None:
    """Build and load the library ahead of the first request, so the
    compile never lands on the serving path."""
    if background:
        threading.Thread(target=_get_lib, name="native-warmup",
                         daemon=True).start()
    else:
        _get_lib()


def record_fallback() -> None:
    """Count one image the caller encoded with PIL instead."""
    with _lock:
        _stats["fallback"] += 1


def stats() -> Dict[str, int]:
    """Native encodes and PIL fallbacks so far in this process."""
    with _lock:
        return dict(_stats)


def encode_png(img: np.ndarray, compression_level: int = 6
               ) -> Optional[bytes]:
    """(H, W, 3|4) uint8 -> PNG bytes via the native encoder, or None when
    the native path is unavailable or the input is not such an array (the
    caller falls back to PIL)."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        return None
    lib = _get_lib()
    if lib is None:
        return None
    img = np.ascontiguousarray(img)
    h, w, c = img.shape
    cap = w * h * (c + 1) + 4096
    buf = ctypes.create_string_buffer(cap)
    n = lib.sdtpu_encode_png(
        img.ctypes.data_as(ctypes.c_char_p), w, h, c, compression_level,
        buf, cap)
    if n < 0:  # undersized buffer: retry at the reported size
        cap = -n
        buf = ctypes.create_string_buffer(cap)
        n = lib.sdtpu_encode_png(
            img.ctypes.data_as(ctypes.c_char_p), w, h, c, compression_level,
            buf, cap)
    if n <= 0:
        return None
    with _lock:
        _stats["native"] += 1
    return buf.raw[:n]
