"""The kernel-library artifact store: content-hashed nvcc libraries on disk.

Port of the JAX package's ``serving/aot.py``, re-scoped to what the port
compiles. The JAX package serializes each compiled XLA stage per call
signature and hydrates a restarted engine from them; the port compiles
nothing per call signature (no ``torch.compile``, and a CUDA graph cannot
leave its process), so its compiled artifacts are the kernels' shared
libraries (``ops/nvcc.py``). The JAX package's ``AotFunction`` and the
engine's hydration have no counterpart here.

With ``SDTPU_AOT`` on, ``KernelLibrary`` loads before it builds: a
library's cell is keyed by its sources (the ``.cu`` file and
``csrc/*.cuh``, :func:`..ops.nvcc.source_digest`) and its toolchain string
(:func:`..ops.nvcc.toolchain`), its ``kind`` the source's stem
(``flash_attention``, ``ragged_attention``). The on-disk contract is the
JAX package's: ``<root>/manifest.json`` (``schema`` 1, ``cells`` by
:meth:`AotStore.cell_id`) and one artifact per content, named by its own
sha256 (here ``<sha256>.so``), every write a tmp file and ``os.replace``.

Safety contract:

- **Never a wrong library.** Each cell records the runtime fingerprint
  (:func:`runtime_fingerprint`: PyTorch and its CUDA, the toolchain, the
  card's name, compute capability and count); a mismatch is a rebuild,
  journaled ``aot_fallback``, never a load.
- **A damaged library is rebuilt.** An artifact whose bytes no longer
  hash to its cell's sha256 (truncated, bit-flipped, missing) drops its
  cell; unlike the JAX store, the damaged file is removed too, and so is
  the file of a cell that a rebuild replaces (nvcc's bytes vary from build
  to build), so :meth:`AotStore.verify` finds no orphan after a rebuild. A
  library whose ``ctypes`` load fails after a hit is dropped the same way
  and rebuilt once.
- **Gate off: ``_build/`` as before**, and the store's directory is never
  touched.

Evidence: ``sdtpu_aot_total{outcome}`` (hit / miss / saved / fallback),
``sdtpu_aot_load_seconds{kind}`` (a hit's hash check and ``ctypes`` load)
and ``DispatchMetrics.aot_loads``; ``tools/torch_aot_report.py`` renders
the manifest and verifies it against the artifacts on disk.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Any, Dict, Optional, Tuple

from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    env_flag,
    env_str,
)

MANIFEST_NAME = "manifest.json"
#: the artifact's suffix: a shared library
ARTIFACT_SUFFIX = ".so"
#: the manifest's schema (a reader that meets another treats the store as
#: empty rather than guess)
SCHEMA = 1


def enabled() -> bool:
    """The gate, read per call."""
    return env_flag("SDTPU_AOT", False)


def default_dir() -> str:
    """The store's root: ``SDTPU_AOT_DIR``, else ``~/.cache/sdtpu-aot``."""
    return env_str("SDTPU_AOT_DIR",
                   os.path.expanduser("~/.cache/sdtpu-aot"))


# -- runtime fingerprint -------------------------------------------------------

def runtime_fingerprint() -> Dict[str, str]:
    """What makes a library transferable: the same PyTorch and CUDA
    runtime, the same toolchain (nvcc's version and flags) and the same
    card ("none" and a count of 0 without one)."""
    import torch

    from stable_diffusion_webui_distributed_tpu_torch.ops import nvcc

    try:
        count = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        name = torch.cuda.get_device_name(0) if count else "none"
        cap = (".".join(map(str, torch.cuda.get_device_capability(0)))
               if count else "none")
    except Exception:  # noqa: BLE001 — no usable card
        count, name, cap = 0, "none", "none"
    return {
        "torch": str(torch.__version__),
        "torch_cuda": str(torch.version.cuda),
        "toolchain": nvcc.toolchain(),
        "device_name": str(name),
        "capability": cap,
        "device_count": str(count),
    }


def fingerprint_id(fp: Dict[str, str]) -> str:
    data = json.dumps(fp, sort_keys=True).encode("utf-8")
    return hashlib.sha256(data).hexdigest()[:16]


# -- the artifact store --------------------------------------------------------

class AotStore:
    """Content-addressed libraries and a JSON manifest under ``root``."""

    def __init__(self, root: Optional[str] = None,
                 fingerprint: Optional[Dict[str, str]] = None) -> None:
        self.root = root or default_dir()
        self.fp = dict(fingerprint) if fingerprint is not None \
            else runtime_fingerprint()
        self.fp_id = fingerprint_id(self.fp)
        # re-entrant: the manifest helpers take the guard their public
        # callers already hold
        self._lock = threading.RLock()
        self._manifest: Optional[Dict[str, Any]] = None  # guarded-by: _lock
        #: this process's outcomes (the warmup report reads them;
        #: sdtpu_aot_total exposes them)
        self.stats: Dict[str, int] = {"hit": 0, "miss": 0, "saved": 0,
                                      "fallback": 0}  # guarded-by: _lock

    # -- manifest -------------------------------------------------------------

    @staticmethod
    def cell_id(key_str: str, sig_str: str) -> str:
        data = json.dumps([key_str, sig_str]).encode("utf-8")
        return hashlib.sha256(data).hexdigest()[:32]

    def _load_manifest_locked(self) -> Dict[str, Any]:
        with self._lock:
            if self._manifest is None:
                doc: Dict[str, Any] = {"schema": SCHEMA, "cells": {}}
                try:
                    with open(os.path.join(self.root, MANIFEST_NAME),
                              encoding="utf-8") as f:
                        loaded = json.load(f)
                    if isinstance(loaded, dict) \
                            and loaded.get("schema") == SCHEMA \
                            and isinstance(loaded.get("cells"), dict):
                        doc = loaded
                except (OSError, ValueError):
                    pass  # absent or damaged manifest: an empty store
                self._manifest = doc
            return self._manifest

    def _write_manifest_locked(self) -> None:
        os.makedirs(self.root, exist_ok=True)
        path = os.path.join(self.root, MANIFEST_NAME)
        tmp = path + ".tmp"
        with self._lock:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(self._manifest, f, indent=1, sort_keys=True)
        os.replace(tmp, path)

    def manifest(self) -> Dict[str, Any]:
        """A copy of the manifest document (its cells copied)."""
        with self._lock:
            doc = self._load_manifest_locked()
            return {"schema": doc.get("schema"),
                    "cells": {k: dict(v) for k, v in doc["cells"].items()}}

    def stats_snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.stats)

    def count(self, outcome: str) -> None:
        """Tally one outcome here and in ``sdtpu_aot_total``."""
        with self._lock:
            self.stats[outcome] = self.stats.get(outcome, 0) + 1
        from stable_diffusion_webui_distributed_tpu_torch.obs import (
            prometheus as obs_prom,
        )

        obs_prom.aot_count(outcome)

    def artifact_path(self, sha256: str) -> str:
        return os.path.join(self.root, sha256 + ARTIFACT_SUFFIX)

    # -- load / save ------------------------------------------------------------

    def _lookup(self, key_str: str, sig_str: str
                ) -> Tuple[str, Optional[str], Optional[bytes]]:
        """``(outcome, path, bytes)`` of one cell: ``hit`` (the artifact's
        bytes hash to the cell's sha256), ``miss``, ``fingerprint_mismatch``
        or ``corrupt`` (the artifact is missing or its hash diverged: the
        cell is dropped and a damaged file removed). Never raises."""
        cid = self.cell_id(key_str, sig_str)
        with self._lock:
            doc = self._load_manifest_locked()
            cell = doc["cells"].get(cid)
            if cell is None:
                return "miss", None, None
            if cell.get("fingerprint_id") != self.fp_id:
                return "fingerprint_mismatch", None, None
            fname, want_sha = str(cell.get("file", "")), \
                str(cell.get("sha256", ""))
        path = os.path.join(self.root, fname)
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError:
            blob = None
        if blob is not None and hashlib.sha256(blob).hexdigest() == want_sha:
            return "hit", path, blob
        self._drop(cid, path if blob is not None else None)
        return "corrupt", None, None

    def _drop(self, cid: str, damaged: Optional[str]) -> None:
        with self._lock:
            doc = self._load_manifest_locked()
            doc["cells"].pop(cid, None)
            try:
                self._write_manifest_locked()
                if damaged is not None:
                    os.remove(damaged)
            except OSError:
                pass

    def load(self, key_str: str, sig_str: str
             ) -> Tuple[str, Optional[bytes]]:
        """``(outcome, bytes)`` of one cell (the JAX store's ``load``)."""
        outcome, _, blob = self._lookup(key_str, sig_str)
        return outcome, blob

    def load_path(self, key_str: str, sig_str: str
                  ) -> Tuple[str, Optional[str]]:
        """``(outcome, path)`` of one cell: on a hit, the artifact's own
        file, its sha256 checked (nothing is copied)."""
        outcome, path, _ = self._lookup(key_str, sig_str)
        return outcome, path

    def discard(self, key_str: str, sig_str: str) -> None:
        """Drop a cell and its artifact: a hit whose library would not
        load."""
        cid = self.cell_id(key_str, sig_str)
        with self._lock:
            cell = self._load_manifest_locked()["cells"].get(cid)
        if cell is not None:
            self._drop(cid, os.path.join(self.root,
                                         str(cell.get("file", ""))))

    def save(self, key_str: str, sig_str: str, kind: str,
             blob: bytes) -> bool:
        """Persist one artifact and back-fill its cell. The file is named
        by its sha256 (a damaged one was removed by the load that found
        it); the file of the cell it replaces (another runtime's build: nvcc's bytes vary
        from build to build) is removed once no cell claims it. False when
        the disk refuses (the library is then lost, not the request)."""
        sha = hashlib.sha256(blob).hexdigest()
        fname = sha + ARTIFACT_SUFFIX
        cid = self.cell_id(key_str, sig_str)
        try:
            os.makedirs(self.root, exist_ok=True)
            path = os.path.join(self.root, fname)
            if not os.path.exists(path):
                tmp = f"{path}.{os.getpid()}.tmp"
                with open(tmp, "wb") as f:
                    f.write(blob)
                os.replace(tmp, path)
            with self._lock:
                doc = self._load_manifest_locked()
                old = doc["cells"].get(cid, {}).get("file")
                doc["cells"][cid] = {
                    "kind": str(kind),
                    "key": key_str,
                    "sig": sig_str,
                    "file": fname,
                    "bytes": len(blob),
                    "sha256": sha,
                    "fingerprint_id": self.fp_id,
                    "fingerprint": dict(self.fp),
                    "created_at": time.time(),  # sdtpu-lint: wallclock
                }
                self._write_manifest_locked()
                if old and old != fname and not any(
                        c.get("file") == old for c in doc["cells"].values()):
                    os.remove(os.path.join(self.root, old))
        except OSError:
            return False
        self.count("saved")
        return True

    def verify(self) -> Dict[str, Any]:
        """The manifest against the disk: every cell's artifact present
        with its sha256, every ``*.so`` claimed by a cell."""
        doc = self.manifest()
        rows, bad = [], []
        claimed = set()
        for cid, cell in sorted(doc["cells"].items()):
            fname = str(cell.get("file", ""))
            claimed.add(fname)
            status = "ok"
            try:
                with open(os.path.join(self.root, fname), "rb") as f:
                    blob = f.read()
                if hashlib.sha256(blob).hexdigest() \
                        != str(cell.get("sha256", "")):
                    status = "sha_mismatch"
            except OSError:
                status = "missing"
            if status != "ok":
                bad.append(cid)
            rows.append({"cell": cid, "kind": cell.get("kind"),
                         "key": cell.get("key"), "sig": cell.get("sig"),
                         "bytes": cell.get("bytes"),
                         "fingerprint_id": cell.get("fingerprint_id"),
                         "status": status})
        orphans = []
        try:
            for fname in sorted(os.listdir(self.root)):
                if fname.endswith(ARTIFACT_SUFFIX) and fname not in claimed:
                    orphans.append(fname)
        except OSError:
            pass
        return {"root": self.root, "fingerprint": dict(self.fp),
                "fingerprint_id": self.fp_id, "cells": rows,
                "divergent": bad, "orphans": orphans,
                "ok": not bad and not orphans}


# -- the process-wide store (by resolved directory) ------------------------------

_STORE_LOCK = threading.Lock()
_STORES: Dict[str, AotStore] = {}  # guarded-by: _STORE_LOCK


def get_store() -> AotStore:
    """The store of the current ``SDTPU_AOT_DIR``, resolved per call."""
    root = default_dir()
    with _STORE_LOCK:
        store = _STORES.get(root)
        if store is None:
            store = AotStore(root)
            _STORES[root] = store
        return store
