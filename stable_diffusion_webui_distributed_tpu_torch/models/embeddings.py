"""Textual-inversion embeddings (webui's ``embeddings/`` directory).

Port of the JAX package's ``models/embeddings.py``. Every webui worker
resolves the embedding names a prompt mentions against its ``embeddings/``
directory and splices the learned vectors into CLIP's token-embedding
stream; the reference ships prompts verbatim and relies on each node to
do so.

File formats (those webui's loader takes):

- ``.safetensors`` with ``emb_params`` (one encoder) or ``clip_l`` /
  ``clip_g`` (SDXL's two), read with the port's own reader
  (``models/safetensors_io.py``: F16 upcast to f32, BF16 refused);
- a torch ``.pt`` with ``string_to_param`` (webui's training output);
- diffusers' ``.bin`` / ``.pt`` form: one tensor under any name.

``.pt`` and ``.bin`` files go through ``torch.load(weights_only=True)``:
embeddings are downloaded from sharing sites, and a full unpickle would
run a malicious file's code.

The tokenizer emits ``n_vectors`` placeholder tokens per mention
(``models/prompt.py`` ``tokenize_with_embeddings``); the text encoder
replaces those rows of the token-embedding lookup with the vectors
(``models/clip.py`` ``inject_values`` / ``inject_mask``).
"""

from __future__ import annotations

import logging
import os
from collections.abc import Mapping
from typing import Dict, List, Optional, Tuple

import numpy as np

from stable_diffusion_webui_distributed_tpu_torch.models.safetensors_io import (
    load_safetensors,
)

log = logging.getLogger(__name__)

#: the embedding files a scan takes
_SUFFIXES = (".safetensors", ".pt", ".bin")


class Embedding:
    """One loaded embedding: its ``(n_vectors, hidden)`` f32 stacks for
    CLIP-L and, for SDXL, OpenCLIP-bigG (which must hold as many)."""

    def __init__(self, name: str, clip_l: np.ndarray,
                 clip_g: Optional[np.ndarray] = None):
        self.name = name
        self.clip_l = np.asarray(clip_l, np.float32)
        self.clip_g = None if clip_g is None else np.asarray(clip_g,
                                                             np.float32)
        if self.clip_l.ndim == 1:
            self.clip_l = self.clip_l[None]
        if self.clip_g is not None and self.clip_g.ndim == 1:
            self.clip_g = self.clip_g[None]
        if self.clip_g is not None and \
                len(self.clip_g) != len(self.clip_l):
            raise ValueError(
                f"embedding '{name}': clip_l has {len(self.clip_l)} "
                f"vectors but clip_g has {len(self.clip_g)}")

    @property
    def n_vectors(self) -> int:
        return self.clip_l.shape[0]


def _from_state_dict(name: str, sd: Dict[str, np.ndarray]) -> Embedding:
    lowered = {k.lower(): v for k, v in sd.items()}
    if "clip_l" in lowered or "clip_g" in lowered:
        return Embedding(name, lowered["clip_l"], lowered.get("clip_g"))
    if "emb_params" in lowered:
        return Embedding(name, lowered["emb_params"])
    if "string_to_param" in sd:  # webui's nested .pt layout
        inner = sd["string_to_param"]
        key = "*" if "*" in inner else next(iter(inner))
        return Embedding(name, np.asarray(inner[key], np.float32))
    if len(sd) == 1:  # diffusers: {token: tensor}
        return Embedding(name, next(iter(sd.values())))
    raise ValueError(
        f"embedding '{name}': unrecognized keys {sorted(sd)[:4]}")


def load_embedding(path: str) -> Embedding:
    """Load one embedding file (formats in the module docstring)."""
    name = os.path.splitext(os.path.basename(path))[0]
    if path.endswith(".safetensors"):
        return _from_state_dict(name, load_safetensors(path))
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "string_to_param" in sd:
        inner = {k: v.detach().float().numpy()
                 for k, v in sd["string_to_param"].items()}
        return _from_state_dict(name, {"string_to_param": inner})
    return _from_state_dict(
        name,
        {k: (v.detach().float().numpy() if hasattr(v, "detach") else
             np.asarray(v, np.float32))
         for k, v in sd.items()
         if hasattr(v, "shape")})


class EmbeddingStore:
    """A directory's embeddings by name, each loaded on first lookup.

    Names match case-insensitively on the file stem, as webui's embedding
    database does. A file that fails to load is logged and skipped: a bad
    file must not take the node down."""

    def __init__(self, directory: Optional[str]):
        self._paths: Dict[str, str] = {}   # lower-case name -> path
        self._cache: Dict[str, Optional[Embedding]] = {}
        #: bumped by every rescan; the engine's conditioning cache keys on
        #: it, so nothing derived from the old file set is served
        self.generation = 0
        self.rescan(directory)

    def rescan(self, directory: Optional[str]) -> None:
        """Discover ``directory`` again, in place: engines hold this store,
        so a refresh must change it rather than build another."""
        self.directory = directory
        self._paths = {}
        self._cache = {}
        self.generation += 1
        if directory and os.path.isdir(directory):
            for fn in sorted(os.listdir(directory)):
                if fn.endswith(_SUFFIXES):
                    stem = os.path.splitext(fn)[0]
                    self._paths[stem.lower()] = os.path.join(directory, fn)

    def names(self) -> List[str]:
        return sorted(self._paths)

    def lookup(self, name: str) -> Optional[Embedding]:
        key = name.lower()
        if key not in self._paths:
            return None
        if key not in self._cache:
            try:
                self._cache[key] = load_embedding(self._paths[key])
            except Exception as e:  # noqa: BLE001 — skip bad files
                log.error("embedding '%s' failed to load: %s", name, e)
                self._cache[key] = None
        return self._cache[key]

    def vector_counts(self) -> "LazyCounts":
        """``{name: n_vectors}`` for the tokenizer's placeholder runs: a
        file is loaded only when its count is read, i.e. for the names a
        prompt mentions."""
        return LazyCounts(self)


class LazyCounts(Mapping):
    """Read-through ``name -> n_vectors`` view of an :class:`EmbeddingStore`.
    Iterating and truth-testing touch only the discovered names."""

    def __init__(self, store: EmbeddingStore):
        self._store = store

    def __iter__(self):
        return iter(self._store._paths)

    def __len__(self) -> int:
        return len(self._store._paths)

    def __getitem__(self, name: str) -> int:
        emb = self._store.lookup(name)
        if emb is None:  # an unloadable file is absent
            raise KeyError(name)
        return emb.n_vectors


#: (chunk_row, column, embedding_name, vector_index): where the tokenizer's
#: placeholders landed
Injection = Tuple[int, int, str, int]


def build_injection_arrays(
    injections: List[Injection],
    n_chunks: int,
    width: int,
    store: Optional[EmbeddingStore],
    hidden_l: int,
    hidden_g: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Injections -> ``(mask (n, w, 1), values_l (n, w, Hl), values_g (n,
    w, Hg))`` in f32. An embedding whose width is not the encoder's (an
    SD1.5 embedding under SDXL, say), or one without ``clip_g`` vectors
    under SDXL, is skipped with a log line: its placeholders keep id 0's
    row, as in the JAX package."""
    mask = np.zeros((n_chunks, width, 1), np.float32)
    val_l = np.zeros((n_chunks, width, hidden_l), np.float32)
    val_g = np.zeros((n_chunks, width, max(hidden_g, 1)), np.float32)
    for row, col, name, vec in injections:
        if row >= n_chunks:
            continue  # cut by the chunk cap
        emb = store.lookup(name) if store is not None else None
        if emb is None:
            continue
        if emb.clip_l.shape[1] != hidden_l:
            log.warning("embedding '%s' width %d != encoder width %d; "
                        "skipped", name, emb.clip_l.shape[1], hidden_l)
            continue
        if hidden_g and emb.clip_g is None:
            log.warning("embedding '%s' has no clip_g vectors for this SDXL "
                        "encoder; skipped", name)
            continue
        if hidden_g and emb.clip_g.shape[1] != hidden_g:
            log.warning("embedding '%s' clip_g width %d != encoder width %d; "
                        "skipped", name, emb.clip_g.shape[1], hidden_g)
            continue
        mask[row, col, 0] = 1.0
        val_l[row, col] = emb.clip_l[vec]
        if hidden_g:
            val_g[row, col] = emb.clip_g[vec]
    return mask, val_l, val_g
