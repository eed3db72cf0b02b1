"""Model registry: the adapter half.

Port of the JAX package's ``pipeline/registry.py`` for LoRA adapters: scan
``<model_dir>/Lora`` and ``<model_dir>/lora`` for ``.safetensors`` files,
load an adapter by name for the engine's ``lora_provider`` through a
byte-capped cache, and rescan on ``POST /sdapi/v1/refresh-loras`` (webui's
route; the reference fans it out to every worker, ``worker.py:577-581``).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

from stable_diffusion_webui_distributed_tpu_torch.cache.store import (
    BoundedStore,
)
from stable_diffusion_webui_distributed_tpu_torch.models.lora import load_lora
from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    env_float,
)

log = logging.getLogger(__name__)

LORA_DIRS = ("Lora", "lora")


def _mtime_or_none(path: str) -> Optional[float]:
    try:
        return os.path.getmtime(path)
    except OSError:
        return None


class ModelRegistry:
    """The adapters under ``model_dir``.

    Only the adapter half of the JAX package's registry is ported: the
    checkpoint, VAE, ControlNet and upscaler halves, ``activate`` and
    ``POST /sdapi/v1/refresh-checkpoints`` come with the checkpoint
    converter (ROADMAP queue 1, item 4)."""

    def __init__(self, model_dir: str = "models") -> None:
        self.model_dir = model_dir
        self._lora_paths: Dict[str, str] = {}
        # byte-capped LRU over loaded adapter state dicts; entries are
        # (file mtime, state dict), and a stale mtime reloads from disk to
        # a new dict, so an adapter edited in place is never served stale
        self._lora_cache = BoundedStore(
            "lora", int(env_float("SDTPU_LORA_CACHE_MB", 256.0) * 1e6))
        #: bumped by every refresh(): engines key their merge latch and
        #: traced-set cache on it, so an identical request after a rescan
        #: retries its unresolved names once
        self.lora_generation = 0
        self.refresh()

    def refresh(self) -> Dict[str, str]:
        """Rescan the adapter directories; returns ``{name: path}``."""
        found: Dict[str, str] = {}
        for sub in LORA_DIRS:
            lora_dir = os.path.join(self.model_dir, sub)
            if os.path.isdir(lora_dir):
                for name in sorted(os.listdir(lora_dir)):
                    if name.lower().endswith(".safetensors"):
                        found[os.path.splitext(name)[0]] = os.path.join(
                            lora_dir, name)
        self._lora_paths = found
        # adapters may have been replaced on disk
        self._lora_cache.clear()
        self.lora_generation += 1
        return dict(found)

    def available_loras(self) -> Dict[str, str]:
        return dict(self._lora_paths)

    def lora_provider(self, name: str):
        """An adapter's state dict by name (the engine's callback for the
        ``<lora:...>`` prompt syntax), or None for an unknown name. A
        cached entry whose file changed on disk since it was loaded
        reloads to a new dict, so an engine's traced set built from the
        old one (``TracedSet.srcs``) is rebuilt."""
        path = self._lora_paths.get(name)
        if path is None:
            return None
        mtime = _mtime_or_none(path)
        hit = self._lora_cache.get(name)
        if hit is not None and hit[0] == mtime:
            return hit[1]
        sd = load_lora(path)
        nbytes = sum(int(v.nbytes) for v in sd.values())
        self._lora_cache.put(name, (mtime, sd), nbytes)
        log.info("lora '%s' loaded from %s", name, path)
        return sd
