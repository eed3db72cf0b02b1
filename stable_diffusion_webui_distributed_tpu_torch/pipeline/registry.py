"""Model registry: the adapter and upscaler halves.

Port of the JAX package's ``pipeline/registry.py`` for LoRA adapters: scan
``<model_dir>/Lora`` and ``<model_dir>/lora`` for ``.safetensors`` files,
load an adapter by name for the engine's ``lora_provider`` through a
byte-capped cache, and rescan on ``POST /sdapi/v1/refresh-loras`` (webui's
route; the reference fans it out to every worker, ``worker.py:577-581``).

And for the hires fix's image-space upscalers: scan ``ESRGAN/``,
``RealESRGAN/`` and ``upscalers/`` for ``.safetensors`` and ``.pth``
RRDBNet files, resolve webui's display names to them (case and
punctuation ignored, an exact canonical match first) and hand the engine's
``upscaler_provider`` an upscale callable per name, cached. A file that
fails to load is logged and gives None, so the engine falls back to the
latent path, as in the JAX package.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Dict, Optional, Union

import torch

from stable_diffusion_webui_distributed_tpu_torch.cache.store import (
    BoundedStore,
)
from stable_diffusion_webui_distributed_tpu_torch.models import esrgan
from stable_diffusion_webui_distributed_tpu_torch.models.lora import load_lora
from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    env_float,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.dtypes import (
    resolve_device,
)

log = logging.getLogger(__name__)

LORA_DIRS = ("Lora", "lora")
UPSCALER_DIRS = ("ESRGAN", "RealESRGAN", "upscalers")


def _mtime_or_none(path: str) -> Optional[float]:
    try:
        return os.path.getmtime(path)
    except OSError:
        return None


class ModelRegistry:
    """The adapters and upscalers under ``model_dir``.

    The adapter and upscaler halves of the JAX package's registry are
    ported: the checkpoint, VAE and ControlNet halves, ``activate`` and
    ``POST /sdapi/v1/refresh-checkpoints`` come with the checkpoint
    converter (ROADMAP queue 1, item 4). Upscalers load to ``device``
    (``cuda`` unless named; with none named and no GPU,
    :meth:`upscaler_provider` raises)."""

    def __init__(self, model_dir: str = "models",
                 device: Optional[Union[str, torch.device]] = None) -> None:
        self.model_dir = model_dir
        self.device = device
        self._lora_paths: Dict[str, str] = {}
        self._upscaler_paths: Dict[str, str] = {}
        self._upscaler_cache: Dict[str, Optional[Callable]] = {}
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

    def _scan(self, subdirs, suffixes) -> Dict[str, str]:
        """``{file stem: path}`` of the files with ``suffixes`` in the
        ``subdirs`` of the model directory, a later directory winning."""
        found: Dict[str, str] = {}
        for sub in subdirs:
            path = os.path.join(self.model_dir, sub)
            if os.path.isdir(path):
                for name in sorted(os.listdir(path)):
                    if name.lower().endswith(suffixes):
                        found[os.path.splitext(name)[0]] = os.path.join(
                            path, name)
        return found

    def refresh(self) -> Dict[str, str]:
        """Rescan the adapter and upscaler directories; returns the
        adapters' ``{name: path}``."""
        self._lora_paths = self._scan(LORA_DIRS, (".safetensors",))
        self._upscaler_paths = self._scan(UPSCALER_DIRS,
                                          (".safetensors", ".pth"))
        # files may have been replaced on disk
        self._lora_cache.clear()
        self._upscaler_cache.clear()
        self.lora_generation += 1
        return dict(self._lora_paths)

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

    def available_upscalers(self) -> Dict[str, str]:
        return dict(self._upscaler_paths)

    def _resolve_upscaler_path(self, name: str) -> Optional[str]:
        """``hr_upscaler`` display name -> file path, or None. Matching
        ignores case and punctuation, so webui's display names ("R-ESRGAN
        4x+") find their files ("RealESRGAN_x4plus.pth"); an exact
        canonical match wins over containment, so "..._x4plus" never
        shadows "..._x4plus_anime_6B", and among containments the longest
        stem wins."""

        def canon(s: str) -> str:
            s = s.lower().replace("+", "plus")
            s = "".join(c for c in s if c.isalnum())
            if s.startswith("resrgan"):
                s = "realesrgan" + s[len("resrgan"):]
            return s.replace("4x", "x4").replace("2x", "x2")

        path = self._upscaler_paths.get(name)
        if path is not None:
            return path
        want = canon(name)
        best = None  # (canonical stem length, path)
        for stem, p in self._upscaler_paths.items():
            cs = canon(stem)
            if cs == want:
                return p
            if want in cs or cs in want:
                if best is None or len(cs) > best[0]:
                    best = (len(cs), p)
        return best[1] if best else None

    def upscaler_provider(self, name: str) -> Optional[Callable]:
        """``hr_upscaler`` name -> ``upscale(imgs, target_w, target_h)``
        (``models/esrgan.py`` ``make_upscaler``) on the registry's device,
        or None: no name, no file, or a file that failed to load (logged;
        the engine then falls back to latent bilinear). Cached per name
        until the next :meth:`refresh`."""
        if not name:
            return None
        if name in self._upscaler_cache:
            return self._upscaler_cache[name]
        path = self._resolve_upscaler_path(name)
        if path is None:
            return None
        # outside the guard below: no GPU, with none named, raises
        device = resolve_device(self.device)
        try:
            fn = esrgan.make_upscaler(esrgan.load_esrgan(path, device))
        except Exception as e:  # noqa: BLE001 -- a bad file must not 500
            log.error("upscaler '%s' failed to load from %s: %s", name,
                      path, e)
            fn = None
        self._upscaler_cache[name] = fn
        return fn
