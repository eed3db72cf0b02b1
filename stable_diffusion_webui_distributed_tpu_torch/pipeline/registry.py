"""Model registry: checkpoint discovery and the engine's lifecycle.

Port of the JAX package's ``pipeline/registry.py``. webui scans a model
directory and switches models through ``POST /sdapi/v1/options``; the
reference syncs that choice across every worker. This is the node's half:
discover the checkpoints of ``model_dir`` (``.safetensors``, ``.ckpt``,
``.pt`` at its top), convert one to the port's state dicts on activation
(``models/convert.py``; the family from a ``<file>.json`` sidecar
``{"family": ...}``, else from the keys) and keep one active
:class:`~.engine.Engine`, dropping the previous one before the next is
built, plus at most one secondary engine (a refiner named in a request).
Converted state dicts are cached under ``<model_dir>/.sdtpu-cache/<name>/``
in the checkpoint's own dtype (``params.pt``, read back mapped), with the
JAX package's ``meta.json`` (family, the source's and the sidecar's mtimes):
a touched source or sidecar, or a cache that cannot be read, converts
again.

The same directory holds what requests name: standalone VAEs in ``VAE/``
(``set_vae``: bare ``encoder.``/``decoder.`` keys or ``first_stage_model.``
ones), ControlNets in ``ControlNet/`` (``controlnet_provider``, converted
per name and family), LoRA adapters in ``Lora/`` (``lora_provider``, a
byte-capped cache; ``POST /sdapi/v1/refresh-loras`` rescans), and the
hires fix's RRDBNet upscalers in ``ESRGAN/``, ``RealESRGAN/`` or
``upscalers/`` (``upscaler_provider``: webui's display names resolved with
case and punctuation ignored, an exact canonical match first; a file that
fails to load is logged and gives None, so the engine falls back to the
latent path, as in the JAX package). Each scan takes the lower-case
directory name too. Textual-inversion embeddings come from
``<model_dir>/embeddings``, else ``embeddings/`` beside the model
directory (webui's layout), through one ``EmbeddingStore`` that every
engine the registry builds holds and that :meth:`ModelRegistry.refresh`
rescans in place.

``mesh`` (a ``runtime/mesh.py`` :class:`~..runtime.mesh.Mesh`; JAX
``pipeline/registry.py:38, 460``): every engine the registry builds, the
active one and a secondary (a refiner), is placed over it, on its home
device.
"""

from __future__ import annotations

import gc
import json
import logging
import os
import threading
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from stable_diffusion_webui_distributed_tpu_torch.cache.store import (
    BoundedStore,
)
from stable_diffusion_webui_distributed_tpu_torch.models import convert
from stable_diffusion_webui_distributed_tpu_torch.models import esrgan
from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
    FAMILIES,
    ModelFamily,
)
from stable_diffusion_webui_distributed_tpu_torch.models.controlnet import (
    convert_controlnet,
)
from stable_diffusion_webui_distributed_tpu_torch.models.embeddings import (
    EmbeddingStore,
)
from stable_diffusion_webui_distributed_tpu_torch.models.lora import load_lora
from stable_diffusion_webui_distributed_tpu_torch.models.safetensors_io import (
    SafetensorsFile,
)
from stable_diffusion_webui_distributed_tpu_torch.models.tokenizer import (
    load_tokenizer,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import dtypes
from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    env_float,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.dtypes import (
    resolve_device,
)

log = logging.getLogger(__name__)

CHECKPOINT_EXTENSIONS = (".safetensors", ".ckpt", ".pt")
LORA_DIRS = ("Lora", "lora")
VAE_DIRS = ("VAE", "vae")
CONTROLNET_DIRS = ("ControlNet", "controlnet")
UPSCALER_DIRS = ("ESRGAN", "RealESRGAN", "upscalers")
#: the converted-params cache's directory under the model directory
CACHE_DIR = ".sdtpu-cache"
#: names that restore a checkpoint's own VAE
AUTOMATIC_VAES = ("", "Automatic", "None")


def _mtime_or_none(path: str) -> Optional[float]:
    try:
        return os.path.getmtime(path)
    except OSError:
        return None


class ModelRegistry:
    """The checkpoints, VAEs, ControlNets, adapters and upscalers under
    ``model_dir``, and the engine of the active checkpoint.

    Engines and upscalers load to ``device`` (``cuda`` unless named; with
    none named and no GPU, building either raises), engines with the card
    policy on ``cuda`` and f32 elsewhere, sharing the generation ``state``
    (the process's unless named), each placed over ``mesh`` when one is
    given (its home device is then the engines' device)."""

    def __init__(self, model_dir: str = "models",
                 device: Optional[Union[str, torch.device]] = None,
                 state=None, mesh=None) -> None:
        self.model_dir = model_dir
        self.mesh = mesh
        self.device = device if mesh is None or device is not None \
            else mesh.home()
        self.state = state
        self._paths: Dict[str, str] = {}
        self._lora_paths: Dict[str, str] = {}
        self._vae_paths: Dict[str, str] = {}
        self._controlnet_paths: Dict[str, str] = {}
        self._upscaler_paths: Dict[str, str] = {}
        self._upscaler_cache: Dict[str, Optional[Callable]] = {}
        # converted VAEs and ControlNets per (name, family)
        self._vae_cache: Dict[Tuple[str, str], Dict] = {}
        self._controlnet_cache: Dict[Tuple[str, str], Dict] = {}
        # byte-capped LRU over loaded adapter state dicts; entries are
        # (file mtime, state dict), and a stale mtime reloads from disk to
        # a new dict, so an adapter edited in place is never served stale
        self._lora_cache = BoundedStore(
            "lora", int(env_float("SDTPU_LORA_CACHE_MB", 256.0) * 1e6))
        #: bumped by every refresh(): engines key their merge latch and
        #: traced-set cache on it, so an identical request after a rescan
        #: retries its unresolved names once
        self.lora_generation = 0
        self._engine = None
        self._secondary: Dict[str, object] = {}
        self._active_vae: Optional[str] = None
        #: the active checkpoint's name ("" before the first activation)
        self.current_name = ""
        self._lock = threading.Lock()
        #: the textual-inversion embeddings, one store for the registry's
        #: lifetime (engines hold it; refresh() rescans it in place)
        self.embedding_store: Optional[EmbeddingStore] = None
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
        """Rescan the model directory (webui's ``/refresh-checkpoints`` and
        ``/refresh-loras``, which the reference fans out to every worker)
        and its embeddings, and drop the converted caches, whose files may
        have been replaced on disk. Returns the checkpoints' ``{name:
        path}``."""
        self._paths = self._scan(("",), CHECKPOINT_EXTENSIONS)
        self._lora_paths = self._scan(LORA_DIRS, (".safetensors",))
        self._vae_paths = self._scan(VAE_DIRS, (".safetensors",))
        self._controlnet_paths = self._scan(CONTROLNET_DIRS,
                                            (".safetensors",))
        self._upscaler_paths = self._scan(UPSCALER_DIRS,
                                          (".safetensors", ".pth"))
        self._lora_cache.clear()
        self._vae_cache.clear()
        self._controlnet_cache.clear()
        self._upscaler_cache.clear()
        self.lora_generation += 1
        emb_dir = None
        for cand in (os.path.join(self.model_dir, "embeddings"),
                     os.path.join(os.path.dirname(
                         self.model_dir.rstrip(os.sep)) or ".",
                         "embeddings")):
            if os.path.isdir(cand):
                emb_dir = cand
                break
        if self.embedding_store is None:
            self.embedding_store = EmbeddingStore(emb_dir)
        else:
            self.embedding_store.rescan(emb_dir)
        return dict(self._paths)

    def available(self) -> Dict[str, str]:
        """The checkpoints' ``{name: path}``."""
        return dict(self._paths)

    def model_names(self) -> List[str]:
        """The models this registry serves: the active engine's name first
        when no file has it (an engine installed by
        :meth:`register_engine`), then the checkpoints."""
        names = list(self._paths)
        if self.current_name and self.checkpoint_path(
                self.current_name) is None:
            names.insert(0, self.current_name)
        return names

    def available_vaes(self) -> Dict[str, str]:
        return dict(self._vae_paths)

    def available_controlnets(self) -> Dict[str, str]:
        return dict(self._controlnet_paths)

    @staticmethod
    def _lookup(paths: Dict[str, str], name: str) -> Optional[str]:
        """A file by its stem, or by its file name as webui sends it."""
        return paths.get(name) or paths.get(os.path.splitext(name)[0])

    def checkpoint_path(self, name: str) -> Optional[str]:
        return self._lookup(self._paths, name)

    def vae_path(self, name: str) -> Optional[str]:
        return self._lookup(self._vae_paths, name)

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

    # -- checkpoints ---------------------------------------------------------

    @property
    def engine(self):
        """The active engine (None before the first activation)."""
        return self._engine

    def register_engine(self, name: str, engine) -> None:
        """Install a built engine as the active one (programmatic use: the
        CLI's seeded engine, tests)."""
        with self._lock:
            self._engine = engine
            self.current_name = name
            self._active_vae = None

    @staticmethod
    def _family_for(path: str, sd) -> str:
        """A checkpoint's family: a ``<file>.json`` sidecar's ``family``
        wins; otherwise the keys decide (``convert.detect_family``)."""
        try:
            with open(path + ".json", encoding="utf-8") as f:
                family = json.load(f).get("family")
            if family:
                return family
        except (OSError, ValueError, AttributeError):
            pass
        return convert.detect_family(sd)

    def _cache_dir(self, name: str) -> str:
        return os.path.abspath(os.path.join(self.model_dir, CACHE_DIR, name))

    def _load_param_cache(self, name: str, src_path: str
                          ) -> Optional[Tuple[ModelFamily, Dict]]:
        """``(family, state dicts)`` from the converted-params cache, read
        mapped, or None when it is absent, stale (the source or its
        sidecar touched since) or unreadable."""
        cache_dir = self._cache_dir(name)
        meta_path = os.path.join(cache_dir, "meta.json")
        try:
            with open(meta_path, encoding="utf-8") as f:
                meta = json.load(f)
            if meta.get("src_mtime") != os.path.getmtime(src_path):
                return None
            # editing the sidecar must convert again under its family
            if meta.get("sidecar_mtime") != _mtime_or_none(
                    src_path + ".json"):
                return None
            family = FAMILIES[meta["family"]]
            params = torch.load(os.path.join(cache_dir, "params.pt"),
                                map_location="cpu", mmap=True,
                                weights_only=True)
            want = {"text_encoder", "unet", "vae", "vae_encoder"}
            if family.text_encoder_2 is not None:
                want.add("text_encoder_2")
            if set(params) != want:
                raise ValueError(f"components {sorted(params)}")
            return family, params
        except Exception as e:  # noqa: BLE001 -- any cache fault converts
            if os.path.exists(meta_path):
                log.warning("param cache of '%s' unusable (%s); converting "
                            "again", name, e)
            return None

    def _save_param_cache(self, name: str, src_path: str,
                          family: ModelFamily, params: Dict) -> None:
        """Write the converted state dicts (best effort: a failure is
        logged). ``meta.json`` goes last, so a cache cut short is never
        read as valid."""
        cache_dir = self._cache_dir(name)
        meta_path = os.path.join(cache_dir, "meta.json")
        try:
            os.makedirs(cache_dir, exist_ok=True)
            if os.path.exists(meta_path):
                os.remove(meta_path)
            tmp = os.path.join(cache_dir, "params.pt.tmp")
            torch.save(params, tmp)
            os.replace(tmp, os.path.join(cache_dir, "params.pt"))
            with open(meta_path, "w", encoding="utf-8") as f:
                json.dump({"family": family.name,
                           "src_mtime": os.path.getmtime(src_path),
                           "sidecar_mtime": _mtime_or_none(
                               src_path + ".json")}, f)
        except Exception as e:  # noqa: BLE001 -- the cache is best effort
            log.warning("param cache of '%s' not written: %s", name, e)

    def _build_engine(self, name: str):
        """Read, convert (or restore from the cache) and build the engine
        of checkpoint ``name``; changes no registry state. Raises
        ``KeyError`` for an unknown name."""
        from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine \
            import Engine

        path = self.checkpoint_path(name)
        if path is None:
            raise KeyError(f"unknown model '{name}' (have: "
                           f"{list(self._paths)})")
        # before any reading: no GPU, with none named, raises
        device = resolve_device(self.device)
        policy = dtypes.CARD if device.type == "cuda" else dtypes.F32
        cached = self._load_param_cache(name, path)
        if cached is not None:
            family, params = cached
            log.info("checkpoint '%s' restored from the cache", name)
        else:
            log.info("loading checkpoint '%s' from %s", name, path)
            sd = convert.read_state_dict(path)
            family = FAMILIES[self._family_for(path, sd)]
            params = convert.convert_ldm(sd, family)
            del sd
            self._save_param_cache(name, path, family, params)
        return Engine(
            family, params,
            tokenizer=load_tokenizer(self.model_dir,
                                     family.text_encoder.vocab_size),
            policy=policy, model_name=name, state=self.state, device=device,
            engine_provider=self.secondary_engine,
            controlnet_provider=self.controlnet_provider,
            lora_provider=self.lora_provider,
            upscaler_provider=self.upscaler_provider,
            embedding_store=self.embedding_store, mesh=self.mesh)

    def activate(self, name: str):
        """Make checkpoint ``name`` the active engine and return it. The
        previous engine is dropped before the next is built (a card rarely
        holds two SDXLs); a secondary engine of that name is promoted
        instead of built again. Raises ``KeyError`` for an unknown name."""
        with self._lock:
            if name == self.current_name and self._engine is not None:
                return self._engine
            promoted = self._secondary.pop(name, None)
            if promoted is None and self.checkpoint_path(name) is None:
                raise KeyError(f"unknown model '{name}' (have: "
                               f"{list(self._paths)})")
            self._engine = None
            gc.collect()
            self._engine = promoted or self._build_engine(name)
            self.current_name = name
            self._active_vae = None  # a new engine has its own VAE
            log.info("checkpoint '%s' active (%s)", name,
                     self._engine.family.name)
            return self._engine

    def secondary_engine(self, name: str):
        """An engine loaded beside the active one (a refiner named in a
        request; the engine's ``engine_provider``): the active engine for
        its own name, else one secondary at a time, a request for another
        dropping it. None for an unknown name."""
        with self._lock:
            if name == self.current_name and self._engine is not None:
                return self._engine
            cached = self._secondary.get(name)
            if cached is not None:
                return cached
            if self.checkpoint_path(name) is None:
                log.warning("refiner checkpoint '%s' not found", name)
                return None
            self._secondary.clear()
            gc.collect()
            engine = self._build_engine(name)
            self._secondary[name] = engine
            return engine

    # -- VAEs and ControlNets ------------------------------------------------

    def set_vae(self, name: str) -> bool:
        """Apply standalone VAE ``name`` to the active engine; ``""``,
        "Automatic" and "None" restore the checkpoint's own. A repeat of
        the active choice does nothing. False when there is no active
        engine or no such file."""
        if self._engine is None:
            return False
        if name in AUTOMATIC_VAES:
            if self._active_vae is not None:
                self._engine.set_vae(None)
                self._active_vae = None
            return True
        if name == self._active_vae:
            return True
        family = self._engine.family
        params = self._vae_cache.get((name, family.name))
        if params is None:
            path = self.vae_path(name)
            if path is None:
                log.warning("vae '%s' not found", name)
                return False
            sd = SafetensorsFile(path)
            if not any(k.startswith("first_stage_model.") for k in sd):
                sd = {f"first_stage_model.{k}": sd[k] for k in sd}
            vae = convert.convert_vae(sd, family.vae)
            params = {"vae": vae["decoder"], "vae_encoder": vae["encoder"]}
            self._vae_cache[(name, family.name)] = params
        self._engine.set_vae(params)
        self._active_vae = name
        log.info("vae '%s' applied", name)
        return True

    def controlnet_provider(self, name: str):
        """A ControlNet's state dict by name (the engine's callback for a
        unit's model), converted for the active family's UNet (SD1.5's
        with no engine yet) and cached per (name, family) until the next
        :meth:`refresh`; None for an unknown name. A file may have
        ``control_model.`` keys or bare ones."""
        family = (self._engine.family if self._engine is not None
                  else FAMILIES["sd15"])
        key = (name, family.name)
        if key in self._controlnet_cache:
            return self._controlnet_cache[key]
        path = self._lookup(self._controlnet_paths, name)
        if path is None:
            return None
        sd = SafetensorsFile(path)
        if not any(k.startswith("control_model.") for k in sd):
            sd = {f"control_model.{k}": sd[k] for k in sd}
        params = convert_controlnet(sd, family.unet)
        self._controlnet_cache[key] = params
        log.info("controlnet '%s' loaded (%s)", name, family.name)
        return params
