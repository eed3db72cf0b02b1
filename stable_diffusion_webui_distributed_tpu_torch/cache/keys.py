"""Cache keys: the one place where payloads and prompts are hashed.

Port of the JAX package's ``cache/keys.py``. Every key is a sha256 hex
digest over canonical (sorted-keys, ``default=str``) JSON, built from the
same objects as there, so the port's digests are the JAX package's hex
strings for the same payload and fingerprint tuple:

- :func:`embed_key`: one encoded conditioning half, keyed by text, clip
  skip, chunk count and the model and text-tower fingerprints;
- :func:`result_key`: a whole result, keyed by the canonical payload
  (``payload.canonical_dump``) without its volatile fields, the job and
  the model fingerprint;
- :func:`prefix_key`: a denoise trajectory's shared prefix, keyed by the
  payload without the fields that only act after the prefix, and the
  engine-side facts that pick the evaluations (cadence, step-cache
  activity, precision, latent batch and size).

The tier rides on ``SDTPU_CACHE`` (default off): with the gate off no
caller reaches this module.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, Tuple

from stable_diffusion_webui_distributed_tpu_torch.models import clip
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    canonical_dump,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    env_flag,
)


def enabled() -> bool:
    """The caching tier's gate (embed, result and prefix)."""
    return env_flag("SDTPU_CACHE", False)


def _digest(obj: Any) -> str:
    """sha256 over sorted-keys JSON; ``default=str`` keeps non-JSON leaves
    stable."""
    data = json.dumps(obj, sort_keys=True, default=str).encode("utf-8")
    return hashlib.sha256(data).hexdigest()


def model_fingerprint(engine: Any) -> Tuple:
    """Identity of the weights a cached artifact was computed under: the
    model and family names, ``_model_epoch`` (bumped by LoRA merges and VAE
    swaps), ``_cond_epoch`` (LoRA merges) and the embedding store's
    generation. Any of them moving retires every entry computed before
    by changing its address."""
    store = getattr(engine, "embedding_store", None)
    return (
        str(getattr(engine, "model_name", "")),
        str(getattr(getattr(engine, "family", None), "name", "")),
        int(getattr(engine, "_model_epoch", 0)),
        int(getattr(engine, "_cond_epoch", 0)),
        int(getattr(store, "generation", 0) if store is not None else 0),
    )


def text_tower_fingerprint(engine: Any) -> Tuple:
    """The text towers' architecture (``models/clip.py``)."""
    family = getattr(engine, "family", None)
    return (
        clip.tower_fingerprint(getattr(family, "text_encoder", None)),
        clip.tower_fingerprint(getattr(family, "text_encoder_2", None)),
    )


def embed_key(text: str, clip_skip: int, chunks: int,
              model_fp: Tuple, tower_fp: Tuple = (),
              lora: str = "") -> str:
    """Address of one encoded conditioning half (positive or negative).
    ``lora``: the content address of the traced text-encoder deltas active
    during the encode (``Engine.traced_te_content``), folded in only when
    not empty."""
    obj = {
        "kind": "embed",
        "text": str(text or ""),
        "clip_skip": int(clip_skip),
        "chunks": int(chunks),
        "model": list(model_fp),
        "tower": list(tower_fp),
    }
    if lora:
        obj["lora"] = str(lora)
    return _digest(obj)


#: payload fields that never reach the pixels, dropped before hashing
_RESULT_VOLATILE = ("request_id",)


def _strip_nonmaterial(dump: Dict[str, Any]) -> Dict[str, Any]:
    """With ``subseed_strength == 0`` the drawn subseed never reaches the
    pixels: it is normalised to -1, so that repeats collide."""
    if not dump.get("subseed_strength"):
        dump["subseed"] = -1
    return dump


def result_key(payload: Any, model_fp: Tuple, job: str,
               lora: str = "") -> str:
    """Address of a whole result, computed after ``fix_seed`` and
    ``apply_scripts``. ``lora``: the traced set's content address when
    ``SDTPU_LORA_TRACED`` serves the payload's adapters ("" otherwise:
    merged adapters move ``_model_epoch``), folded in only when not
    empty."""
    dump = _strip_nonmaterial(canonical_dump(payload))
    for field in _RESULT_VOLATILE:
        dump.pop(field, None)
    obj = {"kind": "result", "job": str(job),
           "model": list(model_fp), "payload": dump}
    if lora:
        obj["lora"] = str(lora)
    return _digest(obj)


#: fields that may differ between requests sharing a denoise prefix: they
#: act only after it (the refiner tail, the hires pass) or are volatile;
#: of ``override_settings`` only ``cfg_cutoff`` may differ
PREFIX_DIVERGENT = frozenset({
    "request_id",
    "refiner_checkpoint", "refiner_switch_at",
    "enable_hr", "hr_scale", "hr_second_pass_steps", "hr_upscaler",
    "hr_resize_x", "hr_resize_y", "denoising_strength",
})


def prefix_key(payload: Any, *, model_fp: Tuple, batch: int, width: int,
               height: int, steps: int, cadence: int, sc_active: bool,
               precision: str, lora: str = "") -> str:
    """Address of a denoise trajectory's shared prefix: the canonical
    payload without :data:`PREFIX_DIVERGENT` and the ``cfg_cutoff``
    override (capture and resume both stop at the cutoff step), with the
    resolved cadence, the step cache's activity (its evaluations are not
    the plain ones), the precision and the latent batch and size. ``lora``
    as for :func:`result_key`."""
    dump = _strip_nonmaterial(canonical_dump(payload))
    for field in PREFIX_DIVERGENT:
        dump.pop(field, None)
    over = dict(dump.get("override_settings") or {})
    over.pop("cfg_cutoff", None)
    dump["override_settings"] = over
    obj = {
        "kind": "prefix",
        "model": list(model_fp),
        "payload": dump,
        "batch": int(batch),
        "latent": [int(width), int(height)],
        "steps": int(steps),
        "cadence": int(cadence),
        "sc_active": bool(sc_active),
        "precision": str(precision),
    }
    if lora:
        obj["lora"] = str(lora)
    return _digest(obj)
