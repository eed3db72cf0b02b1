"""Denoise prefix sharing.

Port of the JAX package's ``cache/prefix.py``. Two requests that agree up
to step k (the same prompt, seed, shape, cadence and precision, differing
only in what acts after k: another CFG cutoff, refiner switch or hires
tail, or a field plain txt2img ignores) share the trajectory ``[0, k)``.
The engine's chunk loop captures the sampler's whole carry at a chunk
boundary, and a later request with the same :func:`~.keys.prefix_key`
resumes from it.

The resumed request must give the continuous run's bytes, which sets the
rules:

- the whole carry is captured (the latent and the multistep history), so
  LMS, PLMS and DPM++ 2M resume with the history a continuous run holds;
- a capture is taken only at a boundary where the step cache refreshes
  anyway (``pipeline/stepcache.prefix_boundary``): a resumed range starts
  with an invalid cache and refreshes there, as the continuous run does;
- capture and resume both stop at the CFG cutoff step, so the shared
  prefix ran full CFG under both requests;
- the key holds the cadence, the precision and whether the step cache ran,
  so a resumed range replays the evaluations (and, on the card, the CUDA
  graphs) the capturing range ran.

The capture copies the carry to the host: the device tensors belong to the
running loop. Byte cap ``SDTPU_CACHE_PREFIX_MB`` (default 128); the
shallowest capture ``SDTPU_CACHE_PREFIX_MIN_STEPS`` (default 4).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from stable_diffusion_webui_distributed_tpu_torch.cache import (
    keys as cache_keys,
)
from stable_diffusion_webui_distributed_tpu_torch.cache.store import (
    BoundedStore,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    prometheus as obs_prom,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline import stepcache
from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    env_float,
    env_int,
)

_STORE = BoundedStore("prefix", 0)

_lock = threading.Lock()
_resumed = 0  # guarded-by: _lock
_captured = 0  # guarded-by: _lock

_tls = threading.local()  # this thread's resume note


def min_steps() -> int:
    """The shallowest capture: a shorter prefix saves too little to pay
    for its copy to the host."""
    return max(1, env_int("SDTPU_CACHE_PREFIX_MIN_STEPS", 4))


def store() -> BoundedStore:
    _STORE.max_bytes = int(env_float("SDTPU_CACHE_PREFIX_MB", 128.0) * 1e6)
    return _STORE


class PrefixPlan:
    """One denoise range's prefix state: its key, the resume point found
    at entry (if any) and whether the range has captured (once at
    most)."""

    __slots__ = ("key", "cadence", "sc_active", "cfg_stop", "end",
                 "resume", "captured")

    def __init__(self, key: str, cadence: int, sc_active: bool,
                 cfg_stop: int, end: int) -> None:
        self.key = key
        self.cadence = cadence
        self.sc_active = sc_active
        self.cfg_stop = cfg_stop
        self.end = end
        self.resume: Optional[Tuple[int, Tuple]] = None  # (step, leaves)
        self.captured = False


def plan(engine: Any, payload: Any, *, batch: int, width: int, height: int,
         steps: int, end: int, cadence: int, sc_active: bool,
         precision: str, cfg_stop: int,
         lora: str = "") -> Optional[PrefixPlan]:
    """The range's plan, with a resume point when a usable prefix is
    stored; None when the range is not shareable: a request of several
    groups (the latent batch is not the whole request, so a group index
    would have to enter the key). ``lora``: the traced set's content
    address ("" on the merged path, which ``_model_epoch`` pins)."""
    if int(batch) != int(payload.batch_size) * int(payload.n_iter):
        return None
    key = cache_keys.prefix_key(
        payload, model_fp=cache_keys.model_fingerprint(engine),
        batch=batch, width=width, height=height, steps=steps,
        cadence=cadence, sc_active=sc_active, precision=precision,
        lora=lora)
    p = PrefixPlan(key, int(cadence), bool(sc_active), int(cfg_stop),
                   int(end))
    ent = store().get(key)
    if ent is not None:
        k = int(ent["step"])
        # usable only if it skips work and the shared prefix ran full CFG
        # under this request's cutoff too
        if 0 < k < p.end and k <= p.cfg_stop:
            p.resume = (k, ent["leaves"])
            obs_prom.cache_count("prefix", "resumed")
            global _resumed
            with _lock:
                _resumed += 1
            _tls.note = {"step": k, "key": key[:16]}
    return p


def maybe_capture(p: PrefixPlan, pos: int, carry: Tuple) -> None:
    """Capture ``carry`` (a ``kd.Carry``) at chunk boundary ``pos`` if it
    is the range's split point (``stepcache.prefix_boundary``). A deeper
    stored capture is never replaced by a shallower one. The leaves are
    host copies, as the JAX package holds them: the tensors as numpy
    arrays, ``have_old`` as a bool and ``n_hist`` as an int32 array."""
    if p.captured or pos >= p.end:
        return
    if not stepcache.prefix_boundary(pos, p.cadence, p.cfg_stop,
                                     min_steps()):
        return
    p.captured = True
    prev = store().peek(p.key)
    if prev is not None and int(prev["step"]) >= pos:
        return
    leaves = tuple(
        leaf.detach().to("cpu", copy=True).numpy()
        if isinstance(leaf, torch.Tensor) else
        np.asarray(leaf, np.bool_ if isinstance(leaf, bool) else np.int32)
        for leaf in carry)
    nbytes = sum(int(a.nbytes) for a in leaves)
    if store().put(p.key, {"step": int(pos), "leaves": leaves}, nbytes):
        obs_prom.cache_count("prefix", "captured")
        global _captured
        with _lock:
            _captured += 1


def take_resume_note() -> Optional[Dict[str, Any]]:
    """This thread's last resume (``{"step", "key"}``), once: what the
    JAX dispatcher's ``prefix_resumed`` journal event reads."""
    note = getattr(_tls, "note", None)
    _tls.note = None
    return note


def summary() -> Dict[str, Any]:
    st = store().stats()
    with _lock:
        st["resumed"] = _resumed
        st["captured"] = _captured
    return st


def clear() -> None:
    global _resumed, _captured
    _STORE.clear()
    with _lock:
        _resumed = 0
        _captured = 0
