"""Content-addressed text conditioning (the embed layer).

Port of the JAX package's ``cache/embed.py``. Each distinct (text, clip
skip, chunk count, model and text-tower fingerprint) goes through the text
encoders once per process instead of once per request. The positive and
the negative halves are separate entries with separate hit counts, since
traffic repeats its negative prompts most.

``Engine.encode_prompts`` calls :func:`lookup_or_encode` when
``SDTPU_CACHE=1``; this process-wide, byte-capped store
(``SDTPU_CACHE_EMBED_MB``, default 64) then replaces the engine's own
conditioning cache. A hit returns the very tensors the first encode made:
the engine never writes into them, and the text encoders run outside the
CUDA graphs, so no entry lies in a graph's memory pool.

Each thread keeps its request's hit counts (:func:`take_request_hits`);
the serving dispatcher drains them on the engine's device thread into the
journal's ``embed_cache_hit`` event (``obs/journal.py``).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Tuple

from stable_diffusion_webui_distributed_tpu_torch.cache import (
    keys as cache_keys,
)
from stable_diffusion_webui_distributed_tpu_torch.cache.store import (
    BoundedStore,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    prometheus as obs_prom,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    env_float,
)

_STORE = BoundedStore("embed", 0)

_lock = threading.Lock()
_POS = {"hits": 0, "misses": 0}  # guarded-by: _lock
_NEG = {"hits": 0, "misses": 0}  # guarded-by: _lock

_tls = threading.local()  # per-thread (positive hits, negative hits)


def store() -> BoundedStore:
    """The embed store, its byte cap read from the environment."""
    _STORE.max_bytes = int(env_float("SDTPU_CACHE_EMBED_MB", 64.0) * 1e6)
    return _STORE


def _note_hit(negative: bool) -> None:
    pos, neg = getattr(_tls, "note", (0, 0))
    _tls.note = (pos + (0 if negative else 1), neg + (1 if negative else 0))


def take_request_hits() -> Tuple[int, int]:
    """This thread's (positive, negative) hits since the last call."""
    note = getattr(_tls, "note", (0, 0))
    _tls.note = (0, 0)
    return note


def lookup_or_encode(engine: Any, text: str, clip_skip: int, chunks: int,
                     negative: bool, encode: Callable[[], Any]) -> Any:
    """The cached ``(context, pooled)`` of ``text`` on a hit, else
    ``encode()``'s, stored. ``chunks`` is the chunk count the entry is
    encoded at: the request's on the classic path, the prompt's own under
    ragged dispatch (whose rows are padded after the encode), so one entry
    serves a prompt in any group; the two agree where the counts do."""
    key = cache_keys.embed_key(
        text, clip_skip, chunks, cache_keys.model_fingerprint(engine),
        cache_keys.text_tower_fingerprint(engine),
        lora=engine.traced_te_content())
    s = store()
    hit = s.get(key)
    half = _NEG if negative else _POS
    layer = "embed_neg" if negative else "embed_pos"
    if hit is not None:
        with _lock:
            half["hits"] += 1
        _note_hit(negative)
        obs_prom.cache_count(layer, "hit")
        return hit
    with _lock:
        half["misses"] += 1
    obs_prom.cache_count(layer, "miss")
    out = encode()
    s.put(key, out, sum(int(t.nbytes) for t in out))
    return out


def summary() -> Dict[str, Any]:
    st = store().stats()
    with _lock:
        for label, half in (("positive", _POS), ("negative", _NEG)):
            total = half["hits"] + half["misses"]
            st[label] = {
                "hits": half["hits"],
                "misses": half["misses"],
                "hit_rate": (half["hits"] / total) if total else 0.0,
            }
    return st


def clear() -> None:
    _STORE.clear()
    with _lock:
        for half in (_POS, _NEG):
            half["hits"] = half["misses"] = 0
