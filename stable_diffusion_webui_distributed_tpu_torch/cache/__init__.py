"""The caching tier: embed, result and prefix caches.

Port of the JAX package's ``cache/__init__.py``. Traffic repeats itself:
negative prompts recur in nearly every request, popular prompts recur
verbatim, and variations share prompt, model, size and seed while they
differ only in late-step parameters. Three layers use that, over one key
module (:mod:`.keys`) and one bounded store (:mod:`.store`):

- **embed** (:mod:`.embed`): each distinct text is encoded once per
  process, the positive and negative halves counted apart;
- **result** (this module): a repeat of a payload is answered at the
  dispatcher's admission with the stored images and infotext, never
  dispatched; identical concurrent requests run one generation
  (single-flight);
- **prefix** (:mod:`.prefix`): requests that agree up to step k resume
  from a captured carry.

The result cache's contract in the port: a hit returns the bytes of the
run that filled the entry. The key is the JAX package's (the payload and
the model fingerprint), not the batch the request ran in, so that a hit
does not depend on concurrent traffic; since the port's bytes depend on
the batch (coalesced against solo, ROADMAP section 3), a hit equals a solo
run of its payload within the batch-row agreement, not byte for byte.

The tier rides on ``SDTPU_CACHE`` (default off; with it off no path
changes). Byte caps per layer: ``SDTPU_CACHE_EMBED_MB``,
``SDTPU_CACHE_RESULT_MB`` (default 256), ``SDTPU_CACHE_PREFIX_MB``; the
prefix capture's floor ``SDTPU_CACHE_PREFIX_MIN_STEPS``. ``GET
/internal/cache`` serves :func:`summary`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from stable_diffusion_webui_distributed_tpu_torch.cache import (
    embed as embed_layer,
)
from stable_diffusion_webui_distributed_tpu_torch.cache import keys
from stable_diffusion_webui_distributed_tpu_torch.cache import (
    prefix as prefix_layer,
)
from stable_diffusion_webui_distributed_tpu_torch.cache.store import (
    BoundedStore,
    Flight,
    SingleFlight,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    prometheus as obs_prom,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    env_float,
)

enabled = keys.enabled

_RESULT = BoundedStore("result", 0)
FLIGHTS = SingleFlight()


def result_store() -> BoundedStore:
    """The result store, its byte cap read from the environment."""
    _RESULT.max_bytes = int(env_float("SDTPU_CACHE_RESULT_MB", 256.0) * 1e6)
    return _RESULT


def result_bytes(result: Any) -> int:
    """A stored GenerationResult's size: its base64 PNGs and infotexts."""
    return (sum(len(s) for s in result.images)
            + sum(len(s) for s in result.infotexts))


def result_acquire(key: str) -> Tuple[str, Optional[Any], Optional[Flight]]:
    """One admission-time lookup with single-flight election:

    - ``("hit", result, None)``: a repeat; serve a copy;
    - ``("joined", result, None)``: arrived while an identical request
      ran, woke with its published result;
    - ``("leader", None, flight)``: this request generates, and its caller
      must end the flight with :func:`result_publish` or
      :func:`result_abandon`.

    A follower whose leader abandons elects again."""
    while True:
        cached = result_store().get(key)
        if cached is not None:
            obs_prom.cache_count("result", "hit")
            return "hit", cached, None
        role, flight = FLIGHTS.acquire(key)
        if role == "leader":
            obs_prom.cache_count("result", "miss")
            return "leader", None, flight
        flight.event.wait()
        if flight.value is not None:
            obs_prom.cache_count("result", "joined")
            return "joined", flight.value, None


def result_publish(key: str, flight: Flight, result: Any) -> None:
    """The leader succeeded: store its result and wake its followers."""
    result_store().put(key, result, result_bytes(result))
    FLIGHTS.publish(key, flight, result)


def result_abandon(key: str, flight: Flight) -> None:
    """The leader failed: wake its followers empty-handed."""
    FLIGHTS.abandon(key, flight)


def summary() -> Dict[str, Any]:
    """The ``/internal/cache`` body: each layer's counts and the gate."""
    result = result_store().stats()
    result["single_flight"] = FLIGHTS.stats()
    return {
        "enabled": enabled(),
        "embed": embed_layer.summary(),
        "result": result,
        "prefix": prefix_layer.summary(),
    }


def clear_all() -> None:
    """Empty every layer and reset its counts."""
    embed_layer.clear()
    prefix_layer.clear()
    _RESULT.clear()
    FLIGHTS.clear()
