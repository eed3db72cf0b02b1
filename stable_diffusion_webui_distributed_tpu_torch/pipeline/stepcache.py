"""Step cache: DeepCache-style deep-feature reuse and CFG truncation.

A copy of the host-side policy of the JAX package's
``pipeline/stepcache.py`` (the port imports nothing from that package).
Two per-request levers cut a request's UNet work:

- **Deep-feature reuse** (``SDTPU_DEEPCACHE`` or ``override_settings.
  deepcache``, a refresh cadence N): the UNet's deep part (the levels
  from ``models/unet.py`` ``CACHE_SPLIT`` down and the mid block) runs on
  refresh steps only; in between, only the shallow levels run, from the
  cached deep feature.
- **CFG truncation** (``SDTPU_CFG_CUTOFF`` or ``override_settings.
  cfg_cutoff``, a sigma): from the first step whose sigma lies below it,
  the unconditional half of the guided evaluation is dropped.

Requested cadences round down onto :data:`CADENCE_LADDER`. In the port the
cadence and the cutoff are host data of the engine's step loop
(``pipeline/engine.py``): a new value on a warm bucket captures no CUDA
graph. :func:`plan_schedule` replays the loop's decisions on the host; the
engine's own evaluation counts are held against it.

:class:`FlopsAccountant` prices a range's UNet work: one evaluation per
(rows, latent size, context length, cache mode, precision) counted by
``torch.utils.flop_counter.FlopCounterMode`` on a copy of the UNet built
on meta tensors (nothing is allocated or computed; the attention kernels
answer a meta tensor with their plain version's products), summed over
the evaluations :func:`plan_schedule` says the range dispatched. It counts
matrix products and convolutions, as 2 x multiply-adds. The JAX package
priced the same evaluations with XLA's cost analysis.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    env_float,
    env_int,
)

#: The refresh cadences a request can get. Requests and the environment
#: round down onto it (never a staler feature than asked for); values
#: above the top rung clamp to it. 1 = cache off.
CADENCE_LADDER = (1, 2, 3, 4, 6, 8)


def bucket_cadence(cadence) -> int:
    """A requested refresh cadence on :data:`CADENCE_LADDER`; anything
    that is not an integer gives 1."""
    try:
        c = int(cadence)
    except (TypeError, ValueError):
        return 1
    c = max(1, c)
    best = 1
    for rung in CADENCE_LADDER:
        if rung <= c:
            best = rung
    return best


@dataclasses.dataclass(frozen=True)
class StepCacheSpec:
    """One request's resolved step-cache policy."""

    cadence: int = 1          # bucketed refresh cadence; 1 = cache off
    cutoff_sigma: float = 0.0  # CFG truncation threshold; 0 = off

    @property
    def active(self) -> bool:
        return self.cadence > 1 or self.cutoff_sigma > 0.0


def resolve(payload=None) -> StepCacheSpec:
    """The environment's defaults (``SDTPU_DEEPCACHE``,
    ``SDTPU_CFG_CUTOFF``) with the request's ``override_settings`` keys
    ``deepcache`` and ``cfg_cutoff`` on top."""
    cad = env_int("SDTPU_DEEPCACHE", 1)
    cut = env_float("SDTPU_CFG_CUTOFF", 0.0)
    ov = getattr(payload, "override_settings", None) or {}
    if "deepcache" in ov:
        cad = ov.get("deepcache")
    if "cfg_cutoff" in ov:
        try:
            cut = float(ov.get("cfg_cutoff"))
        except (TypeError, ValueError):
            pass
    return StepCacheSpec(cadence=bucket_cadence(cad),
                         cutoff_sigma=max(0.0, float(cut or 0.0)))


def cutoff_step(sigmas: Sequence[float], cutoff_sigma: float) -> int:
    """The first step of the descending sigma ladder whose sigma lies
    below the threshold: steps from it on run cond-only. Off (<= 0) or
    never reached: ``len(sigmas) - 1``, one past the last step."""
    n = len(sigmas) - 1
    if cutoff_sigma <= 0.0:
        return n
    asc = np.asarray(sigmas, dtype=np.float64)[::-1].copy()
    j = int(np.searchsorted(asc, cutoff_sigma, side="left"))
    return min(max(n - j + 1, 0), n)


def prefix_boundary(pos: int, cadence: int, cfg_stop: int,
                    min_steps: int) -> bool:
    """May a denoise prefix end at step ``pos`` and another range resume
    from it with the same bytes? Not below ``min_steps``; only where the
    cadence refreshes (a resumed range starts with an invalid cache, so it
    refreshes at ``pos``); not past the CFG cutoff."""
    if pos < max(1, int(min_steps)):
        return False
    if int(cadence) > 1 and pos % int(cadence) != 0:
        return False
    return pos <= int(cfg_stop)


def plan_schedule(chunks: Sequence[Tuple[int, int, bool]], cadence: int,
                  cfg_stop: int, evals_per_step: int,
                  total_steps: int) -> Dict[str, int]:
    """The step loop's refresh and truncation decisions, replayed.

    ``chunks``: ``(start, length, cached)`` of each chunk in order; an
    uncached chunk (a ControlNet unit active in it) runs the plain
    evaluation and invalidates the cache, so the next cached step
    refreshes.

    Returns evaluation counts by kind: ``full_evals`` (plain, 2B rows),
    ``reuse_full_evals`` (2B), ``reuse_trunc_evals`` (B), ``deep_full``
    (2B), ``deep_trunc`` (B) and ``refreshes`` (their sum). A two-eval
    sampler's last step makes one evaluation."""
    counts = {"full_evals": 0, "reuse_full_evals": 0,
              "reuse_trunc_evals": 0, "deep_full": 0, "deep_trunc": 0,
              "refreshes": 0}
    cadence = max(1, int(cadence))
    valid = False
    for start, length, cached in chunks:
        for i in range(start, start + length):
            evals = evals_per_step if i < total_steps - 1 else 1
            if not cached:
                valid = False
                counts["full_evals"] += evals
                continue
            truncated = i >= cfg_stop
            if (not valid) or (i % cadence == 0):
                counts["refreshes"] += 1
                counts["deep_trunc" if truncated else "deep_full"] += 1
            valid = True
            counts["reuse_trunc_evals" if truncated
                   else "reuse_full_evals"] += evals
    return counts


def unet_eval_flops(ucfg, rows: int, lat_h: int, lat_w: int, ctx_len: int,
                    mode: Optional[str] = None, unet=None) -> float:
    """FLOPs of one UNet evaluation of ``rows`` rows at ``lat_h`` x
    ``lat_w`` latents with ``ctx_len`` context tokens (``mode``: None for
    the whole forward, ``"deep"`` or ``"reuse"`` for the step cache's), as
    ``FlopCounterMode`` counts matrix products and convolutions on meta
    tensors. ``unet``: a meta UNet of ``ucfg`` to reuse (one is built
    otherwise)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from stable_diffusion_webui_distributed_tpu_torch.models import (
        unet as unet_mod,
    )

    with torch.device("meta"):
        if unet is None:
            unet = unet_mod.UNet(ucfg)
        x = torch.zeros(rows, lat_h, lat_w, ucfg.in_channels)
        t = torch.ones(rows)
        ctx = torch.zeros(rows, ctx_len, ucfg.cross_attention_dim)
        added = (torch.zeros(rows, ucfg.projection_input_dim)
                 if ucfg.addition_embed_dim else None)
        cache = (torch.zeros(unet_mod.deep_cache_shape(ucfg, rows, lat_h,
                                                       lat_w))
                 if mode == "reuse" else None)
        with FlopCounterMode(display=False) as count:
            unet(x, t, ctx, added, cache=cache, cache_mode=mode)
    return float(count.get_total_flops())


class FlopsAccountant:
    """One engine's cache of UNet-evaluation prices (see the module's
    docstring). Thread-safe; pricing never raises into generation."""

    def __init__(self, engine) -> None:
        self._engine = engine
        self._lock = threading.Lock()
        self._cache: Dict[Tuple, Optional[float]] = {}  # guarded-by: _lock
        self._unet = None  # guarded-by: _lock

    def eval_flops(self, rows: int, lat_h: int, lat_w: int,
                   ctx_len: int, mode: Optional[str],
                   precision: str = "") -> Optional[float]:
        """FLOPs of one evaluation at ``rows`` rows in ``mode`` (None, the
        whole forward; ``"deep"``; ``"reuse"``) and serving ``precision``
        (the key's last axis, as in the JAX package: an int8 evaluation
        makes the same products, counted alike); None when the family has
        no step cache for a cached mode, or the count fails."""
        key = (rows, lat_h, lat_w, ctx_len, mode, precision)
        with self._lock:
            if key in self._cache:
                return self._cache[key]
        flops = self._measure(rows, lat_h, lat_w, ctx_len, mode)
        with self._lock:
            self._cache[key] = flops
        return flops

    def _measure(self, rows, lat_h, lat_w, ctx_len, mode):
        from stable_diffusion_webui_distributed_tpu_torch.models import (
            unet as unet_mod,
        )

        ucfg = self._engine.family.unet
        if mode is not None and not unet_mod.cache_supported(ucfg):
            return None
        try:
            import torch

            with self._lock:
                if self._unet is None:
                    with torch.device("meta"):
                        self._unet = unet_mod.UNet(ucfg)
                unet = self._unet
            flops = unet_eval_flops(ucfg, rows, lat_h, lat_w, ctx_len, mode,
                                    unet=unet)
            return flops if flops > 0 else None
        except Exception:  # noqa: BLE001 — pricing never breaks generation
            return None

    def request_flops(self, counts: Dict[str, int], batch: int,
                      lat_h: int, lat_w: int, ctx_len: int,
                      precision: str = "") -> Optional[float]:
        """The UNet FLOPs of a denoise range from its
        :func:`plan_schedule` counts; None when a needed price is
        unavailable."""
        need = (
            ("full_evals", 2 * batch, None),
            ("reuse_full_evals", 2 * batch, "reuse"),
            ("reuse_trunc_evals", batch, "reuse"),
            ("deep_full", 2 * batch, "deep"),
            ("deep_trunc", batch, "deep"),
        )
        total = 0.0
        for key, rows, mode in need:
            n = counts.get(key, 0)
            if not n:
                continue
            price = self.eval_flops(rows, lat_h, lat_w, ctx_len, mode,
                                    precision)
            if price is None:
                return None
            total += n * price
        return total
