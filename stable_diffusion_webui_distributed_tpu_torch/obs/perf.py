"""The perf ledger: device time, FLOPs and MFU per serving group, padding,
capture latency and SLO attainment.

A copy of the JAX package's ``obs/perf.py``. The serving dispatcher
reports every device dispatch here: its device seconds joined with the
UNet FLOPs that ``pipeline/stepcache.FlopsAccountant`` priced for the same
denoise range; the ledger folds them into per-(bucket, cadence, precision,
lora) groups carrying

- **MFU**: dispatched UNet FLOPs / device seconds / the card's peak
  (:func:`peak_flops_for`; None on the CPU or an unknown card, so no MFU
  is ever made up). The numerator counts the UNet only, as in the JAX
  package, while the device seconds also hold the encode and the f32 VAE
  decode the group queued: the MFU is the share of the card's peak the
  whole dispatch turned into UNet products;
- **padding**: true-requested pixels against padded-dispatched ones, the
  ragged-masked rows and the conditioning's padded tokens;
- **device memory**: the allocator's watermark after the dispatch
  (``obs/tsdb.py``);
- **capture latency** per CUDA-graph kind (``runtime/graphs.py``; the
  port's counterpart of the JAX package's compiles);
- **SLO attainment and burn rate** per (tenant, class) under the fleet
  gate.

The device seconds are not host seconds around the dispatch: the port
queues its work and returns. They are the CUDA events that the engine
records around the denoise loop and each decode it queues
(``obs/spans.device_interval``), read once the group's decode has been
waited for.

Gated on ``SDTPU_PERF`` (off): with it off every record call returns at
once and the dispatch path is the uninstrumented one. Recording is host
arithmetic under one lock, never a device synchronisation.
``GET /internal/perf`` serves :meth:`PerfLedger.summary`;
``obs/prometheus.py`` renders the groups as ``sdtpu_perf_*``.

**The executables census** (``GET /internal/executables``,
:func:`census_from_keys`) holds an engine's CUDA graphs to the JAX
package's serving budget: at most :data:`STEP_CACHE_BUDGET` step-cache
variants, :data:`PRECISION_BUDGET` precisions and :data:`LORA_BUDGET`
traced-LoRA cells per shape bucket. The JAX package compiles one chunk of
sampler steps per bucket and variant; the port captures one graph per
evaluation signature (``runtime/graphs.py``), so the census maps the
graph keys onto the JAX package's terms. A bucket is the model, the latent
shape of the evaluation's rows and the number of rows. Its budgeted
variants are the tag's precision flags and its step-cache mode: ``unet``,
``ragged`` and the stage-ahead ControlNet's ``cnres`` and ``cnstep`` are
the plain mode, and the step cache's ``deep`` and ``reuse`` evaluations,
truncated or not, are one variant together (the JAX package's one
step-cache chunk). A traced-LoRA cell is the shapes of the ``lora/``
inputs. A bucket's ``executables`` counts its distinct (LoRA cell, mode,
precision) combinations, the JAX package's chunks (the graphs behind them
are more); ``alarm`` trips exactly when a variant count passes its
budget, as it does in the JAX package. The body has the JAX package's
keys. The AOT-load accounting is a
later slice's, with the artifact store.
"""

from __future__ import annotations

import threading
from collections import OrderedDict, deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

from stable_diffusion_webui_distributed_tpu_torch.pipeline.precision import (
    name_for_flags,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    env_flag,
    env_float,
    env_int,
)

#: distinct group rows and (tenant, class) SLO rows kept; the least
#: recently touched row goes first
DEFAULT_GROUPS = 64
#: dispatch completions in the SLO burn-rate window
SLO_WINDOW = 64
#: the SLO attainment target: burn rate 1.0 misses exactly 1 - target
DEFAULT_SLO_TARGET = 0.95

#: the serving budget per shape bucket (the JAX package's): the plain and
#: the step-cache variant, three precision rungs, and four traced-LoRA
#: cells beside the adapterless variant
STEP_CACHE_BUDGET = 2
PRECISION_BUDGET = 3
LORA_BUDGET = 4

#: graph kinds of the step cache's evaluations (one variant together)
_STEP_CACHE_KINDS = frozenset({"deep", "reuse", "deep-trunc",
                               "reuse-trunc"})

#: dense bf16 tensor-core peak FLOP/s by device name (lower case, spaces
#: removed), from NVIDIA's H100 datasheet: the SXM5 card (the 700 W
#: "H100 80GB HBM3") and the PCIe card
PEAK_FLOPS_BF16: Dict[str, float] = {
    "h10080gbhbm3": 989.4e12,
    "h100pcie": 756e12,
}
#: int8 peak over bf16 (the datasheet's dense int8 TOPS are twice its
#: bf16 TFLOPS)
INT8_PEAK_RATIO = 2.0


def enabled() -> bool:
    """The knob, read per record call (tests and phases flip it)."""
    return env_flag("SDTPU_PERF", False)


def peak_flops_for(device_kind: str, precision: str = "bf16"
                   ) -> Optional[float]:
    """The peak FLOP/s of a card at a serving precision, or None for a
    card the table does not hold (and the CPU). ``SDTPU_PERF_PEAK_FLOPS``
    overrides the table."""
    override = env_float("SDTPU_PERF_PEAK_FLOPS", 0.0)
    if override > 0:
        return override
    dk = str(device_kind or "").lower().replace(" ", "")
    for key, val in PEAK_FLOPS_BF16.items():
        if key in dk:
            if str(precision or "").startswith("int8"):
                return val * INT8_PEAK_RATIO
            return val
    return None


def _device_kind() -> str:
    """The card's name (``torch.cuda.get_device_name``), '' on the CPU or
    on any failure: never an exception on the dispatch path."""
    try:
        import torch

        if not torch.cuda.is_available():
            return ""
        return torch.cuda.get_device_name()
    except Exception:  # noqa: BLE001 — telemetry must not fail dispatch
        return ""


def _new_group() -> Dict[str, float]:
    return {"dispatches": 0, "requests": 0, "device_s": 0.0,
            "flops": 0.0, "true_pixels": 0, "padded_pixels": 0,
            "batch_raw": 0, "batch_run": 0, "masked_pixels": 0,
            "true_tokens": 0, "padded_tokens": 0}


class PerfLedger:
    """The thread-safe accumulator behind ``/internal/perf``: group and SLO
    rows in bounded ``OrderedDict`` rings, evictions counted."""

    def __init__(self, max_groups: Optional[int] = None,
                 slo_target: Optional[float] = None) -> None:
        if max_groups is None:
            max_groups = env_int("SDTPU_PERF_GROUPS", DEFAULT_GROUPS)
        if slo_target is None:
            slo_target = env_float("SDTPU_PERF_SLO_TARGET",
                                   DEFAULT_SLO_TARGET)
        self.max_groups = max(1, int(max_groups or DEFAULT_GROUPS))
        self.slo_target = min(0.9999, max(0.0, float(slo_target)))
        self._lock = threading.Lock()
        self._groups: \
            "OrderedDict[Tuple[str, int, str, str], Dict[str, float]]" \
            = OrderedDict()  # guarded-by: _lock
        self._groups_evicted = 0  # guarded-by: _lock
        self._compiles: Dict[str, Dict[str, float]] = {}  # guarded-by: _lock
        self._slo: "OrderedDict[Tuple[str, str], Dict[str, Any]]" \
            = OrderedDict()  # guarded-by: _lock
        self._slo_evicted = 0  # guarded-by: _lock
        self._last_dispatch: Optional[Dict[str, Any]] = None  # guarded-by: _lock
        self._device_kind: Optional[str] = None  # guarded-by: _lock

    def _group(self, key: Tuple[str, int, str, str]
               ) -> Tuple[Dict[str, float], int]:
        """The group row of ``key``, made (evicting the oldest) when new,
        and the number of rows that evicted; the caller holds the lock and
        counts the evictions."""
        g = self._groups.get(key)
        if g is not None:
            self._groups.move_to_end(key)
            return g, 0
        evicted = 0
        if len(self._groups) >= self.max_groups:
            self._groups.popitem(last=False)
            evicted = 1
        g = _new_group()
        self._groups[key] = g
        return g, evicted

    def record_dispatch(self, *, bucket: str, cadence: int, precision: str,
                        lora: str = "",
                        device_s: float, flops: float, requests: int,
                        batch_raw: int, batch_run: int, true_pixels: int,
                        padded_pixels: int, masked_pixels: int = 0,
                        true_tokens: int = 0, padded_tokens: int = 0,
                        hbm: Optional[Dict[str, int]] = None) -> None:
        """One device dispatch: its device seconds, the UNet FLOPs priced
        for its denoise range and its true-vs-padded accounting.
        ``padded_pixels`` is everything resident (bucket area x
        ``batch_run``), ``masked_pixels`` the slice of it the ragged
        kernel masks; ``hbm`` the device-memory sample (None on the CPU:
        the row then reports null watermarks); ``lora`` the traced cell
        (``"r8s1"``, '' without one). A no-op with ``SDTPU_PERF`` off; it
        never raises."""
        if not enabled():
            return
        try:
            key = (str(bucket), int(cadence), str(precision), str(lora))
            with self._lock:
                if self._device_kind is None:
                    self._device_kind = _device_kind()
                g, evicted = self._group(key)
                self._groups_evicted += evicted
                g["dispatches"] += 1
                g["requests"] += int(requests)
                g["device_s"] += max(0.0, float(device_s))
                g["flops"] += max(0.0, float(flops))
                g["true_pixels"] += int(true_pixels)
                g["padded_pixels"] += int(padded_pixels)
                g["batch_raw"] += int(batch_raw)
                g["batch_run"] += int(batch_run)
                g["masked_pixels"] += int(masked_pixels)
                g["true_tokens"] += int(true_tokens)
                g["padded_tokens"] += int(padded_tokens)
                if hbm:
                    # watermarks: the highest peak, the latest in-use
                    if hbm.get("peak_bytes_in_use") is not None:
                        g["hbm_peak_bytes"] = max(
                            int(g.get("hbm_peak_bytes", 0)),
                            int(hbm["peak_bytes_in_use"]))
                    if hbm.get("bytes_in_use") is not None:
                        g["hbm_bytes_in_use"] = int(hbm["bytes_in_use"])
                    if hbm.get("live_buffers") is not None:
                        g["live_buffers"] = int(hbm["live_buffers"])
                compiles_total = sum(int(c["count"])
                                     for c in self._compiles.values())
                self._last_dispatch = self._dispatch_entry(
                    key, g, device_s, flops, self._device_kind,
                    compiles_total)
        except Exception:  # noqa: BLE001 — telemetry must not fail dispatch
            pass

    def record_stages(self, *, bucket: str, cadence: int, precision: str,
                      lora: str = "", stage_s: float,
                      overlap_s: float) -> None:
        """The stage-graph executor's accounting of one group
        (``parallel/stage_graph.py``): host seconds of its encode, decode
        and merge stages and the part of them that overlapped other
        groups' denoise windows; the row gains ``stage_overlap_ratio``.
        A no-op with ``SDTPU_PERF`` off; it never raises."""
        if not enabled():
            return
        try:
            key = (str(bucket), int(cadence), str(precision), str(lora))
            with self._lock:
                g, evicted = self._group(key)
                self._groups_evicted += evicted
                g["stage_s"] = g.get("stage_s", 0.0) \
                    + max(0.0, float(stage_s))
                g["stage_overlap_s"] = g.get("stage_overlap_s", 0.0) \
                    + max(0.0, float(overlap_s))
        except Exception:  # noqa: BLE001 — telemetry must not fail dispatch
            pass

    def record_compile(self, kind: str, seconds: float) -> None:
        """One CUDA-graph capture (``runtime/graphs.py``: the eager first
        call and the capture), by graph kind; also the kind's Prometheus
        capture histogram. A no-op with ``SDTPU_PERF`` off."""
        if not enabled():
            return
        try:
            with self._lock:
                c = self._compiles.setdefault(
                    str(kind), {"count": 0, "total_s": 0.0, "max_s": 0.0,
                                "last_s": 0.0})
                c["count"] += 1
                c["total_s"] += max(0.0, float(seconds))
                c["max_s"] = max(c["max_s"], float(seconds))
                c["last_s"] = float(seconds)
            from stable_diffusion_webui_distributed_tpu_torch.obs import (
                prometheus as obs_prom,
            )

            obs_prom.observe_compile(str(kind), float(seconds))
        except Exception:  # noqa: BLE001 — telemetry must not fail captures
            pass

    def record_slo(self, *, tenant: str, cls: str, slo_s: float,
                   latency_s: float, ok: bool = True) -> None:
        """One fleet-gated request's completion against its SLO; an
        errored request misses like a late one."""
        if not enabled():
            return
        try:
            met = bool(ok) and float(latency_s) <= float(slo_s)
            key = (str(tenant), str(cls))
            with self._lock:
                row = self._slo.get(key)
                if row is None:
                    if len(self._slo) >= self.max_groups:
                        self._slo.popitem(last=False)
                        self._slo_evicted += 1
                    row = {"total": 0, "met": 0, "slo_s": float(slo_s),
                           "window": deque(maxlen=SLO_WINDOW)}
                    self._slo[key] = row
                else:
                    self._slo.move_to_end(key)
                row["total"] += 1
                row["met"] += 1 if met else 0
                row["slo_s"] = float(slo_s)
                row["window"].append(1 if met else 0)
        except Exception:  # noqa: BLE001 — telemetry must not fail dispatch
            pass

    @staticmethod
    def _dispatch_entry(key: Tuple[str, int, str, str],
                        g: Dict[str, float], device_s: float,
                        flops: float, device_kind: Optional[str],
                        compiles_total: int) -> Dict[str, Any]:
        """This dispatch's snapshot for the flight recorder (its own
        values, not the group's sums)."""
        peak = peak_flops_for(device_kind or "", key[2])
        mfu = None
        if peak and device_s > 0:
            mfu = float(flops) / float(device_s) / peak
        true_px = g["true_pixels"]
        padded_px = g["padded_pixels"]
        return {
            "bucket": key[0], "cadence": key[1], "precision": key[2],
            "lora": key[3],
            "device_s": round(float(device_s), 6),
            "flops": float(flops),
            "mfu": mfu,
            "padding_ratio": (padded_px / true_px) if true_px else None,
            "compiles_total": int(compiles_total),
        }

    @staticmethod
    def _group_row(key: Tuple[str, int, str, str], g: Dict[str, float],
                   device_kind: Optional[str]) -> Dict[str, Any]:
        peak = peak_flops_for(device_kind or "", key[2])
        mfu = None
        if peak and g["device_s"] > 0:
            mfu = g["flops"] / g["device_s"] / peak
        true_px, padded_px = g["true_pixels"], g["padded_pixels"]
        ratio = (padded_px / true_px) if true_px else None
        masked_px = int(g.get("masked_pixels", 0))
        true_tok = int(g.get("true_tokens", 0))
        padded_tok = int(g.get("padded_tokens", 0))
        stage_s = float(g.get("stage_s", 0.0))
        stage_ov = float(g.get("stage_overlap_s", 0.0))
        return {
            "bucket": key[0], "cadence": key[1], "precision": key[2],
            "lora": key[3],
            "dispatches": int(g["dispatches"]),
            "requests": int(g["requests"]),
            "device_s": g["device_s"],
            "flops": g["flops"],
            "mfu": mfu,
            "padding_ratio": ratio,
            "padding_waste": (1.0 - true_px / padded_px) if padded_px
            else None,
            "batch_raw": int(g["batch_raw"]),
            "batch_run": int(g["batch_run"]),
            "masked_pixels": masked_px,
            "compute_padding_ratio": ((padded_px - masked_px) / true_px)
            if true_px else None,
            "token_padding_ratio": (padded_tok / true_tok)
            if true_tok else None,
            "stage_overlap_ratio": (stage_ov / stage_s) if stage_s
            else 0.0,
            "hbm_peak_bytes": g.get("hbm_peak_bytes"),
            "hbm_bytes_in_use": g.get("hbm_bytes_in_use"),
            "live_buffers": g.get("live_buffers"),
        }

    def _slo_row(self, key: Tuple[str, str],
                 row: Dict[str, Any]) -> Dict[str, Any]:
        window = list(row["window"])
        misses = window.count(0)
        budget = 1.0 - self.slo_target
        burn = (misses / len(window)) / budget if window and budget > 0 \
            else 0.0
        return {
            "tenant": key[0], "class": key[1], "slo_s": row["slo_s"],
            "total": row["total"], "met": row["met"],
            "attainment": row["met"] / row["total"] if row["total"] else None,
            "window": len(window), "window_misses": misses,
            "burn_rate": burn,
        }

    def last_dispatch(self) -> Optional[Dict[str, Any]]:
        """The most recent dispatch's snapshot (the flight recorder)."""
        with self._lock:
            return dict(self._last_dispatch) if self._last_dispatch else None

    def summary(self) -> Dict[str, Any]:
        """The ``/internal/perf`` body."""
        with self._lock:
            groups = [self._group_row(k, g, self._device_kind)
                      for k, g in self._groups.items()]
            slo = [self._slo_row(k, r) for k, r in self._slo.items()]
            compiles = {k: dict(c) for k, c in self._compiles.items()}
            evicted, slo_evicted = self._groups_evicted, self._slo_evicted
            device_kind = self._device_kind or ""
        out = {
            "enabled": enabled(),
            "device_kind": device_kind,
            "peak_flops_bf16": peak_flops_for(device_kind, "bf16"),
            "groups": groups,
            "groups_evicted": evicted,
            "compiles": compiles,
            "slo": slo,
            "slo_evicted": slo_evicted,
            "slo_target": self.slo_target,
        }
        try:
            from stable_diffusion_webui_distributed_tpu_torch import cache

            out["cache"] = (cache.summary() if cache.enabled()
                            else {"enabled": False})
        except Exception:  # noqa: BLE001 — the body stays best-effort
            out["cache"] = {"enabled": False}
        return out

    def clear(self) -> None:
        with self._lock:
            self._groups.clear()
            self._compiles.clear()
            self._slo.clear()
            self._groups_evicted = 0
            self._slo_evicted = 0
            self._last_dispatch = None
            self._device_kind = None


#: The process-wide ledger.
LEDGER = PerfLedger()


# -- the executables census ---------------------------------------------------

def _census_entry(key: Tuple) -> Optional[Tuple[Tuple, str, bool, str,
                                                 Tuple]]:
    """``(bucket identity, label, step cache, precision, LoRA cell)`` of a
    ``(model, graph key)`` pair (``pipeline/engine.py``
    ``executable_keys``), or None for a key of another shape."""
    try:
        model, (tag, sig_run, sig_call, _n_scalars) = key
        kind, flags = str(tag[0]), tuple(bool(f) for f in tag[1])
        shapes = {name: tuple(shape) for name, shape, *_ in sig_call}
        rows, h, w, c = shapes["x"]
    except (TypeError, ValueError, KeyError, IndexError):
        return None
    lora = tuple((name, tuple(shape)) for name, shape, *_ in sig_run
                 if str(name).startswith("lora/"))
    ident = (str(model), (h, w, c), rows)
    label = f"{model} latent {h}x{w}x{c} rows {rows}"
    precision = name_for_flags(flags) or str(flags)
    return ident, label, kind in _STEP_CACHE_KINDS, precision, lora


def census_from_keys(keys: Iterable[Tuple],
                     step_cache_budget: int = STEP_CACHE_BUDGET,
                     precision_budget: int = PRECISION_BUDGET,
                     lora_budget: int = LORA_BUDGET) -> Dict[str, Any]:
    """Group an engine's graph keys by shape bucket and hold each bucket
    to the budget (the module's docstring gives the mapping)."""
    buckets: "OrderedDict[Tuple, Dict[str, Any]]" = OrderedDict()
    other = 0
    for k in keys:
        entry = _census_entry(k)
        if entry is None:
            other += 1
            continue
        ident, label, step_cache, precision, lora = entry
        b = buckets.get(ident)
        if b is None:
            b = {"bucket": label, "variants": set(),
                 "step_cache_variants": set(),
                 "precision_variants": set(), "lora_variants": set()}
            buckets[ident] = b
        b["variants"].add((lora, step_cache, precision))
        b["step_cache_variants"].add(step_cache)
        b["precision_variants"].add(precision)
        b["lora_variants"].add(lora)
    rows: List[Dict[str, Any]] = []
    over: List[str] = []
    for b in buckets.values():
        sc, prec = b["step_cache_variants"], b["precision_variants"]
        n_lora = len([v for v in b["lora_variants"] if v])
        executables = len(b["variants"])
        over_budget = (len(sc) > step_cache_budget
                       or len(prec) > precision_budget
                       or n_lora > lora_budget
                       or executables > step_cache_budget
                       * precision_budget * (1 + n_lora))
        rows.append({
            "bucket": b["bucket"],
            "executables": executables,
            "step_cache_variants": len(sc),
            "precisions": sorted(prec),
            "lora_variants": n_lora,
            "over_budget": over_budget,
        })
        if over_budget:
            over.append(b["bucket"])
    return {
        "buckets": rows,
        "chunk_executables": sum(r["executables"] for r in rows),
        "other_executables": other,
        "budget": {"step_cache": step_cache_budget,
                   "precision": precision_budget,
                   "lora": lora_budget,
                   "per_bucket": step_cache_budget * precision_budget},
        "over_budget": over,
        "alarm": bool(over),
    }


def executables_census(engine: Any) -> Dict[str, Any]:
    """The census over an engine's graph cache (the
    ``/internal/executables`` body): a read, no capture, no device
    work."""
    return census_from_keys(engine.executable_keys())
