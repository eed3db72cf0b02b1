"""Workload generator: replay a recorded journal mix, scaled and shaped.

Port of the JAX package's ``sim/workload.py``. A journal recording (a live
snapshot dict, a ``/internal/journal`` JSON file, or an
``SDTPU_JOURNAL_SINK`` JSONL spill) carries every request's post-``fix_seed``
payload dump on its ``received``/``planned`` event: enough to re-emit the
*mix* at any rate. :func:`generate_plan` resamples that mix into
``spec.count`` requests with deterministic seeded transforms (same mix and
spec, same plan; the draws come from ``random.Random(spec.seed)`` in the
JAX package's order, so both packages plan alike):

- **rate_scale**: compress or stretch the recorded arrival process;
- **diurnal**: sinusoidal arrival-rate modulation (amplitude, period);
- **flash burst**: ``burst_size`` simultaneous arrivals at the
  ``burst_at`` fraction of the timeline;
- **diversity knobs**: optional shape, precision, tenant and class pools
  sampled per request, stressing bucketing and fleet scheduling.

:func:`emit_open_loop` then fires the plan open-loop (arrival-clocked
threads, as real traffic: late responses do not slow later arrivals)
against any ``submit(payload)`` callable, normally
``ServingDispatcher.submit``, and returns one record per request for
:mod:`.score`.
"""

from __future__ import annotations

import dataclasses
import json
import math
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
)

Source = Union[str, Dict[str, Any], List[Dict[str, Any]]]


def load_events(source: Source) -> List[Dict[str, Any]]:
    """Journal events from a snapshot dict, snapshot JSON file, or JSONL
    sink file, sorted by seq (sink spills can land out of order)."""
    if isinstance(source, dict):
        events = list(source.get("events", []))
    elif isinstance(source, list):
        events = list(source)
    else:
        with open(source, "r", encoding="utf-8") as fh:
            text = fh.read()
        try:
            doc = json.loads(text)
        except ValueError:
            doc = None
        if isinstance(doc, dict):
            events = list(doc.get("events", []))
        elif isinstance(doc, list):
            events = list(doc)
        else:
            # JSONL sink: one event object per line
            events = [json.loads(line) for line in text.splitlines()
                      if line.strip()]
    return sorted(events, key=lambda e: e.get("seq", 0))


def base_mix(events: List[Dict[str, Any]]) -> List[Tuple[Dict[str, Any],
                                                         float]]:
    """(payload dump, relative arrival seconds) per recorded request, in
    arrival order. Requests whose payload-bearing event fell out of the
    ring (and off the sink) are skipped."""
    first_payload: Dict[str, Dict[str, Any]] = {}
    first_t: Dict[str, float] = {}
    order: List[str] = []
    for ev in events:
        rid = ev.get("request_id", "")
        if rid not in first_t:
            first_t[rid] = float(ev.get("t_mono", 0.0))
            order.append(rid)
        if rid not in first_payload \
                and ev.get("event") in ("received", "planned"):
            payload = (ev.get("attrs") or {}).get("payload")
            if isinstance(payload, dict):
                first_payload[rid] = payload
    mix = [(first_payload[rid], first_t[rid])
           for rid in order if rid in first_payload]
    if not mix:
        return []
    t0 = min(t for _, t in mix)
    return [(p, t - t0) for p, t in mix]


def synthetic_mix(n: int = 8, size: int = 64, steps: int = 4,
                  seed: int = 0) -> List[Tuple[Dict[str, Any], float]]:
    """A recorded-mix stand-in when no journal is available: ``n``
    prompts arriving one second apart."""
    rng = random.Random(seed)
    mix = []
    for i in range(n):
        mix.append(({
            "prompt": f"synthetic scene {i}, variant {rng.randrange(100)}",
            "seed": 1000 + i,
            "steps": steps,
            "width": size,
            "height": size,
            "batch_size": 1,
        }, float(i)))
    return mix


@dataclasses.dataclass
class WorkloadSpec:
    """Deterministic transform knobs; same (mix, spec) → same plan."""

    seed: int = 0
    count: int = 0              # 0 = one pass over the mix, unscaled
    rate_scale: float = 1.0     # >1 = compress arrivals (more rps)
    diurnal_amplitude: float = 0.0   # 0..1 sinusoidal rate modulation
    diurnal_period_s: float = 60.0
    burst_size: int = 0         # simultaneous arrivals injected...
    burst_at: float = 0.5       # ...at this fraction of the timeline
    shapes: Optional[List[Tuple[int, int]]] = None   # (w, h) pool
    precisions: Optional[List[str]] = None
    tenants: Optional[List[str]] = None
    classes: Optional[List[str]] = None


@dataclasses.dataclass
class SimRequest:
    """One planned request: arrival offset + ready-to-submit payload."""

    index: int
    request_id: str
    arrival_s: float
    payload: GenerationPayload

    def dump(self) -> Dict[str, Any]:
        return {
            "index": self.index,
            "request_id": self.request_id,
            "arrival_s": round(self.arrival_s, 6),
            "payload": self.payload.model_dump(),
        }


def generate_plan(mix: List[Tuple[Dict[str, Any], float]],
                  spec: WorkloadSpec) -> List[SimRequest]:
    """Resample ``mix`` into a deterministic request plan.

    The recorded mean inter-arrival sets the base rate; each generated
    gap is an exponential draw at that rate × ``rate_scale`` × the
    diurnal factor at the current point of the timeline. Payloads are
    sampled from the mix with replacement (first pass keeps recorded
    order so ``count <= len(mix)`` replays a prefix verbatim)."""
    if not mix:
        raise ValueError("empty workload mix")
    rng = random.Random(spec.seed)
    count = spec.count or len(mix)
    arrivals = sorted(t for _, t in mix)
    if len(arrivals) > 1 and arrivals[-1] > arrivals[0]:
        mean_gap = (arrivals[-1] - arrivals[0]) / (len(arrivals) - 1)
    else:
        mean_gap = 1.0
    mean_gap /= max(1e-9, spec.rate_scale)

    plan: List[SimRequest] = []
    t = 0.0
    for i in range(count):
        if i < len(mix):
            base = mix[i][0]
        else:
            base = mix[rng.randrange(len(mix))][0]
        dump = dict(base)
        if spec.shapes:
            w, h = spec.shapes[rng.randrange(len(spec.shapes))]
            dump["width"], dump["height"] = int(w), int(h)
        if spec.precisions:
            dump["precision"] = spec.precisions[
                rng.randrange(len(spec.precisions))]
        if spec.tenants:
            dump["tenant"] = spec.tenants[rng.randrange(len(spec.tenants))]
        if spec.classes:
            dump["priority_class"] = spec.classes[
                rng.randrange(len(spec.classes))]
        rid = f"sim-{spec.seed}-{i:05d}"
        dump["request_id"] = rid
        plan.append(SimRequest(
            index=i, request_id=rid, arrival_s=t,
            payload=GenerationPayload(**dump)))
        # diurnal factor for the NEXT gap, evaluated at the current point
        factor = 1.0
        if spec.diurnal_amplitude > 0.0:
            factor += spec.diurnal_amplitude * math.sin(
                2.0 * math.pi * t / max(1e-9, spec.diurnal_period_s))
        rate = max(1e-9, factor) / max(1e-9, mean_gap)
        t += rng.expovariate(rate)

    if spec.burst_size > 0 and plan:
        span = plan[-1].arrival_s
        burst_t = span * min(1.0, max(0.0, spec.burst_at))
        base_i = rng.randrange(len(mix))
        n0 = len(plan)
        for j in range(spec.burst_size):
            dump = dict(mix[(base_i + j) % len(mix)][0])
            rid = f"sim-{spec.seed}-{n0 + j:05d}"
            dump["request_id"] = rid
            plan.append(SimRequest(
                index=n0 + j, request_id=rid, arrival_s=burst_t,
                payload=GenerationPayload(**dump)))
        plan.sort(key=lambda r: (r.arrival_s, r.index))
    return plan


def plan_fingerprint(plan: List[SimRequest]) -> str:
    """Stable hash of a plan (the determinism assertion of the tests)."""
    from stable_diffusion_webui_distributed_tpu_torch.obs.journal import (
        fingerprint,
    )

    return fingerprint([r.dump() for r in plan])


def emit_open_loop(plan: List[SimRequest],
                   submit: Callable[[GenerationPayload], Any],
                   time_scale: float = 1.0,
                   job: str = "txt2img") -> List[Dict[str, Any]]:
    """Fire the plan open-loop and return one score record per request.

    Each request fires on its own thread at ``arrival_s * time_scale``
    regardless of how earlier requests are faring (open-loop: overload
    shows up as latency/throttling, not as a slower generator)."""
    from stable_diffusion_webui_distributed_tpu_torch.fleet.admission import (
        FleetRejected,
    )

    records: List[Optional[Dict[str, Any]]] = [None] * len(plan)
    t0 = time.monotonic()

    def fire(i: int, req: SimRequest) -> None:
        delay = req.arrival_s * time_scale - (time.monotonic() - t0)
        if delay > 0:
            time.sleep(delay)
        rec: Dict[str, Any] = {
            "request_id": req.request_id,
            "class": req.payload.priority_class or "interactive",
            "tenant": req.payload.tenant,
            "expected": req.payload.total_images,
            "images": 0,
        }
        started = time.monotonic()
        try:
            result = submit(req.payload)
            rec["status"] = "completed"
            rec["images"] = len(getattr(result, "images", []) or [])
        except FleetRejected as e:
            rec["status"] = getattr(e, "reason", "rejected") or "rejected"
        except Exception as e:  # noqa: BLE001 — scored, not raised
            rec["status"] = "failed"
            rec["error"] = str(e)
        rec["latency_s"] = time.monotonic() - started
        records[i] = rec

    threads = [threading.Thread(target=fire, args=(i, req), daemon=True)
               for i, req in enumerate(plan)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return [r for r in records if r is not None]
