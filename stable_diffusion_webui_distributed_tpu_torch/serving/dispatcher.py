"""Continuous-batching dispatcher: coalesce compatible requests into one
device batch.

Port of the core of the JAX package's ``serving/dispatcher.py``. The HTTP
layer runs one thread per request; without this module an engine serves
them one whole request at a time. The dispatcher gives every request a
ticket and groups compatible concurrent tickets (same sampler, steps, CFG
scale, negative prompt, clip skip and shape BUCKET, see :mod:`.bucketer`)
into one denoise loop, then splits images, seeds and infotext back per
requester. The first ticket of a group is its *leader*: it sleeps one
coalesce window (``SDTPU_COALESCE_WINDOW``, seconds) so that followers can
join, runs the batch under the execution lock on the engine's device
thread, and wakes the followers with their share.

Seed-exactness: every draw is keyed by (request seed + image index), never
by batch position, and each request's conditioning rides as its own
context rows, so each requester's seeds, subseeds and infotext equal those
of a run alone. Pixels agree within the rounding of another batch size:
on the card a row's bf16 numbers depend on the batch size.

Ragged dispatch (``SDTPU_RAGGED``): requests of one width class and any
height up to the class's tallest bucket share one group. Each row carries
its true latent rows and context length as device vectors, the attention
kernel masks the padded tail (kernel K2), and each image is cropped back
to its top-aligned true size.

LoRA: a request whose adapters are merged into the weights runs solo (a
merge changes the weights under every row). Under ``SDTPU_LORA_TRACED``
a request's adapters resolve to a traced set, and its (rank bucket, slot
count) cell joins the group key: requests with different adapters in one
cell share a batch, each member's set installed before its prompts are
encoded and its rows carrying its own factors into the UNet
(``models/lora.py`` ``stack_row_sets``).

Per-request cancellation: ``cancel(request_id)`` marks one ticket; the
batch keeps running, the cancelled requester's images are dropped at split
time and no other requester is affected.

Requests that cannot merge (more images than the largest batch bucket)
run solo under the same execution lock, still shape-bucketed.

Result cache (``SDTPU_CACHE``, ``cache/``): at admission, before
bucketing, a repeat of a payload is answered with a copy of the stored
result, and identical concurrent requests elect one leader that generates
while the others wait for its result (single-flight). A hit records no
request, dispatch or queue wait. Only a complete result is stored. The
stored bytes are those of the run that filled the entry, which may have
been coalesced (see ``cache/__init__.py``).

The fleet tier (``SDTPU_FLEET``, ``fleet/``): a request is admitted first,
before the result cache and before any metric: its tenant's quota, then
its ETA against its class's SLO (accept, degrade by the step cache, the
few-step budget and int8, or reject; a refusal raises
:class:`~..fleet.admission.FleetRejected`, 429 at the server, and refunds
the quota). The execution lock becomes a weighted-fair gate: a group runs
at its strongest class, and a preemptible one (no merged LoRA, no
adaptive sampler) gets the chunk-boundary preempt hook on its engine, so
an interactive arrival runs at the next chunk boundary and the batch job
resumes with its own bytes. Each dispatched request's wait feeds its
class's queue-wait histogram (``obs/prometheus.py``), the autoscaler's
signal. Off (the default), nothing of it is built.

The warm pool (``SDTPU_POOL`` with ``pool=``, ``fleet/pool.py``): each
leader or solo execution checks out the least-loaded ready resident before
it takes the device, and runs on that resident's engine; grouping reads
the primary engine (residents are built alike).

The stage-graph executor (``SDTPU_STAGE_GRAPH``, ``parallel/
stage_graph.py``): a coalesced group runs as four stages, encode
(:meth:`ServingDispatcher._group_build_inputs`), denoise, decode and merge.
The first three run on the engine's device thread under the gate and
return once their device work is queued (the denoise without a host wait,
the decode into pinned memory behind a CUDA event); the merge (the wait on
that event, the PNGs, the split per ticket) runs on the leader's thread
after the gate is released, so the next group's stages overlap it.
Tickets complete only once their images exist; each ticket's
``on_stage(request_id, stage, seconds)`` is called as each stage ends. A
ragged group takes the same path.

The request journal (``SDTPU_JOURNAL``, ``obs/journal.py``): ``received``
(with the payload's dump and fingerprint), ``throttled`` / ``admitted`` /
``degraded``, ``result_dedupe_hit``, ``bucketed``, ``coalesced_leader`` /
``coalesced_follower``, ``dispatched``, ``embed_cache_hit``,
``prefix_resumed``, ``decoded``, ``merged``, ``completed`` and ``failed``,
with the JAX package's attributes. The chaos hook (``CHAOS_HOOK``,
``sim/chaos.py``) is consulted once per submitted request.

The request-observability plane (the JAX package's hooks, at its sites):
every submitted request runs under a request context (``obs/spans.py``:
the HTTP server's, else one minted here as ``serve.<job>``); the bucketer's
``bucket`` span, the ``queue_wait`` interval, and one ``dispatch.device``
span per execution, whose ``device_ms`` sums the CUDA events the engine
records around the group's encode, denoise and decode, mirrored into each
coalesced follower's tree as ``coalesced.dispatch`` with
``leader_request_id``; a cancel marks the request's trace interrupted.
With ``SDTPU_WATCHDOG_FACTOR`` and a calibrated admission controller the
hang watchdog (``obs/watchdog.py``) watches each execution at its
predicted seconds. With ``SDTPU_PERF`` the perf ledger (``obs/perf.py``)
gets each dispatch once its images exist: its device seconds from those
events (host seconds on the CPU, where nothing is queued), the UNet FLOPs
the engine priced for its denoise, padding, tokens and device memory;
the stage-graph groups' stage and overlap seconds; and under the fleet
gate each request's SLO outcome. Prometheus counts queue waits, the
precision mix and the fleet's admissions, throttles and requests.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from stable_diffusion_webui_distributed_tpu_torch import cache
from stable_diffusion_webui_distributed_tpu_torch.fleet import (
    admission as fleet_admission,
)
from stable_diffusion_webui_distributed_tpu_torch.fleet import (
    policy as fleet_policy,
)
from stable_diffusion_webui_distributed_tpu_torch.fleet import (
    pool as fleet_pool,
)
from stable_diffusion_webui_distributed_tpu_torch.fleet import (
    quotas as fleet_quotas,
)
from stable_diffusion_webui_distributed_tpu_torch.models import (
    lora as lora_mod,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    journal as obs_journal,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    perf as obs_perf,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    prometheus as obs_prom,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    spans as obs_spans,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    tsdb as obs_tsdb,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    watchdog as obs_watchdog,
)
from stable_diffusion_webui_distributed_tpu_torch.parallel import stage_graph
from stable_diffusion_webui_distributed_tpu_torch.pipeline import (
    precision as precision_mod,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline import stepcache
from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import (
    parse_controlnet_units,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationResult,
    apply_scripts,
    array_to_b64png,
    b64png_to_array,
    build_infotext,
    fix_seed,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import dtypes
from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    env_float,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.mesh import (
    across_processes,
)
from stable_diffusion_webui_distributed_tpu_torch.samplers import (
    kdiffusion as kd,
)
from stable_diffusion_webui_distributed_tpu_torch.serving.bucketer import (
    ShapeBucketer,
    ragged_enabled,
)
from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
    METRICS,
)

DEFAULT_COALESCE_WINDOW = 0.05

#: The chaos-injection seam (``sim/chaos.py``): consulted once per
#: submitted request, after the seeds are fixed and before admission, so a
#: plan's request counter advances on the serving path. None (the
#: default) costs one identity check.
CHAOS_HOOK = None


def _coalesce_window() -> float:
    return max(0.0, env_float("SDTPU_COALESCE_WINDOW",
                              DEFAULT_COALESCE_WINDOW))


class Ticket:
    """One queued request: original payload + bucketed execution copy."""

    def __init__(self, payload, run, job: str, bucketed: bool,
                 request_id: str) -> None:
        self.payload = payload          # user-visible metadata source
        self.run = run                  # execution payload (bucket dims)
        self.job = job
        self.bucketed = bucketed
        self.request_id = request_id
        self.fleet_class = ""           # resolved class name (fleet on)
        self.enqueued = time.monotonic()
        self.enqueued_perf = time.perf_counter()
        #: the request's trace (None outside one): the leader records
        #: queue waits and mirrored device spans into it
        self.obs_req = obs_spans.current()
        self.done = threading.Event()
        self.cancelled = threading.Event()
        self.result: Optional[GenerationResult] = None
        self.error: Optional[BaseException] = None
        #: the stage-graph executor's per-stage callback, called as
        #: ``on_stage(request_id, stage, seconds)`` after each of the
        #: group's encode, denoise, decode and merge stages; best-effort
        self.on_stage: Optional[Callable[[str, str, float], None]] = None


class _Group:
    def __init__(self, key) -> None:
        self.key = key
        self.tickets: List[Ticket] = []
        self.images = 0
        self.closed = False
        #: the execution's device time and UNet FLOPs for the perf ledger
        #: (``SDTPU_PERF``), host seconds where no event was recorded
        self.dev: Optional[obs_spans.DeviceTime] = None
        self.flops = 0.0
        self.t0 = 0.0


class ServingDispatcher:
    """Leader/follower coalescer in front of a single engine."""

    def __init__(self, engine, bucketer: Optional[ShapeBucketer] = None,
                 window: Optional[float] = None, pool=None) -> None:
        mesh = getattr(engine, "mesh", None)
        if mesh is not None and mesh.spans_processes:
            # rank 0 would have to hand every coalesced dispatch to the
            # others
            raise across_processes("the serving dispatcher")
        self.engine = engine
        # the warm pool (SDTPU_POOL): each leader or solo execution runs on
        # the resident it checks out (_checkout_engine); None: self.engine
        self.pool = pool
        self._exec_engine = threading.local()
        self.bucketer = bucketer or ShapeBucketer()
        self.window = _coalesce_window() if window is None \
            else max(0.0, float(window))
        self.max_batch = max(self.bucketer.batches)
        # _lock guards the grouping tables; _exec_lock serializes engine
        # execution. _exec_lock may be taken first and _lock nested inside
        # it, never the reverse.
        self._lock = threading.Lock()
        self._exec_lock = threading.Lock()
        self._groups: Dict[tuple, _Group] = {}  # guarded-by: _lock
        self._tickets: Dict[str, Ticket] = {}  # guarded-by: _lock
        # the fleet tier (SDTPU_FLEET): the execution lock becomes a
        # weighted-fair gate, with per-tenant quotas and ETA-SLO
        # admission. Off (the default), all three stay None and no fleet
        # branch runs.
        self.fleet: Optional[fleet_policy.FleetGate] = None
        self.quotas: Optional[fleet_quotas.QuotaLedger] = None
        self.admission: Optional[fleet_admission.AdmissionController] = None
        if fleet_policy.fleet_enabled():
            self.fleet = fleet_policy.FleetGate(
                fleet_policy.FleetPolicy.from_env())
            self.quotas = fleet_quotas.QuotaLedger.from_env()
            # inert until set_calibration attaches an ETA calibration
            self.admission = fleet_admission.AdmissionController()

    # -- public API --------------------------------------------------------

    def submit(self, payload, job: str = "txt2img") -> GenerationResult:
        """Execute ``payload`` (blocking) and return its result.

        Called concurrently from HTTP handler threads; compatible callers
        arriving within one coalesce window share a device batch. What the
        engine does not run raises here, before the request can join a
        group. With ``SDTPU_FLEET`` admission comes first (a refusal
        raises ``FleetRejected`` and feeds no metric); with
        ``SDTPU_CACHE`` the result cache answers next."""
        payload = apply_scripts(payload.model_copy())
        payload.seed = fix_seed(payload.seed)
        payload.subseed = fix_seed(payload.subseed)
        rid = str(getattr(payload, "request_id", "") or uuid.uuid4().hex)
        if CHAOS_HOOK is not None:
            CHAOS_HOOK("dispatcher.submit", payload=payload, rid=rid)
        # the request's trace: the HTTP server's, else one rooted here
        with obs_spans.maybe_request(rid, name=f"serve.{job}"):
            return self._submit(payload, job, rid)

    def _submit(self, payload, job: str, rid: str) -> GenerationResult:
        jr_on = obs_journal.enabled()
        if jr_on:
            # the post-fix_seed dump: the anchor a replay re-executes
            dump = payload.model_dump()
            obs_journal.emit("received", rid, job=job, payload=dump,
                             fingerprint=obs_journal.fingerprint(dump))
        fleet_class = ""
        if self.fleet is not None:
            # quota and SLO before any accounting: a refused request must
            # feed no queue wait, dispatch or calibration
            try:
                fleet_class = self._admit_fleet(payload)
            except fleet_admission.FleetRejected as e:
                if jr_on:
                    obs_journal.emit("throttled", rid, reason=e.reason,
                                     detail=str(e.detail))
                raise
            if jr_on:
                obs_journal.emit("admitted", rid, **{"class": fleet_class})
                degraded = (payload.override_settings
                            or {}).get("fleet_degraded")
                if degraded:
                    obs_journal.emit("degraded", rid, detail=str(degraded))
        if not cache.enabled():
            return self._run(payload, job, rid, fleet_class).result
        # the traced set's content joins the key (resolvable before its
        # adapters are applied); "" on the merged path, whose merges move
        # the model fingerprint's epoch
        key = cache.keys.result_key(
            payload, cache.keys.model_fingerprint(self.engine), job,
            lora=self.engine.traced_content_for_payload(payload))
        role, cached, flight = cache.result_acquire(key)
        if cached is not None:
            if jr_on:
                obs_journal.emit("result_dedupe_hit", rid, mode=role,
                                 key=key[:16])
                obs_journal.emit("completed", rid, images=len(cached.images),
                                 seeds=list(cached.seeds),
                                 infotexts=list(cached.infotexts))
            return cached.model_copy(deep=True)
        try:
            ticket = self._run(payload, job, rid, fleet_class)
            if self._cacheable(ticket):
                # the store keeps its own copy: the caller may change the
                # one it is handed
                cache.result_publish(key, flight,
                                     ticket.result.model_copy(deep=True))
                flight = None
            return ticket.result
        finally:
            if flight is not None:
                # failed, cancelled or partial: the followers elect again
                cache.result_abandon(key, flight)

    def _run(self, payload, job: str, rid: str,
             fleet_class: str = "") -> Ticket:
        """Bucket, group and run one admitted request; its ticket holds
        the result. Raises the request's error."""
        bypass = bool(payload.init_images or payload.enable_hr)
        if bypass:
            run, bucketed = payload.model_copy(), False
            METRICS.record_request(False, bypassed=True)
        else:
            ragged = ragged_enabled() and self._ragged_eligible(payload)
            run, bucketed = self.bucketer.bucket_payload(payload,
                                                         ragged=ragged)
            # batch-ladder padding folds into the ratio only for work that
            # pads ALONE up the ladder; coalescable rows fill via merging
            solo_batch = None if self._coalescable(run) \
                else payload.total_images
            METRICS.record_request(
                bucketed, padding_ratio=self.bucketer.padding_ratio(
                    payload.width, payload.height, batch=solo_batch))
        jr_on = obs_journal.enabled()
        if jr_on:
            obs_journal.emit("bucketed", rid, bucketed=bucketed,
                             bypassed=bypass,
                             bucket=f"{run.width}x{run.height}")

        ticket = Ticket(payload, run, job, bucketed, rid)
        ticket.fleet_class = fleet_class
        with self._lock:
            self._tickets[rid] = ticket
        try:
            if self._coalescable(run):
                self._run_grouped(ticket)
            else:
                self._run_solo(ticket)
        finally:
            with self._lock:
                self._tickets.pop(rid, None)
        if ticket.error is not None:
            if jr_on:
                err = ticket.error
                obs_journal.emit("failed", rid,
                                 error=f"{type(err).__name__}: {err}")
            raise ticket.error
        if jr_on:
            r = ticket.result
            obs_journal.emit("completed", rid,
                             images=len(r.images) if r else 0,
                             seeds=list(r.seeds) if r else [],
                             infotexts=list(r.infotexts) if r else [])
        return ticket

    @staticmethod
    def _cacheable(ticket: Ticket) -> bool:
        """Only a complete result enters the result cache: a cancelled or
        interrupted run returns fewer images than its payload asked for."""
        r = ticket.result
        return (r is not None and not ticket.cancelled.is_set()
                and len(r.images) == ticket.payload.total_images)

    def cancel(self, request_id: str) -> bool:
        """Cancel ONE queued or running request; its images are dropped at
        split time and co-batched requests are untouched."""
        with self._lock:
            t = self._tickets.get(str(request_id))
        if t is None:
            return False
        t.cancelled.set()
        obs_spans.mark(t.obs_req, "interrupted", "cancelled by client")
        return True

    # -- the fleet tier ----------------------------------------------------

    def eta_overhead(self, payload=None) -> Dict[str, float]:
        """The serving layer's terms of ``scheduler.eta.predict_eta``: the
        expected queue wait (the observed mean, at least half the coalesce
        window) and the padding overhead of this payload's bucket."""
        wait = METRICS.avg_queue_wait() or (self.window / 2.0)
        if payload is not None:
            pad = self.bucketer.padding_ratio(payload.width, payload.height)
        else:
            pad = METRICS.avg_padding_ratio()
        return {"queue_wait": wait, "padding_overhead": pad}

    def set_calibration(self, cal, benchmark=None) -> None:
        """Attach an ETA calibration (``scheduler/eta.py``) so SLO
        admission can predict completion times; without one every request
        is accepted untouched."""
        if self.admission is not None:
            self.admission.calibration = cal
            self.admission.benchmark = benchmark

    def fleet_summary(self) -> Optional[Dict[str, object]]:
        """The fleet's live state; None with the fleet off."""
        if self.fleet is None:
            return None
        out = self.fleet.summary()
        if self.quotas is not None:
            out["quotas"] = self.quotas.summary()
        if self.admission is not None:
            cal = self.admission.calibration
            out["admission"] = {
                "calibrated": bool(cal is not None and cal.benchmarked),
                "fewstep": self.admission.fewstep,
            }
        return out

    def _admit_fleet(self, payload) -> str:
        """Quota, then the ETA-SLO verdict: returns the resolved class
        name, changes the payload on degrade (step-cache cadence, few-step
        budget, int8), raises ``FleetRejected`` on refusal."""
        pol = self.fleet.policy.resolve(payload.priority_class)
        slo = float(getattr(payload, "slo_s", 0.0) or 0.0)
        if slo > 0:  # a request's own SLO overrides the class default
            pol = dataclasses.replace(pol, slo_s=slo)
        tenant = str(getattr(payload, "tenant", "") or "default")
        obs_prom.fleet_count("requests", tenant=tenant,
                             **{"class": pol.name})
        metered = 0
        if self.quotas is not None and self.quotas.enabled:
            retry = self.quotas.admit(tenant, payload.total_images)
            if retry is not None:
                obs_prom.fleet_count("quota_throttles", tenant=tenant)
                raise fleet_admission.FleetRejected(
                    "quota", f"tenant {tenant!r} image quota exhausted",
                    retry_after=retry)
            metered = payload.total_images
        decision = self.admission.decide(payload, pol,
                                         self.eta_overhead(payload))
        obs_prom.fleet_count("admissions", decision=decision.action,
                             **{"class": pol.name})
        if decision.action == "reject":
            if metered:
                # the withdrawal preceded the verdict; a refused request
                # did no work, so its tokens go back
                self.quotas.refund(tenant, metered)
            raise fleet_admission.FleetRejected(
                "slo", decision.detail,
                retry_after=max(1.0, (decision.predicted_s or 0.0)
                                - (decision.slo_s or 0.0)))
        if decision.action == "degrade":
            ov = dict(payload.override_settings or {})
            ov.update(decision.overrides)
            # a marker the engine ignores; it rides into the result's
            # parameters
            ov["fleet_degraded"] = decision.detail
            payload.override_settings = ov
            if decision.steps:
                payload.steps = decision.steps
        return pol.name

    def _engine(self):
        """The engine this thread executes on: the resident checked out
        for the current leader or solo execution, else the primary."""
        return getattr(self._exec_engine, "engine", None) or self.engine

    @contextlib.contextmanager
    def _checkout_engine(self):
        """Borrow a pool resident for one execution (``SDTPU_POOL`` with a
        pool attached; else the primary engine). The resident rides a
        thread-local, so the device section on this thread resolves to it
        through :meth:`_engine`."""
        if self.pool is None or not fleet_pool.enabled():
            yield self.engine
            return
        res = self.pool.acquire()
        self._exec_engine.engine = res.engine
        try:
            yield res.engine
        finally:
            self._exec_engine.engine = None
            self.pool.release(res)

    @contextlib.contextmanager
    def _device(self, tickets: List[Ticket], images: int):
        """The execution's critical section. Fleet off: the plain
        execution lock. Fleet on: a gate entry per dispatch, with the
        chunk-boundary preempt hook on the engine when the work is
        preemptible and preempt-safe."""
        if self.fleet is None:
            with self._exec_lock:
                yield
            return
        gate = self.fleet
        with self._lock:
            tickets = list(tickets)  # a group's list grows until it closes
        lead = tickets[0]
        pol = gate.policy.resolve(lead.fleet_class)
        for t in tickets[1:]:
            p = gate.policy.resolve(t.fleet_class)
            if p.weight > pol.weight:
                pol = p  # a mixed group runs at its strongest class
        entry = fleet_policy.GateEntry(
            pol, tenant=str(getattr(lead.payload, "tenant", "")
                            or "default"),
            cost=max(1, images), request_id=lead.request_id)
        gate.acquire(entry)
        engine = self._engine()
        prev = engine.preempt_hook
        hooked = False
        try:
            if pol.preemptible \
                    and all(self._preempt_safe(t.run) for t in tickets):
                # prev saved and restored: a preemptible interloper that
                # runs during an outer job's yield cannot clear its hook
                engine.preempt_hook = fleet_policy.EnginePreemptHook(
                    gate, entry, engine.device_runner)
                hooked = True
            yield
        finally:
            if hooked:
                engine.preempt_hook = prev
            gate.release(entry)

    def _preempt_safe(self, p) -> bool:
        """May this payload yield mid-denoise? Not with MERGED adapters
        (an interloper's tagless run would restore the pristine weights
        under it); a traced set rides as per-run graph inputs and survives
        an interloper. DPM adaptive runs a loop without the hook."""
        if "<lora:" in (p.prompt or "") and self._traced_rowspec(p) is None:
            return False
        return not kd.resolve_sampler(p.sampler_name).adaptive

    def _observe_wait(self, ticket: Ticket, wait: float,
                      start_perf: float) -> None:
        """A dispatched request's queue wait: the dispatcher's mean, the
        queue-wait histogram, with the fleet on its class's histogram (the
        autoscale signal), and its trace's ``queue_wait`` interval (up to
        ``start_perf``)."""
        METRICS.record_queue_wait(wait)
        obs_prom.observe_hist("queue_wait", wait)
        if self.fleet is not None:
            obs_prom.fleet_observe_queue_wait(
                self.fleet.policy.resolve(ticket.fleet_class).name, wait)
        obs_spans.add_span(ticket.obs_req, "queue_wait",
                           ticket.enqueued_perf,
                           start_perf - ticket.enqueued_perf)

    def _dispatch_eta(self, run, batch_size: int) -> Optional[float]:
        """The predicted seconds of an execution for the hang watchdog:
        the admission controller's calibrated ETA, or None (nothing to
        watch against) without one or with the watchdog off."""
        if not obs_watchdog.enabled() or self.admission is None:
            return None
        cal = getattr(self.admission, "calibration", None)
        if cal is None or not getattr(cal, "benchmarked", False):
            return None
        from stable_diffusion_webui_distributed_tpu_torch.scheduler import (
            eta as eta_mod,
        )

        try:
            return eta_mod.predict_eta(
                cal, run, getattr(self.admission, "benchmark", None),
                batch_size=batch_size, precision=self._precision_name(run))
        except (ValueError, TypeError):
            return None

    @contextlib.contextmanager
    def _device_span(self, g: _Group, requests: int, precision: str,
                     lora_cell: Dict[str, str]):
        """An execution's ``dispatch.device`` span and watchdog, and with
        ``SDTPU_PERF`` its device-time sink (``g.dev``); yields the span
        (None outside a trace)."""
        g.dev = obs_spans.DeviceTime() if obs_perf.enabled() else None
        g.t0 = time.perf_counter()
        lead = g.tickets[0]
        wd = obs_watchdog.arm(lead.request_id, "dispatch.device",
                              self._dispatch_eta(lead.run, g.images))
        try:
            with obs_spans.device_sink(g.dev), \
                    obs_spans.span("dispatch.device", device=True,
                                   requests=requests, precision=precision,
                                   **lora_cell) as dsp:
                yield dsp
        finally:
            obs_watchdog.disarm(wd)

    # -- grouping ----------------------------------------------------------

    def _traced_rowspec(self, p):
        """The traced-LoRA cell of a payload: ``(0, 0)`` without tags, the
        ``(rank_bucket, slots)`` of its traced set when
        ``SDTPU_LORA_TRACED`` serves its tags, None when they take the
        merged path (the gate off, DPM adaptive, a set past the
        ladders)."""
        if "<lora:" not in (p.prompt or ""):
            return (0, 0)
        if not lora_mod.traced_enabled():
            return None
        _, tags = lora_mod.extract_lora_tags(p.prompt or "")
        if not tags:
            return (0, 0)
        if kd.resolve_sampler(p.sampler_name).adaptive:
            return None
        ts = self.engine._traced_set_for(tuple(tags))
        return None if ts is None else (ts.rank_bucket, ts.slots)

    def _coalescable(self, p) -> bool:
        """May this payload share a batch, and run ragged under
        SDTPU_RAGGED? DPM adaptive runs solo: its step controller reads one
        error over the whole batch, so a batch mate would change its
        image. Merged LoRA adapters, ControlNet units and an inpainting
        family's extra channels ride no coalesced batch, as in the JAX
        package."""
        if p.init_images or p.enable_hr or p.all_prompts:
            return False
        if p.refiner_checkpoint and p.refiner_switch_at < 1.0:
            return False
        if "<lora:" in (p.prompt or "") and self._traced_rowspec(p) is None:
            return False
        if kd.resolve_sampler(p.sampler_name).adaptive:
            return False
        if parse_controlnet_units(p):
            return False
        if self.engine.family.inpaint:
            return False
        return p.total_images <= self.max_batch

    def _ragged_eligible(self, p) -> bool:
        """May this payload run ragged (SDTPU_RAGGED)? A coalescable one
        without an active step cache: the deep feature's rows assume the
        dense layout, so a request with a cadence or a cutoff keeps its
        classic bucket."""
        if stepcache.resolve(p).active:
            return False
        return self._coalescable(p)

    def _precision_name(self, run) -> str:
        """A request's resolved serving precision: the group key's last
        axis and the dispatch mix's label."""
        # self may be None (the tests call _group_key unbound) or hold no
        # engine: the bf16 default either way
        policy = getattr(getattr(self, "engine", None), "policy", None)
        return precision_mod.resolve(run, policy).name

    def _group_key(self, run) -> tuple:
        # The JAX package's axes in its order. The step cache's cadence
        # and cutoff join: a group runs one denoise loop. The ragged
        # marker joins as a bool, NOT the true shape: shapes of one bucket
        # coalescing is the point, but a ragged and a classic request at
        # the same bucket run different denoise loops. The traced-LoRA
        # cell is key[-3:-1] ((0, 0) without tags; the adapter names never
        # enter the key) and the resolved precision the last axis: int8
        # and bf16 requests never share a batch.
        sc = stepcache.resolve(run)
        rs = ServingDispatcher._traced_rowspec(self, run) or (0, 0)
        return ("txt2img", run.sampler_name, int(run.steps),
                int(run.width), int(run.height), float(run.cfg_scale),
                run.negative_prompt or "", int(run.clip_skip or 0),
                sc.cadence, sc.cutoff_sigma,
                bool((run.override_settings or {}).get("ragged_true_wh")),
                int(rs[0]), int(rs[1]),
                ServingDispatcher._precision_name(self, run))

    def _run_grouped(self, ticket: Ticket) -> None:
        key = self._group_key(ticket.run)
        n = ticket.run.total_images
        with self._lock:
            g = self._groups.get(key)
            if g is None or g.closed or g.images + n > self.max_batch:
                g = _Group(key)
                self._groups[key] = g
                leader = True
            else:
                leader = False
            g.tickets.append(ticket)
            g.images += n
            leader_rid = g.tickets[0].request_id
        if obs_journal.enabled():
            # a follower's outcome depends on its leader's batch
            obs_journal.emit(
                "coalesced_leader" if leader else "coalesced_follower",
                ticket.request_id, images=n, leader_request_id=leader_rid)
        if not leader:
            ticket.done.wait()
            return
        if self.window > 0:
            time.sleep(self.window)
        with self._checkout_engine():
            self._run_grouped_leader(g, key)

    def _run_grouped_leader(self, g: _Group, key) -> None:
        """The leader's execution: the device section and, under the
        stage-graph executor, the merge after the gate is released, both
        on this thread and on the engine :meth:`_checkout_engine`
        resolved."""
        finalize = None
        with self._device(g.tickets, g.images):
            # close AFTER taking the engine: followers kept joining while a
            # previous batch held the device (continuous batching)
            with self._lock:
                g.closed = True
                if self._groups.get(key) is g:
                    self._groups.pop(key)
            start = time.monotonic()
            start_perf = time.perf_counter()
            leader_req = obs_spans.current()
            jr_on = obs_journal.enabled()
            lora_cell = self._lora_cell(g.key[-3:-1])
            for t in g.tickets:
                if t.cancelled.is_set():
                    continue
                self._observe_wait(t, start - t.enqueued, start_perf)
                if jr_on:
                    obs_journal.emit("dispatched", t.request_id,
                                     group=len(g.tickets),
                                     precision=str(g.key[-1]), **lora_cell)
            engine = self._engine()
            dsp = None
            try:
                with self._device_span(g, len(g.tickets), g.key[-1],
                                       lora_cell) as dsp:
                    # the engine's own thread: cuBLAS and cuDNN state is
                    # per thread, and a fresh thread may give other bits
                    if stage_graph.enabled():
                        # encode, denoise and decode queued under the
                        # gate; the returned merge runs after its release,
                        # so the next group's stages overlap it
                        finalize = engine.run_on_device(
                            self._execute_group_staged, g, engine)
                    else:
                        engine.run_on_device(self._execute_group, g, engine)
            except BaseException as e:  # noqa: BLE001 — delivered per ticket
                finalize = None
                self._fail_group(g, e)
            finally:
                if finalize is None:
                    self._finish_group(g, dsp, leader_req)
        if finalize is not None:
            # tickets complete only once their images exist
            try:
                finalize()
            except BaseException as e:  # noqa: BLE001 — delivered per ticket
                self._fail_group(g, e)
            finally:
                self._finish_group(g, dsp, leader_req)

    @staticmethod
    def _fail_group(g: _Group, error: BaseException) -> None:
        for t in g.tickets:
            if t.error is None and t.result is None:
                t.error = error

    def _finish_group(self, g: _Group, dsp=None, leader_req=None) -> None:
        """A group's end: the leader's device span mirrored into each
        follower's trace (where its wall time went), each ticket's SLO
        sample, and every ticket released."""
        if dsp is not None and leader_req is not None:
            for t in g.tickets:
                if t.obs_req is not None and t.obs_req is not leader_req:
                    obs_spans.mirror_span(
                        t.obs_req, "coalesced.dispatch", dsp,
                        leader_request_id=leader_req.request_id,
                        leader_span_id=dsp.span_id)
        for t in g.tickets:
            self._record_slo(t)
            t.done.set()

    def _record_slo(self, ticket: Ticket) -> None:
        """The perf ledger's per-(tenant, class) SLO sample of a finished
        request (fleet and ``SDTPU_PERF`` on); never raises."""
        if self.fleet is None or not obs_perf.enabled():
            return
        try:
            if ticket.cancelled.is_set():
                return  # never dispatched or abandoned: no SLO sample
            pol = self.fleet.policy.resolve(ticket.fleet_class)
            slo = float(getattr(ticket.payload, "slo_s", 0.0) or 0.0) \
                or float(pol.slo_s or 0.0)
            if slo <= 0:
                return  # a class without a target: nothing to meet
            obs_perf.LEDGER.record_slo(
                tenant=str(getattr(ticket.payload, "tenant", "")
                           or "default"),
                cls=pol.name, slo_s=slo,
                latency_s=time.monotonic() - ticket.enqueued,
                ok=ticket.error is None)
        except Exception:  # noqa: BLE001 — observability stays best-effort
            pass

    @staticmethod
    def _device_seconds(g: _Group) -> float:
        """An execution's device seconds: its CUDA events (resolved, the
        group's decode having been waited for), else the host seconds
        since it started (the CPU, where every call has run when it
        returns)."""
        ms = g.dev.ms() if g.dev is not None else None
        if ms is not None:
            return ms / 1e3
        return time.perf_counter() - g.t0

    @staticmethod
    def _lora_cell(cell) -> Dict[str, str]:
        """The traced-LoRA cell as the journal's ``lora`` attribute; none
        for a tagless request, so its events carry the JAX package's
        fields."""
        rb, sc = int(cell[0]), int(cell[1])
        return {"lora": f"r{rb}s{sc}"} if (rb or sc) else {}

    def _run_solo(self, ticket: Ticket) -> None:
        with self._checkout_engine():
            self._run_solo_inner(ticket)

    def _run_solo_inner(self, ticket: Ticket) -> None:
        engine = self._engine()
        with self._device([ticket], ticket.run.total_images):
            try:
                engine.state.begin_request()
                if ticket.cancelled.is_set():
                    ticket.result = self._empty_result(ticket)
                    return
                self._observe_wait(ticket,
                                   time.monotonic() - ticket.enqueued,
                                   time.perf_counter())
                prec = self._precision_name(ticket.run)
                METRICS.record_dispatch(1, precision=prec)
                obs_prom.count_precision(prec, 1)
                rs = self._traced_rowspec(ticket.run) or (0, 0)
                lora_cell = self._lora_cell(rs)
                if obs_journal.enabled():
                    obs_journal.emit("dispatched", ticket.request_id,
                                     group=1, precision=prec, **lora_cell)

                def generate():
                    # the cache notes are the device thread's: drained
                    # there, always, so none leaks into the next request
                    try:
                        return engine.generate_range(ticket.run, 0, None,
                                                     ticket.job)
                    finally:
                        self._drain_cache_notes(ticket.request_id)

                g = _Group(None)
                g.tickets.append(ticket)
                g.images = ticket.run.total_images
                flops0 = METRICS.unet_flops_snapshot()
                with self._device_span(g, 1, prec, lora_cell):
                    result = engine.run_on_device(generate)
                if obs_perf.enabled():
                    # the range returned after waiting for its last
                    # decode: its device time is resolvable
                    self._record_solo_perf(engine, ticket, g, prec,
                                           lora_cell, flops0)
                elif obs_tsdb.enabled():
                    # the watermark still lands in the TSDB's series
                    obs_tsdb.dispatch_memory_sample()
                if ticket.bucketed:
                    result = self._restore_solo(result, ticket)
                ticket.result = result
            except BaseException as e:  # noqa: BLE001 — raised by submit
                ticket.error = e
            finally:
                self._record_slo(ticket)
                ticket.done.set()

    def _record_solo_perf(self, engine, ticket: Ticket, g: _Group,
                          prec: str, lora_cell: Dict[str, str],
                          flops0: float) -> None:
        """The perf ledger's record of a solo execution (the JAX
        package's attribution: a remainder group pads up to the group size,
        a ragged bucket's tail rows are masked)."""
        run = ticket.run
        n_img = run.total_images
        group = max(1, run.group_size or run.batch_size)
        full, rem = divmod(n_img, group)
        n_run = (full + (1 if rem else 0)) * group
        masked_px = 0
        wh = engine._ragged_plan(run)
        if wh is not None:
            f = engine.family.vae_scale_factor
            lat_h = run.height // f
            tr = min(lat_h, -(-wh[1] // f))
            masked_px = (lat_h - tr) * f * run.width * n_run
        try:
            tok_t, tok_p = engine.request_token_stats(run)
        except Exception:  # noqa: BLE001 — telemetry stays passive
            tok_t = tok_p = 0
        obs_perf.LEDGER.record_dispatch(
            bucket=f"{run.width}x{run.height}",
            cadence=int(stepcache.resolve(run).cadence), precision=prec,
            lora=lora_cell.get("lora", ""),
            device_s=self._device_seconds(g),
            flops=METRICS.unet_flops_snapshot() - flops0,
            requests=1, batch_raw=n_img, batch_run=n_run,
            true_pixels=ticket.payload.width * ticket.payload.height * n_img,
            padded_pixels=run.width * run.height * n_run,
            masked_pixels=masked_px, true_tokens=tok_t, padded_tokens=tok_p,
            hbm=obs_tsdb.dispatch_memory_sample())

    # -- merged execution (on the engine's device thread) --------------------

    def _execute_group(self, g: _Group, engine) -> None:
        """The serial group: the four stages back to back on the device
        thread."""
        built = self._group_build_inputs(g, engine)
        if built is None:
            return
        latents = self._group_denoise(g, built, engine)
        decoded = self._group_decode(g, built, latents, engine)
        self._group_merge(g, built, decoded, engine)

    def _execute_group_staged(self, g: _Group, engine):
        """The stage-graph group (``SDTPU_STAGE_GRAPH``, the JAX package's
        ``_execute_group_staged``): the same four stages as
        :class:`~..parallel.stage_graph.StageGraph` nodes. Encode, the
        asynchronous denoise and the decode dispatch run now, on the
        device thread under the gate the caller holds; the returned
        finalize (the wait on the decode's event and the merge) runs on
        the leader's thread after the gate is released. Each stage's end
        fans out to every ticket's ``on_stage``."""
        leader_rid = g.tickets[0].request_id
        graph = stage_graph.StageGraph(
            label=f"group[{leader_rid}]", group=leader_rid,
            clock=stage_graph.CLOCK, on_stage=self._stage_notifier(g))
        # None flows through when every ticket was cancelled before the
        # dispatch: the later stages do nothing, as the serial path returns
        graph.add("encode", lambda: self._group_build_inputs(g, engine),
                  kind="stage")
        graph.add("denoise",
                  lambda built: None if built is None
                  else self._group_denoise(g, built, engine, sync=False),
                  deps=("encode",), kind="denoise")
        graph.add("decode",
                  lambda built, latents: None if built is None
                  else self._group_decode(g, built, latents, engine),
                  deps=("encode", "denoise"), kind="stage")
        graph.add("merge",
                  lambda built, decoded: None if built is None
                  else self._group_merge(g, built, decoded, engine),
                  deps=("encode", "decode"), kind="stage")
        graph.run(until="decode")

        def finalize() -> None:
            try:
                graph.run()  # the merge waits for the decode's event
            finally:
                # the images exist (or failed): the group's device work is
                # over, its denoise window closes
                graph.close_denoise()
                if obs_perf.enabled():
                    rb, sc = int(g.key[-3]), int(g.key[-2])
                    obs_perf.LEDGER.record_stages(
                        bucket=f"{int(g.key[3])}x{int(g.key[4])}",
                        cadence=int(g.key[8]), precision=str(g.key[-1]),
                        lora=f"r{rb}s{sc}" if (rb or sc) else "",
                        stage_s=graph.stage_seconds(),
                        overlap_s=graph.stage_overlap())

        return finalize

    @staticmethod
    def _stage_notifier(g: _Group):
        """Each finished stage calls every ticket's ``on_stage(request_id,
        stage, seconds)``; a callback's error never fails the group."""
        def notify(stage: str, seconds: float) -> None:
            for t in g.tickets:
                cb = t.on_stage
                if cb is not None:
                    try:
                        cb(t.request_id, stage, seconds)
                    except Exception:  # noqa: BLE001 — callback isolation
                        pass

        return notify

    @staticmethod
    def _drain_cache_notes(rid: str, *, embed: bool = True,
                           prefix: bool = True) -> None:
        """Journal the caching tier's activity for ``rid``: the engine
        notes embed hits and prefix resumes per thread, on the device
        thread; this drains them there, always (so no note leaks into the
        next request), and emits ``embed_cache_hit`` / ``prefix_resumed``
        only with the journal on."""
        if not cache.enabled():
            return
        jr_on = obs_journal.enabled()
        if embed:
            pos_hits, neg_hits = cache.embed_layer.take_request_hits()
            if jr_on and (pos_hits or neg_hits):
                obs_journal.emit("embed_cache_hit", rid, positive=pos_hits,
                                 negative=neg_hits)
        if prefix:
            note = cache.prefix_layer.take_resume_note()
            if jr_on and note:
                obs_journal.emit("prefix_resumed", rid, **note)

    def _group_denoise(self, g: _Group, built: Dict, engine,
                       sync: bool = True) -> torch.Tensor:
        """Denoise stage: the group's one denoise range; ``sync=False``
        returns as soon as its chunks are queued. The UNet FLOPs the engine
        priced for it go to the group's perf record."""
        flops0 = METRICS.unet_flops_snapshot()
        latents = engine._denoise(built["rp"], built["x"], built["keys"],
                                  built["ctx"], built["pooled"], "txt2img",
                                  ragged=built["ragged"], lora=built["lora"],
                                  sync=sync)
        g.flops = METRICS.unet_flops_snapshot() - flops0
        self._drain_cache_notes(built["live"][0].request_id, embed=False)
        return latents

    @staticmethod
    def _group_decode(g: _Group, built: Dict, latents: torch.Tensor,
                      engine):
        """Decode stage: the decode dispatched into pinned host memory
        behind an event; nothing waits here."""
        return engine._queue_decoded(latents, 0, built["b_raw"],
                                     built["width"], built["height"])

    def _group_build_inputs(self, g: _Group,
                            engine=None) -> Optional[Dict]:
        """Cancellation filter, per-ticket prompt encodes and noise draws,
        batch concat and pad-and-drop on ``engine`` (the group's checked-out
        resident; the primary engine by default). Returns the denoise and
        merge inputs, or None when no ticket is still live."""
        engine = engine or self.engine
        live = [t for t in g.tickets if not t.cancelled.is_set()]
        for t in g.tickets:
            if t not in live:
                t.result = self._empty_result(t)
        if not live:
            return None
        METRICS.record_dispatch(len(live), precision=g.key[-1])
        obs_prom.count_precision(g.key[-1], len(live))
        perf_on = obs_perf.enabled()
        true_tok = padded_tok = 0

        rp = live[0].run.model_copy()
        width, height = rp.width, rp.height
        h, w = engine._latent_hw(width, height)
        C = engine.family.vae.latent_channels
        spec = kd.resolve_sampler(rp.sampler_name)
        sigma0 = kd.build_sigmas(spec, engine.schedule, rp.steps)[0]
        engine.state.begin_request()
        # undoes any merge; a traced group's sets are installed per member
        engine._apply_prompt_loras(rp)
        traced = g.key[-3:-1] != (0, 0)
        row_sets: List[lora_mod.TracedSet] = []

        # context length pinned to the group max so every merged request
        # pads its conditioning identically
        chunks = max(engine.request_context_chunks(t.run) for t in live)
        # ragged group (a _group_key axis, uniform across the group): noise
        # is drawn at each request's TRUE latent rows and zero-padded to the
        # bucket, and the per-row lengths ride into the denoise as vectors
        ragged_mode = engine._ragged_plan(rp) is not None
        counts, noise_parts, key_parts, ctx_rows = [], [], [], []
        pooled_rows = []
        uncond = []  # each member's (ctx_u, pooled_u, images)
        lengths: List[List[int]] = [[], [], []]  # rows, ctx_true_u, _c
        for t in live:
            p = t.run.model_copy()
            p.context_chunks = chunks
            n_p = p.total_images
            counts.append(n_p)
            if traced:
                # this member's set, before its encode: its text-encoder
                # factors apply to its own conditioning
                _, tags = lora_mod.extract_lora_tags(p.prompt or "")
                ts = engine._traced_set_for(tuple(tags))
                if ts is None:
                    raise RuntimeError(f"traced LoRA set for {tags!r} no "
                                       f"longer resolvable at dispatch")
                engine._traced_lora = ts
                row_sets += [ts] * n_p
            rows = h
            if ragged_mode:
                rows = engine._true_latent_rows(h, engine._ragged_plan(p)[1])
                (cu, cc), (pu, pc), ctx_true = engine.encode_prompts(
                    p, ragged=True)
                for vec, n in zip(lengths, (rows, *ctx_true)):
                    vec += [n] * n_p
            else:
                (cu, cc), (pu, pc) = engine.encode_prompts(p)
            noise_parts.append(engine._init_noise(p, 0, n_p, (h, w, C),
                                                  rows))
            if perf_on:
                try:
                    tt, pt = engine.request_token_stats(p, chunks=chunks)
                    true_tok += tt
                    padded_tok += pt
                except Exception:  # noqa: BLE001 — telemetry stays passive
                    pass
            key_parts.append(engine._image_keys(p, 0, n_p))
            self._drain_cache_notes(t.request_id, prefix=False)
            ctx_rows.append(cc.expand(n_p, -1, -1))
            pooled_rows.append(pc.expand(n_p, -1))
            uncond.append((cu, pu, n_p))

        b_raw = sum(counts)
        b_run = self.bucketer.bucket_batch(b_raw)
        noise = torch.cat(noise_parts)
        keys = torch.cat(key_parts)
        ctx_c = torch.cat(ctx_rows)
        pooled_c = torch.cat(pooled_rows)
        # the negative prompt is a group-key axis, so one encode serves
        # every row; but each traced member encoded it through its own
        # text-encoder factors, so there each row keeps its member's
        ctx_u, pooled_u = uncond[0][:2]
        if traced:
            ctx_u = torch.cat([u.expand(n, -1, -1) for u, _, n in uncond])
            pooled_u = torch.cat([p.expand(n, -1) for _, p, n in uncond])
        if b_run > b_raw:
            # pad-and-drop up to the batch bucket: the extra rows repeat
            # the last image and are discarded after decode
            pad = b_run - b_raw

            def _pad(a):
                return torch.cat([a, a[-1:].expand(pad, *a.shape[1:])])

            noise, keys, ctx_c = _pad(noise), _pad(keys), _pad(ctx_c)
            pooled_c = _pad(pooled_c)
            if traced:
                ctx_u, pooled_u = _pad(ctx_u), _pad(pooled_u)
        ragged = None
        if ragged_mode:
            ragged = tuple(dtypes.to_device(
                torch.tensor(vec, dtype=torch.int32), engine.device)
                for vec in lengths)
            if b_run > b_raw:
                ragged = tuple(_pad(vec) for vec in ragged)
        # each row's factors; the pad rows repeat the last member's set
        lora = (lora_mod.stack_row_sets(row_sets, b_run)["unet"]
                if traced else None)
        return {"live": live, "counts": counts, "rp": rp, "width": width,
                "height": height,
                "x": engine._place_batch(noise * sigma0), "keys": keys,
                "ctx": (ctx_u, ctx_c), "pooled": (pooled_u, pooled_c),
                "ragged": ragged, "lora": lora,
                "ragged_mode": ragged_mode, "b_raw": b_raw, "b_run": b_run,
                "true_rows": lengths[0], "h": h,
                "true_tok": true_tok, "padded_tok": padded_tok}

    def _group_merge(self, g: _Group, built: Dict, decoded,
                     engine) -> None:
        """Merge stage: wait for the decoded images, then split the batch
        back into per-ticket results: bucket crops (top-aligned for ragged
        rows) and per-image seeds and infotext of each original payload.
        Host work only: it needs nothing of the device thread."""
        imgs = decoded.pixels()
        live = built["live"]
        if obs_perf.enabled():
            # the decode's event has completed: so has every event of the
            # group, on the same stream before it
            self._record_group_perf(g, built)
        elif obs_tsdb.enabled():
            # the watermark still lands in the TSDB's series
            obs_tsdb.dispatch_memory_sample()
        jr_on = obs_journal.enabled()
        if jr_on:
            obs_journal.emit("decoded", live[0].request_id,
                             images=built["b_raw"],
                             batch_run=built["x"].shape[0])
        crop = self.bucketer.crop_ragged if built["ragged_mode"] \
            else self.bucketer.crop
        with obs_spans.span("merge.split", requests=len(live),
                            images=built["b_raw"]):
            off = 0
            for t, n_p in zip(built["live"], built["counts"]):
                rows = imgs[off:off + n_p]
                off += n_p
                if t.cancelled.is_set():
                    t.result = self._empty_result(t)
                    continue
                out = GenerationResult(parameters=t.payload.model_dump())
                ow, oh = t.payload.width, t.payload.height
                if t.bucketed:
                    rows = np.stack([crop(im, ow, oh) for im in rows])
                engine._append_images(out, t.payload, rows, 0, ow, oh)
                t.result = out
                if jr_on:
                    obs_journal.emit("merged", t.request_id, images=n_p)

    def _record_group_perf(self, g: _Group, built: Dict) -> None:
        """The perf ledger's record of a coalesced group, once its images
        exist."""
        live, counts = built["live"], built["counts"]
        width, height = built["width"], built["height"]
        b_run = built["b_run"]
        masked_px = 0
        if built["ragged_mode"]:
            f = height // built["h"]
            true_rows = list(built["true_rows"])
            true_rows += [true_rows[-1]] * (b_run - len(true_rows))
            masked_px = (built["h"] * b_run - sum(true_rows)) * f * width
        rb, sc = int(g.key[-3]), int(g.key[-2])
        obs_perf.LEDGER.record_dispatch(
            bucket=f"{width}x{height}", cadence=int(g.key[8]),
            precision=str(g.key[-1]),
            lora=f"r{rb}s{sc}" if (rb or sc) else "",
            device_s=self._device_seconds(g), flops=g.flops,
            requests=len(live), batch_raw=built["b_raw"], batch_run=b_run,
            true_pixels=sum(t.payload.width * t.payload.height * n_p
                            for t, n_p in zip(live, counts)),
            padded_pixels=width * height * b_run, masked_pixels=masked_px,
            true_tokens=built["true_tok"], padded_tokens=built["padded_tok"],
            hbm=obs_tsdb.dispatch_memory_sample())

    # -- result fix-up -----------------------------------------------------

    @staticmethod
    def _empty_result(ticket: Ticket) -> GenerationResult:
        params = ticket.payload.model_dump()
        params["cancelled"] = True
        return GenerationResult(parameters=params)

    def _restore_solo(self, result: GenerationResult,
                      ticket: Ticket) -> GenerationResult:
        """Crop a bucketed solo run back to the requested size and rebuild
        infotext from the ORIGINAL payload so user-visible metadata shows
        the requested dimensions."""
        orig = ticket.payload
        bw, bh = ticket.run.width, ticket.run.height
        crop = self.bucketer.crop_ragged \
            if self.engine._ragged_plan(ticket.run) is not None \
            else self.bucketer.crop
        for i, b64 in enumerate(result.images):
            arr = b64png_to_array(b64)
            if arr.shape[:2] != (bh, bw):
                continue
            result.images[i] = array_to_b64png(
                crop(arr, orig.width, orig.height))
            result.infotexts[i] = build_infotext(
                orig, int(result.seeds[i]), int(result.subseeds[i]),
                self.engine.model_name, orig.width, orig.height)
        return result
