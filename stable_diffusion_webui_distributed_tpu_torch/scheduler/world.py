"""World: the multi-backend job planner and request orchestrator.

A copy of the JAX package's ``scheduler/world.py``, the reference's
scheduler policy: an equal split, stall detection against the fastest
backend, deferral of stalling backends, round-robin redistribution of the
deferred and remainder images under pixel caps, complementary "bonus"
production in slack time, optional step scaling, and elastic shrink and
grow per request as backends fail and reconnect. Jobs carry an explicit
``start_index`` into the request's image range, so merging is
concatenation in index order and every backend reproduces its images
seed-exactly; a failed job's range is requeued on the surviving backends.

With ``SDTPU_JOURNAL`` on, a request's plan, each job's dispatch,
completion or failure, the requeue and the merged outcome are journaled
(``obs/journal.py``: ``planned``, ``job_dispatched``, ``job_completed``,
``job_failed``, ``requeued``, ``completed``) under the payload's
``request_id`` (else the active request's); the chaos hook
(``CHAOS_HOOK``, ``sim/chaos.py``) is consulted once per request. A
request's fan-out is a ``world.execute`` span with a ``scheduler.job``
span per job (``obs/spans.py``); every fan-out thread runs under the
caller's request context (``bind_current``). With
``SDTPU_WATCHDOG_FACTOR`` each job of a benchmarked worker is watched at
its ETA (``obs/watchdog.py``): a job that stalls past it is marked, its
thread abandoned and its range requeued, and every failed or stalled job
leaves a flight-recorder entry (``obs/flightrec.py``). Federation and push
registration and the operator's ``sync*`` user script are not ported.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

from stable_diffusion_webui_distributed_tpu_torch.obs import (
    flightrec as obs_flightrec,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    federation as obs_federation,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    journal as obs_journal,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    push as obs_push,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    spans as obs_spans,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    watchdog as obs_watchdog,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
    GenerationResult,
    apply_scripts,
    fix_seed,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import (
    config as config_mod,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import (
    interrupt as interrupt_mod,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.daemon import (
    StoppableDaemon,
)
from stable_diffusion_webui_distributed_tpu_torch.samplers.kdiffusion import (
    resolve_sampler,
)
from stable_diffusion_webui_distributed_tpu_torch.scheduler.worker import (
    HTTPBackend,
    State,
    WorkerNode,
)

log = logging.getLogger(__name__)

#: The chaos-injection seam (``sim/chaos.py``): consulted once per request
#: entering :meth:`World.execute`. None (the default) costs one identity
#: check.
CHAOS_HOOK = None


class Job:
    """Work assigned to one backend."""

    def __init__(self, worker: WorkerNode, batch_size: int):
        self.worker = worker
        self.batch_size = batch_size
        self.complementary = False
        self.step_override: Optional[int] = None
        self.start_index = 0          # global image index of this job's range
        self.result: Optional[GenerationResult] = None
        self.thread: Optional[threading.Thread] = None
        #: set by the hang watchdog when the job outlives k x its ETA:
        #: execute() abandons its thread and requeues its range
        self.stalled = False

    def add_work(self, payload, batch_size: int = 1) -> bool:
        """Grow the job if the pixel cap allows (cap 0 = uncapped)."""
        if self.worker.pixel_cap <= 0:
            self.batch_size += batch_size
            return True
        pixels = (self.batch_size + batch_size) * payload.width * payload.height
        if pixels <= self.worker.pixel_cap:
            self.batch_size += batch_size
            return True
        log.debug("worker %s hit pixel cap (%d > %d)", self.worker.label,
                  pixels, self.worker.pixel_cap)
        return False


#: alwayson scripts that re-run generation themselves: such requests
#: bypass distribution and run whole on the master, as the reference does.
SELF_LOOPING_SCRIPTS = frozenset({"adetailer", "ddetailer", "ddsd"})


class World:
    """Backend registry + job planner + request executor."""

    def __init__(self, cfg: Optional[config_mod.ConfigModel] = None,
                 config_path: Optional[str] = None):
        self.cfg = cfg or config_mod.ConfigModel()
        self.config_path = config_path
        # registry membership only; each WorkerNode locks its own state.
        # HTTP handlers add and remove workers while ping sweeps and
        # planning iterate the list.
        self._registry_lock = threading.Lock()
        self.workers: List[WorkerNode] = []
        # serializes planning: the five phases communicate through
        # self.jobs, so two execute() calls planning at once would
        # interleave their job lists. Fan-out and join overlap freely.
        self._plan_lock = threading.Lock()
        self.jobs: List[Job] = []
        self.job_timeout: float = self.cfg.job_timeout
        self.complement_production: bool = self.cfg.complement_production
        self.step_scaling: bool = self.cfg.step_scaling
        self.thin_client_mode = self.cfg.thin_client_mode
        # the checkpoint and VAE the fleet should be on, synced to the
        # non-master backends before each fan-out
        self.current_model: str = self.cfg.default_model
        self.current_vae: str = ""
        # TLS verification for remotes added at run time
        self.verify_tls: bool = True
        # the heartbeat (SDTPU_HEARTBEAT_S > 0) pings the fleet so that
        # UNAVAILABLE nodes recover without an operator; off by default
        self._heartbeat: Optional[StoppableDaemon] = None
        self.start_heartbeat()
        # with SDTPU_FEDERATION on, this World is the metrics prober's
        # worker source (obs/federation.py), and with SDTPU_PUSH on the push
        # plane's (obs/push.py); neither starts a daemon
        if obs_federation.enabled():
            obs_federation.set_source(self)
        if obs_push.enabled():
            obs_push.set_source(self)

    # -- registry -----------------------------------------------------------

    def add_worker(self, node: WorkerNode, *,
                   front: bool = False) -> WorkerNode:
        with self._registry_lock:
            if front:
                self.workers.insert(0, node)
            else:
                self.workers.append(node)
        return node

    def workers_snapshot(self) -> List[WorkerNode]:
        """The registry at a point in time (iterating the live list would
        race the HTTP add and remove routes)."""
        with self._registry_lock:
            return list(self.workers)

    def get_worker(self, label: str) -> Optional[WorkerNode]:
        for w in self.workers_snapshot():
            if w.label == label:
                return w
        return None

    def get_workers(self) -> List[WorkerNode]:
        """Schedulable backends: skips UNAVAILABLE and DISABLED ones,
        invalid speeds, and the master in thin-client mode."""
        out = []
        for w in self.workers_snapshot():
            if w.cal.avg_ipm is not None and w.cal.avg_ipm <= 0:
                log.warning("invalid benchmarked speed for '%s'; "
                            "re-benchmark", w.label)
                continue
            if w.master and self.thin_client_mode:
                continue
            if w.available:
                out.append(w)
        return out

    def master(self) -> Optional[WorkerNode]:
        for w in self.workers_snapshot():
            if w.master:
                return w
        return None

    # -- planning -----------------------------------------------------------

    def default_batch_size(self, total_images: int) -> int:
        """Equal share per schedulable backend; 0 when there are more
        backends than images (the remainder phase then places them)."""
        n = max(1, len(self.get_workers()))
        return total_images // n

    def make_jobs(self, payload: GenerationPayload) -> List[Job]:
        """The initial equal split (unbenchmarked workers benchmark
        first)."""
        self.jobs = []
        share = self.default_batch_size(payload.total_images)
        for w in self.get_workers():
            if not w.cal.benchmarked:
                w.benchmark()
                if not w.cal.benchmarked:
                    continue
            self.jobs.append(Job(w, share))
        return self.jobs

    def realtime_jobs(self) -> List[Job]:
        return [j for j in self.jobs
                if j.worker.cal.benchmarked and not j.complementary]

    def fastest_realtime_job(self) -> Job:
        return max(self.realtime_jobs(), key=lambda j: j.worker.cal.avg_ipm)

    def job_stall(self, worker: WorkerNode, payload,
                  batch_size: Optional[int] = None) -> float:
        """The extra seconds the gallery waits on ``worker`` against the
        fastest backend at the same share."""
        fastest = self.fastest_realtime_job().worker
        if worker is fastest:
            return 0.0
        return (worker.eta(payload, batch_size=batch_size)
                - fastest.eta(payload, batch_size=batch_size))

    def optimize_jobs(self, payload: GenerationPayload) -> List[Job]:
        """The five-phase policy, on the equal split of ``make_jobs``."""
        share = self.default_batch_size(payload.total_images)
        total = payload.total_images

        # phase 1: stall detection, deferring slow backends. The share is
        # clamped to each worker's pixel cap first; the overflow joins
        # the deferred pool.
        per_image_px = payload.width * payload.height
        deferred = 0
        checked = 0
        for job in self.jobs:
            cap = job.worker.pixel_cap
            fit = share if cap <= 0 else min(share, cap // per_image_px)
            # stall is judged on what the worker would actually run
            lag = self.job_stall(job.worker, payload,
                                 batch_size=fit if fit > 0 else share)
            if lag < self.job_timeout or lag == 0:
                job.batch_size = fit
                checked += fit
                deferred += share - fit
                if cap > 0 and fit == 0 and share > 0:
                    # cap too small for even one image of this request
                    job.complementary = True
                continue
            log.debug("worker '%s' would stall the gallery by ~%.2fs; "
                      "deferring", job.worker.label, lag)
            job.complementary = True
            if deferred + checked + share <= total:
                deferred += share
            job.batch_size = 0

        # phase 2: round-robin the deferred images onto realtime jobs that
        # can absorb them within the timeout and the pixel cap
        if deferred > 0:
            rt = [j for j in self.jobs if not j.complementary]
            saturated: set = set()
            i = 0
            while deferred > 0 and rt and len(saturated) < len(rt):
                job = rt[i % len(rt)]
                i += 1
                if id(job) in saturated:
                    continue
                stall = self.job_stall(job.worker, payload,
                                       batch_size=job.batch_size + 1)
                if stall < self.job_timeout and job.add_work(payload, 1):
                    deferred -= 1
                else:
                    saturated.add(id(job))
            if deferred > 0:
                log.warning("could not redistribute %d deferred image(s)",
                            deferred)

        # phase 3: the remainder round-robin, smallest jobs first
        assigned = sum(j.batch_size for j in self.jobs)
        remainder = total - assigned
        if remainder > 0:
            rt = sorted(self.realtime_jobs(), key=lambda j: j.batch_size)
            saturated = []
            while remainder > 0 and rt and len(saturated) < len(rt):
                for job in rt:
                    if remainder < 1:
                        break
                    if job in saturated:
                        continue
                    if job.add_work(payload, 1):
                        remainder -= 1
                    else:
                        saturated.append(job)
        # a realtime job left with zero images is effectively complementary
        for job in self.jobs:
            if job.batch_size == 0:
                job.complementary = True

        # phase 4: complementary production in the slack window
        if self.complement_production and self.realtime_jobs():
            fastest = self.fastest_realtime_job()
            for job in self.jobs:
                if not job.complementary or not job.worker.cal.benchmarked:
                    continue
                slack = fastest.worker.eta(
                    payload, batch_size=max(1, fastest.batch_size)
                ) + self.job_timeout
                secs_per_image = job.worker.eta(payload, batch_size=1)
                bonus = int(slack / secs_per_image)
                log.debug("'%s': %d complementary image(s) = %.2fs slack / "
                          "%.2fs per image", job.worker.label, bonus, slack,
                          secs_per_image)
                if bonus > 0:
                    if not job.add_work(payload, bonus):
                        # the pixel cap's ceiling
                        per_image = payload.width * payload.height
                        cap_images = (job.worker.pixel_cap // per_image
                                      if job.worker.pixel_cap > 0 else 0)
                        if cap_images > 0:
                            job.add_work(payload, cap_images)
                elif self.step_scaling:
                    # one image at reduced steps
                    secs_per_sample = job.worker.eta(payload, batch_size=1,
                                                     steps=1)
                    realtime_samples = int(slack // secs_per_sample)
                    if realtime_samples > 0:
                        job.add_work(payload, 1)
                        job.step_override = realtime_samples
                        log.debug("'%s' downscaled to %d steps",
                                  job.worker.label, realtime_samples)

        # phase 5: drop empty jobs; the master leads so that its images
        # land first in the gallery
        self.jobs = [j for j in self.jobs if j.batch_size > 0]
        self.jobs.sort(key=lambda j: (not j.worker.master, j.worker.label))
        start = 0
        for job in self.jobs:
            job.start_index = start
            start += job.batch_size
        return self.jobs

    def _plan_no_split(self, payload: GenerationPayload) -> Optional[List[Job]]:
        """The whole request on the single fastest backend that fits it,
        for DPM adaptive: its step controller reads one error norm over the
        whole batch, so a split would change every pixel. None when no
        single backend's pixel cap fits the request."""
        total = payload.total_images
        px = payload.width * payload.height * total
        fits = [j.worker for j in self.jobs
                if j.worker.pixel_cap <= 0 or px <= j.worker.pixel_cap]
        if not fits:
            return None
        # the stall gate of phase 1, unless every fitting backend stalls
        unstalled = [w for w in fits
                     if self.job_stall(w, payload, batch_size=total)
                     < self.job_timeout]
        pool = unstalled or fits
        # deterministic tie-break on equal avg_ipm: lowest label wins
        best = sorted(pool,
                      key=lambda w: (-(w.cal.avg_ipm or 0.0), w.label))[0]
        job = Job(best, total)
        job.start_index = 0
        return [job]

    def plan(self, payload: GenerationPayload) -> List[Job]:
        """``make_jobs`` + ``optimize_jobs``. Raises when the request
        cannot be placed (an empty gallery is an error, not a 200). DPM
        adaptive runs whole on one backend (:meth:`_plan_no_split`)."""
        with self._plan_lock:
            self.make_jobs(payload)
            if not self.jobs:
                raise RuntimeError("no benchmarked, reachable backends")
            if resolve_sampler(payload.sampler_name).adaptive:
                no_split = self._plan_no_split(payload)
                if no_split is not None:
                    self.jobs = no_split
                    return self.jobs
                log.warning(
                    "DPM adaptive request (%d images) exceeds every single "
                    "backend's pixel cap; splitting across workers, which "
                    "changes the images", payload.total_images)
            jobs = self.optimize_jobs(payload)
        if payload.total_images > 0 and not any(
                j.batch_size > 0 for j in jobs):
            raise RuntimeError(
                "no backend can accept this request (pixel caps below one "
                f"image at {payload.width}x{payload.height}?)")
        return jobs

    # -- execution ----------------------------------------------------------

    def execute(self, payload: GenerationPayload) -> GenerationResult:
        """Plan, fan out, requeue failed ranges, merge."""
        if CHAOS_HOOK is not None:
            CHAOS_HOOK("world.execute", payload=payload)
        # a new top-level request resets the interrupt latch; otherwise a
        # past interrupt would make every remote's in-flight watch abort
        # the fresh fan-out at its first poll
        interrupt_mod.STATE.begin_request()
        payload = apply_scripts(payload)
        # seeds fixed ONCE, so every backend derives the same contiguous
        # per-image seed range
        payload = payload.model_copy()
        payload.seed = fix_seed(payload.seed)
        payload.subseed = fix_seed(payload.subseed)
        if payload.all_prompts and payload.context_chunks is None:
            # the request-wide context length, pinned before slicing so an
            # image's conditioning does not depend on its worker's slice
            engine = next(
                (w.backend.engine for w in self.workers_snapshot()
                 if hasattr(w.backend, "engine")), None)
            if engine is not None:
                payload.context_chunks = \
                    engine.request_context_chunks(payload)

        looping = [k for k in (payload.alwayson_scripts or {})
                   if k.lower() in SELF_LOOPING_SCRIPTS]
        if looping:
            return self._execute_undistributed(payload, looping)

        jobs = self.plan(payload)
        log.info("distributing %d image(s): %s", payload.total_images,
                 ", ".join(f"{j.worker.label}:{j.batch_size}"
                           + ("*" if j.complementary else "") for j in jobs))
        rid = str(getattr(payload, "request_id", "")
                  or obs_spans.current_request_id() or "")
        if obs_journal.enabled():
            # the post-fix_seed dump: re-executing it reproduces every
            # image's seed
            dump = payload.model_dump()
            obs_journal.emit(
                "planned", rid, seed=payload.seed, subseed=payload.subseed,
                total=payload.total_images, payload=dump,
                fingerprint=obs_journal.fingerprint(dump),
                jobs=[{"worker": j.worker.label, "batch": j.batch_size,
                       "start": j.start_index,
                       "complementary": j.complementary} for j in jobs])
        with obs_spans.span("world.execute", images=payload.total_images,
                            jobs=len(jobs)):
            for job in jobs:
                job_payload = payload
                if job.step_override is not None:
                    job_payload = payload.model_copy()
                    job_payload.steps = job.step_override
                # under the request's context: its spans and log lines
                job.thread = threading.Thread(
                    target=obs_spans.bind_current(self._run_job),
                    args=(job, job_payload),
                    name=f"job-{job.worker.label}", daemon=True)
                job.thread.start()
            watched = obs_watchdog.enabled()
            for job in jobs:
                if not watched:
                    job.thread.join()
                    continue
                # a stall the watchdog latched abandons the (daemon) job
                # thread, so its range falls into the requeue below
                while job.thread.is_alive() and not job.stalled:
                    job.thread.join(0.1)

        # requeue failed ranges on surviving workers, but never after an
        # interrupt: a job that died because the user cancelled must not
        # be fanned out again as fresh work
        if not interrupt_mod.STATE.flag.interrupted:
            for job in [j for j in jobs
                        if (j.result is None or j.stalled)
                        and not j.complementary]:
                recovered = self._requeue_failed(job, payload)
                jobs.extend(recovered)
                self._note_job_failure(job, recovered, rid)

        merged = GenerationResult(parameters=payload.model_dump())
        for job in sorted(jobs, key=lambda j: j.start_index):
            # a stalled job may still finish late: its range was requeued
            # already, so its result must not merge twice
            if job.result is None or job.stalled:
                continue
            r = job.result
            r.worker_labels = [job.worker.label] * len(r.images)
            # per-image worker attribution in the infotext, as the
            # reference rewrites its gallery
            r.infotexts = [
                f"{t}, Worker Label: {job.worker.label}" if t else t
                for t in r.infotexts
            ]
            merged.extend(r)
        self.save_config()
        if obs_journal.enabled():
            obs_journal.emit("completed", rid, images=len(merged.images),
                             seeds=list(merged.seeds),
                             infotexts=list(merged.infotexts))
        return merged

    @staticmethod
    def _note_job_failure(job: Job, recovered: List[Job], rid: str) -> None:
        """A failed or stalled job's bookkeeping: a flight-recorder entry
        (the worker, its state, the requeue decision), the failed worker's
        requeue count and, with the journal on, ``job_failed`` and
        ``requeued``."""
        n = sum(j.batch_size for j in recovered)
        if recovered:
            dests = ", ".join(f"{j.worker.label}:{j.batch_size}"
                              for j in recovered)
            decision = f"requeued {n}/{job.batch_size} image(s) -> {dests}"
        else:
            decision = (f"dropped {job.batch_size} image(s) "
                        f"(no survivor could absorb them)")
        state = job.worker.current_state().name
        why = "stalled past the watchdog deadline on" if job.stalled \
            else "failed"
        job.worker.health.record_requeue(n)
        obs_flightrec.RECORDER.record(
            rid, "worker_failure",
            f"worker '{job.worker.label}' {why} {job.batch_size} image(s) "
            f"[{job.start_index}..{job.start_index + job.batch_size}); "
            f"state={state}; {decision}", events=[])
        if obs_journal.enabled():
            obs_journal.emit("job_failed", rid, worker=job.worker.label,
                             batch=job.batch_size, start=job.start_index,
                             stalled=job.stalled, state=state)
            obs_journal.emit("requeued", rid, from_worker=job.worker.label,
                             recovered=n, dropped=job.batch_size - n,
                             to=[j.worker.label for j in recovered])

    def _execute_undistributed(self, payload: GenerationPayload,
                               looping: List[str]) -> GenerationResult:
        """A script that re-runs generation itself: the whole request on
        one schedulable backend, the master where it can."""
        schedulable = self.get_workers()
        solo = next((w for w in schedulable if w.master),
                    next(iter(schedulable), None))
        if solo is None:
            raise RuntimeError("no backend available")
        log.info("script %s re-runs generation; bypassing distribution and "
                 "running on '%s'", looping, solo.label)
        if self.current_model and not solo.master:
            if not solo.load_options(self.current_model, self.current_vae):
                raise RuntimeError(f"model sync to '{solo.label}' failed")
        result = solo.request(payload, 0, payload.total_images)
        if result is None:
            raise RuntimeError(
                f"'{solo.label}' failed the undistributed request")
        result.parameters = payload.model_dump()
        result.worker_labels = [solo.label] * len(result.images)
        self.save_config()
        return result

    def _requeue_failed(self, job: Job,
                        payload: GenerationPayload) -> List[Job]:
        """Recover a failed job's range on the surviving backends, fastest
        first, each under its pixel cap; a survivor that fails too is
        skipped. The failed job's ``step_override`` is applied again.
        Returns the new, result-carrying jobs."""
        job_payload = payload
        if job.step_override is not None:
            job_payload = payload.model_copy()
            job_payload.steps = job.step_override

        per_image_px = payload.width * payload.height
        remaining = job.batch_size
        start = job.start_index
        dead = {id(job.worker)}
        recovered: List[Job] = []

        candidates = [w for w in self.get_workers() if id(w) not in dead]
        candidates.sort(key=lambda w: -(w.cal.avg_ipm or 0.0))
        for w in candidates:
            if remaining <= 0:
                break
            fit = remaining if w.pixel_cap <= 0 else min(
                remaining, w.pixel_cap // per_image_px)
            if fit <= 0:
                continue  # capped below one image of this resolution
            if self.current_model and not w.master:
                if not w.load_options(self.current_model, self.current_vae):
                    dead.add(id(w))
                    continue
            log.warning(
                "re-queueing %d image(s) [%d..%d) from failed '%s' to '%s'",
                fit, start, start + fit, job.worker.label, w.label)
            result = w.request(job_payload, start, fit)
            if result is None:
                dead.add(id(w))  # a second failure: on to the next
                continue
            nj = Job(w, fit)
            nj.start_index = start
            nj.step_override = job.step_override
            nj.result = result
            recovered.append(nj)
            start += fit
            remaining -= fit
        if remaining > 0:
            log.error("no survivor could absorb %d image(s) [%d..%d) from "
                      "failed '%s'", remaining, start, start + remaining,
                      job.worker.label)
        return recovered

    def _run_job(self, job: Job, payload: GenerationPayload) -> None:
        log.info("job '%s': %d image(s) [%d..%d)", job.worker.label,
                 job.batch_size, job.start_index,
                 job.start_index + job.batch_size)
        rid = str(getattr(payload, "request_id", "")
                  or obs_spans.current_request_id() or "")
        if obs_journal.enabled():
            obs_journal.emit("job_dispatched", rid, worker=job.worker.label,
                             batch=job.batch_size, start=job.start_index)
        # sync the fleet's checkpoint first (a no-op when the worker's
        # cache matches; honours its pin)
        if self.current_model and not job.worker.master:
            if not job.worker.load_options(self.current_model,
                                           self.current_vae):
                job.result = None
                return
        eta_s = None
        if obs_watchdog.enabled() and job.worker.cal.benchmarked:
            try:
                eta_s = job.worker.eta(payload, batch_size=job.batch_size)
            except ValueError:
                eta_s = None
        stop = obs_watchdog.arm(
            rid, f"job-{job.worker.label}", eta_s,
            on_stall=lambda: setattr(job, "stalled", True))
        try:
            with obs_spans.span("scheduler.job", worker=job.worker.label,
                                batch=job.batch_size,
                                start=job.start_index):
                job.result = job.worker.request(payload, job.start_index,
                                                job.batch_size)
        finally:
            obs_watchdog.disarm(stop)
        if job.result is not None and obs_journal.enabled():
            obs_journal.emit("job_completed", rid, worker=job.worker.label,
                             batch=job.batch_size, start=job.start_index,
                             images=len(job.result.images))

    # -- cluster ops --------------------------------------------------------

    def ping_workers(self, indiscriminate: bool = False) -> Dict[str, bool]:
        """Health sweep: demote unreachable backends, revive reachable
        ones. ``indiscriminate`` probes DISABLED ones too."""
        results: Dict[str, bool] = {}
        threads = []

        def probe(w: WorkerNode):
            ok = w.reachable()
            results[w.label] = ok
            if not ok:
                w.set_state(State.UNAVAILABLE)
                return
            if w.current_state() == State.UNAVAILABLE:
                w.set_state(State.IDLE)
                w._pin_refuted = False  # reconnect: its list may differ
            if w.model_override and w.pin_validated is not True \
                    and not w._pin_refuted \
                    and time.time() - w._pin_checked_at >= 60.0:
                # a pin accepted while the node was down is checked on the
                # first good ping; a refuted one is not fetched again each
                # sweep, an empty list at most once a minute
                w._pin_checked_at = time.time()
                try:
                    models = w.backend.available_models()
                except Exception:  # noqa: BLE001 — stays unvalidated
                    return
                if models:
                    w.pin_validated = w.model_override in models
                    if not w.pin_validated:
                        w._pin_refuted = True
                        log.warning("worker '%s': pinned model '%s' not in "
                                    "its model list", w.label,
                                    w.model_override)

        for w in self.workers_snapshot():
            if w.current_state() == State.DISABLED and not indiscriminate:
                continue
            t = threading.Thread(target=obs_spans.bind_current(probe),
                                 args=(w,), daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join()
        return results

    def start_heartbeat(self) -> Optional[StoppableDaemon]:
        """Start the heartbeat when ``SDTPU_HEARTBEAT_S`` > 0: a daemon
        running :meth:`ping_workers` every period. Idempotent; None when
        the knob is off (the default: no thread)."""
        period = config_mod.env_float("SDTPU_HEARTBEAT_S", 0.0) or 0.0
        if period <= 0.0 or self._heartbeat is not None:
            return self._heartbeat

        def beat():
            try:
                self.ping_workers()
            except Exception as e:  # noqa: BLE001 — the sweep must survive
                log.debug("heartbeat sweep failed: %s", e)

        self._heartbeat = StoppableDaemon("worker-heartbeat", beat, period)
        self._heartbeat.start()
        return self._heartbeat

    def stop_heartbeat(self) -> None:
        if self._heartbeat is not None:
            self._heartbeat.stop(timeout_s=2.0)
            self._heartbeat = None

    def health_summary(self) -> Dict[str, Dict]:
        """Per-worker health record, state and speed."""
        out: Dict[str, Dict] = {}
        for w in self.workers_snapshot():
            s = w.health.summary()
            s["state"] = w.current_state().name
            s["avg_ipm"] = w.cal.avg_ipm
            out[w.label] = s
        return out

    def interrupt_all(self) -> None:
        """Interrupt every working backend."""
        for w in self.workers_snapshot():
            if w.current_state() == State.WORKING:
                threading.Thread(
                    target=obs_spans.bind_current(w.interrupt),
                    daemon=True).start()

    def restart_all(self) -> Dict[str, bool]:
        """Ask every enabled remote to restart (the master restarts
        through its own /server-restart route)."""
        results: Dict[str, bool] = {}
        threads = []

        def run(w: WorkerNode):
            results[w.label] = w.restart()

        for w in self.workers_snapshot():
            if w.master or w.current_state() == State.DISABLED:
                continue
            t = threading.Thread(target=obs_spans.bind_current(run),
                                 args=(w,), daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join()
        return results

    _UNSET = object()

    def configure_worker(self, label: str, model_override=_UNSET,
                         pixel_cap=_UNSET, disabled=_UNSET) -> bool:
        """Set a worker's checkpoint pin, pixel cap or enabled state, live
        and persisted. False for an unknown label."""
        w = self.get_worker(label)
        if w is None:
            return False
        if model_override is not self._UNSET:
            w.model_override = model_override or None
            w.pin_validated = None if w.model_override is None else False
            w._pin_refuted = False
            w._pin_checked_at = 0.0  # a fresh pin validates on next ping
        if pixel_cap is not self._UNSET and pixel_cap is not None:
            w.pixel_cap = max(0, int(pixel_cap))
        if disabled is not self._UNSET and disabled is not None:
            if disabled:
                w.set_state(State.DISABLED)
            elif w.current_state() == State.DISABLED:
                w.set_state(State.IDLE)
        self.save_config()
        return True

    def add_remote_worker(self, label: str, address: str, port: int, *,
                          tls: bool = False, user: Optional[str] = None,
                          password: Optional[str] = None,
                          pixel_cap: int = 0) -> WorkerNode:
        """Register an HTTP remote live and persist it. ValueError on a
        duplicate label or a missing address."""
        if not label:
            raise ValueError("label required")
        if self.get_worker(label) is not None:
            raise ValueError(f"worker '{label}' already exists")
        if not address:
            raise ValueError("address required")
        backend = HTTPBackend(address, int(port), tls=tls, user=user,
                              password=password, verify_tls=self.verify_tls)
        node = WorkerNode(label, backend, pixel_cap=max(0, int(pixel_cap)),
                          benchmark_payload=self.cfg.benchmark_payload)
        self.add_worker(node)
        self.save_config()
        return node

    def update_worker_endpoint(self, label: str, *, address=None, port=None,
                               tls=None, user=None, password=None) -> bool:
        """Edit a remote's address, port, TLS or credentials in place.
        None keeps a field; an empty string clears a credential. A real
        change rebuilds the backend and forgets what was synced to the old
        endpoint; a new address also drops the speed calibration. False
        for an unknown label; ValueError for the master or a non-HTTP
        worker."""
        w = self.get_worker(label)
        if w is None:
            return False
        if w.master:
            raise ValueError("master has no remote endpoint to edit")
        old = w.backend
        if not isinstance(old, HTTPBackend):
            raise ValueError(f"worker '{label}' is not an HTTP remote")
        new_address = address if address is not None else old.address
        if not new_address:
            raise ValueError("address required")
        merged = (new_address,
                  int(port) if port is not None else old.port,
                  bool(tls) if tls is not None else old.tls,
                  (user if user is not None else old.user) or None,
                  (password if password is not None else old.password)
                  or None)
        if merged == (old.address, old.port, old.tls, old.user,
                      old.password):
            # a no-op edit keeps the live backend and its sync caches
            return True
        a, p, t, u, pw = merged
        w.backend = HTTPBackend(a, p, tls=t, user=u, password=pw,
                                verify_tls=self.verify_tls)
        with w._lock:
            w.loaded_model = None
            w.loaded_vae = None
        w.supported_scripts = None
        w.free_memory = None
        if a != old.address:
            w.cal = type(w.cal)()  # another machine: benchmark from zero
        if w.current_state() == State.UNAVAILABLE:
            w.set_state(State.IDLE)
        self.save_config()
        return True

    def remove_worker(self, label: str) -> bool:
        """Drop a non-master worker from the registry and the config.
        False for an unknown label; ValueError for the master."""
        w = self.get_worker(label)
        if w is None:
            return False
        if w.master:
            raise ValueError("cannot remove the master worker")
        with self._registry_lock:
            self.workers.remove(w)
        self.save_config()
        return True

    def apply_settings(self, settings: Dict) -> Dict:
        """Scheduler settings (job_timeout, complement_production,
        step_scaling, thin_client_mode), live and persisted. Returns the
        applied subset."""
        applied = {}
        if settings.get("job_timeout") is not None:
            self.job_timeout = float(settings["job_timeout"])
            applied["job_timeout"] = self.job_timeout
        for key in ("complement_production", "step_scaling",
                    "thin_client_mode"):
            if settings.get(key) is not None:
                setattr(self, key, bool(settings[key]))
                applied[key] = getattr(self, key)
        if applied:
            self.save_config()
        return applied

    def benchmark_all(self, rebenchmark: bool = False) -> Dict[str, float]:
        """Benchmark every schedulable backend: the master on this thread,
        the remotes each on a thread of its own."""
        out: Dict[str, float] = {}
        threads = []

        def run(w: WorkerNode):
            ipm = w.benchmark(rebenchmark)
            if ipm:
                out[w.label] = ipm

        for w in self.get_workers():
            if w.master:
                run(w)
            else:
                t = threading.Thread(target=obs_spans.bind_current(run),
                                     args=(w,), daemon=True)
                t.start()
                threads.append(t)
        for t in threads:
            t.join()
        self.save_config()
        return out

    def sync_models(self, model: str, vae: str = "") -> None:
        """Push a checkpoint change to every available non-master
        backend, in threads."""
        threads = []
        for w in self.workers_snapshot():
            if w.master or not w.available:
                continue
            t = threading.Thread(
                target=obs_spans.bind_current(w.load_options),
                args=(model, vae), daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join()

    # -- persistence --------------------------------------------------------

    def save_config(self) -> None:
        """Write the calibration back into the config. A master entry
        persisted earlier survives when this World has no local engine
        (``status`` and ``ping``), so those commands do not erase it."""
        workers = self.workers_snapshot()
        worker_entries = []
        if not any(w.master for w in workers):
            for entry in self.cfg.workers:
                for label, wm in entry.items():
                    if wm.master:
                        worker_entries.append({label: wm})
        for w in workers:
            model = config_mod.WorkerModel(
                avg_ipm=w.cal.avg_ipm,
                master=w.master,
                eta_percent_error=list(w.cal.eta_percent_error),
                pixel_cap=w.pixel_cap,
                disabled=w.current_state() == State.DISABLED,
                model_override=w.model_override,
            )
            backend = w.backend
            if isinstance(backend, HTTPBackend):
                model.address = backend.address
                model.port = backend.port
                model.tls = backend.tls
                model.user = backend.user
                model.password = backend.password
            worker_entries.append({w.label: model})
        self.cfg.workers = worker_entries
        self.cfg.job_timeout = int(self.job_timeout)
        self.cfg.complement_production = self.complement_production
        self.cfg.step_scaling = self.step_scaling
        self.cfg.thin_client_mode = self.thin_client_mode
        if self.config_path:
            config_mod.save_config(self.cfg, self.config_path)

    def master_calibration(self) -> Optional[config_mod.WorkerModel]:
        """The persisted master entry, if any."""
        for entry in self.cfg.workers:
            for _, wm in entry.items():
                if wm.master:
                    return wm
        return None

    @classmethod
    def from_config(cls, cfg: config_mod.ConfigModel,
                    config_path: Optional[str] = None,
                    backend_factory=None,
                    verify_tls: bool = True) -> "World":
        """A World from a persisted config: remote entries become HTTP
        backends with their calibration. Master entries are skipped unless
        ``backend_factory`` is given: the caller attaches the local engine
        (``cli._build_world``)."""
        world = cls(cfg, config_path)
        world.verify_tls = verify_tls
        for entry in cfg.workers:
            for label, wm in entry.items():
                if backend_factory is not None:
                    backend = backend_factory(label, wm)
                elif wm.master:
                    continue  # the caller attaches the local engine
                else:
                    backend = HTTPBackend(wm.address, wm.port, tls=wm.tls,
                                          user=wm.user, password=wm.password,
                                          verify_tls=verify_tls)
                node = WorkerNode(
                    label, backend, master=wm.master,
                    pixel_cap=wm.pixel_cap, avg_ipm=wm.avg_ipm,
                    eta_percent_error=wm.eta_percent_error,
                    benchmark_payload=cfg.benchmark_payload,
                    model_override=wm.model_override,
                )
                if wm.disabled:
                    node.set_state(State.DISABLED)
                world.add_worker(node)
        return world
