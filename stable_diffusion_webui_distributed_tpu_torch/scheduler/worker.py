"""Generation backends ("workers") and their health state machine.

A copy of the JAX package's ``scheduler/worker.py``. A :class:`WorkerNode`
is one schedulable backend with its calibration, state and caps; the
backend is pluggable:

- :class:`LocalBackend`: the in-process ``Engine`` (the master);
- :class:`HTTPBackend`: a remote sdapi-v1 server (another node of this
  port, a node of the JAX package or a webui), on the standard library's
  ``http.client`` with Basic auth and TLS verification;
- :class:`StubBackend`: a deterministic fake for tests and failure
  injection.

Five states with guarded transitions; a demotion to UNAVAILABLE drops the
loaded-model cache so that a reconnect forces a re-sync.

Every backend runs a job's range ``[start, start+count)`` as the request
a remote receives for it (:func:`sub_request`): seeds offset by
``start``, ``batch_size=count``. The port's engine runs a short group at
the request's full batch size (pad-and-drop), and on the card a row's
bf16 numbers depend on the batch size; running the master's range at its
own size too means a range gives the same bytes on any backend, so a
failed remote's requeued range reproduces what the remote would have made.

Left out of the port: the request spans, the Prometheus counters of the
health record and the chaos hook (ROADMAP items 17 and 20).
"""

from __future__ import annotations

import base64
import dataclasses
import enum
import http.client
import json
import logging
import ssl
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Protocol, Tuple

import torch

from stable_diffusion_webui_distributed_tpu_torch.pipeline import (
    precision as precision_mod,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
    GenerationResult,
    Unsupported,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import (
    interrupt as interrupt_mod,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    RECORDED_SAMPLES,
    WARMUP_SAMPLES,
    BenchmarkPayload,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.daemon import (
    StoppableDaemon,
)
from stable_diffusion_webui_distributed_tpu_torch.scheduler import (
    eta as eta_mod,
)

log = logging.getLogger(__name__)


class State(enum.Enum):
    IDLE = 1
    WORKING = 2
    INTERRUPTED = 3
    UNAVAILABLE = 4
    DISABLED = 5


#: Guarded transitions. UNAVAILABLE is reachable from anywhere except
#: DISABLED (handled in ``WorkerNode._transition``).
TRANSITIONS = {
    State.IDLE: {State.IDLE, State.WORKING, State.DISABLED},
    State.WORKING: {State.WORKING, State.IDLE, State.INTERRUPTED},
    State.UNAVAILABLE: {State.IDLE},
    State.INTERRUPTED: {State.WORKING, State.IDLE},
    State.DISABLED: {State.IDLE},
}


class WorkerHealth:
    """How a worker has been behaving: error rate over a bounded window of
    outcomes, a latency EWMA, the consecutive-failure streak, the images
    requeued away from it and its recent state transitions. Read by
    ``World.health_summary`` and ``GET /internal/workers``."""

    WINDOW = 32           # request outcomes retained
    TRANSITION_RING = 32  # state transitions retained
    EWMA_ALPHA = 0.3

    def __init__(self, label: str):
        self.label = label
        self._lock = threading.Lock()
        self._window: Deque[bool] = deque(maxlen=self.WINDOW)
        self._transitions: Deque[Tuple[float, str, str]] = deque(
            maxlen=self.TRANSITION_RING)
        self.requests = 0
        self.failures = 0
        self.consecutive_failures = 0
        self.requeued_images = 0
        self.latency_ewma_s: Optional[float] = None

    def record_result(self, ok: bool,
                      latency_s: Optional[float] = None) -> None:
        with self._lock:
            self.requests += 1
            self._window.append(bool(ok))
            if ok:
                self.consecutive_failures = 0
                if latency_s is not None:
                    prev = self.latency_ewma_s
                    self.latency_ewma_s = (
                        float(latency_s) if prev is None
                        else self.EWMA_ALPHA * float(latency_s)
                        + (1.0 - self.EWMA_ALPHA) * prev)
            else:
                self.failures += 1
                self.consecutive_failures += 1

    def record_requeue(self, images: int) -> None:
        """``images`` of this worker's range were requeued elsewhere."""
        with self._lock:
            self.requeued_images += int(images)

    def record_transition(self, frm: str, to: str) -> None:
        at = time.time()
        with self._lock:
            self._transitions.append((at, frm, to))

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            window = list(self._window)
            return {
                "requests": self.requests,
                "failures": self.failures,
                "window": len(window),
                "error_rate": ((sum(1 for ok in window if not ok)
                                / len(window)) if window else 0.0),
                "consecutive_failures": self.consecutive_failures,
                "latency_ewma_s": self.latency_ewma_s,
                "requeued_images": self.requeued_images,
                "transitions": [{"at": at, "from": f, "to": t}
                                for at, f, t in self._transitions],
            }


class Backend(Protocol):
    """What a schedulable backend must provide."""

    def generate(self, payload: GenerationPayload, start_index: int,
                 count: int) -> GenerationResult: ...

    def reachable(self) -> bool: ...

    def interrupt(self) -> None: ...

    def restart(self) -> None: ...

    def load_options(self, model: str, vae: str = "") -> None: ...

    def script_info(self) -> List[str]: ...

    def available_models(self) -> List[str]: ...

    def memory_info(self) -> Dict[str, Any]: ...


class WorkerNode:
    """One schedulable backend with its calibration, state and caps."""

    def __init__(
        self,
        label: str,
        backend: Backend,
        master: bool = False,
        pixel_cap: int = 0,
        avg_ipm: Optional[float] = None,
        eta_percent_error: Optional[List[float]] = None,
        benchmark_payload: Optional[BenchmarkPayload] = None,
        model_override: Optional[str] = None,
    ):
        self.label = label
        self.backend = backend
        self.master = master
        self.pixel_cap = pixel_cap  # 0 = uncapped
        self.cal = eta_mod.EtaCalibration(
            avg_ipm=avg_ipm,
            eta_percent_error=list(eta_percent_error or []),
        )
        self.benchmark_payload = benchmark_payload or BenchmarkPayload()
        # the state machine and the model-sync cache are read by HTTP
        # handlers, ping sweeps and request threads at once: every access
        # outside __init__ holds _lock
        self.state = State.IDLE
        self.loaded_model: Optional[str] = None
        self.loaded_vae: Optional[str] = None
        # script titles this backend supports, re-read at every ping;
        # None = unknown (send everything)
        self.supported_scripts: Optional[List[str]] = None
        # checkpoint pin, honoured by load_options and persisted
        self.model_override: Optional[str] = model_override
        # pin provenance: True = found in the node's model list, False =
        # accepted unchecked, None = no pin or not yet checked
        self.pin_validated: Optional[bool] = None
        self._pin_refuted = False
        self._pin_checked_at = 0.0
        self.response_time: Optional[float] = None
        # free device memory seen at first contact (-1 = unknown)
        self.free_memory: Optional[int] = None
        # interrupt rendezvous watched while a remote request is in
        # flight (None = the process-wide runtime.interrupt.STATE)
        self.interrupt_state = None
        self.interrupt_poll_s = 0.5
        self.health = WorkerHealth(label)
        self._lock = threading.Lock()

    # -- state machine ------------------------------------------------------

    def set_state(self, state: State, expect_cycle: bool = False) -> bool:
        """Guarded transition; True if the state changed or held legally."""
        ok, changed = self._transition(state, expect_cycle)
        if changed is not None:
            # after _lock is released (health has its own lock)
            self.health.record_transition(*changed)
        return ok

    def _transition(self, state: State, expect_cycle: bool,
                    ) -> Tuple[bool, Optional[Tuple[str, str]]]:
        """(legal, (from, to) if the state moved)."""
        with self._lock:
            if state == State.UNAVAILABLE:
                if self.state == State.DISABLED:
                    log.debug("%s: disabled, refusing UNAVAILABLE", self.label)
                    return False, None
                prev = self.state
                # a reconnect must re-sync the model
                self.loaded_model = None
                self.loaded_vae = None
                log.warning("worker '%s' unreachable; avoided until "
                            "reconnection", self.label)
                self.state = State.UNAVAILABLE
                return True, (prev.name, state.name)
            if state in TRANSITIONS.get(self.state, set()):
                if state != self.state or expect_cycle:
                    prev = self.state
                    log.debug("%s: %s -> %s", self.label, prev.name,
                              state.name)
                    self.state = state
                    return True, (prev.name, state.name)
                return True, None
            log.debug("%s: invalid transition %s -> %s", self.label,
                      self.state.name, state.name)
            return False, None

    @property
    def available(self) -> bool:
        with self._lock:
            return self.state not in (State.UNAVAILABLE, State.DISABLED)

    def current_state(self) -> State:
        with self._lock:
            return self.state

    # -- ETA ----------------------------------------------------------------

    def eta(self, payload, batch_size: Optional[int] = None,
            steps: Optional[int] = None) -> float:
        # the payload's serving precision scales the compute part, so a
        # fleet predicts each request at its own speed
        return eta_mod.predict_eta(self.cal, payload, self.benchmark_payload,
                                   batch_size=batch_size, steps=steps,
                                   precision=self._payload_precision(payload))

    @staticmethod
    def _payload_precision(payload) -> str:
        """The payload's resolved precision for the ETA: its own fields
        only (a remote backend's environment defaults are not visible
        here, so an unnamed precision calibrates as bf16)."""
        return precision_mod.resolve(payload).name

    # -- request lifecycle --------------------------------------------------

    def request(self, payload: GenerationPayload, start_index: int,
                count: int) -> Optional[GenerationResult]:
        """Generate images ``[start_index, start_index+count)``; None on
        failure, and the worker is demoted."""
        # wait out a request still in flight (the reference's busy-wait)
        deadline = time.monotonic() + 30.0
        while self.current_state() == State.WORKING \
                and time.monotonic() < deadline:
            time.sleep(0.1)
        self.set_state(State.WORKING)

        payload = self.filter_payload_scripts(payload)
        if self.free_memory is None:
            self._probe_memory()
        predicted = None
        if self.cal.benchmarked:
            try:
                predicted = self.eta(payload, batch_size=count)
            except ValueError:
                predicted = None
        started = time.monotonic()
        watch = self._start_interrupt_watch()
        try:
            result = self.backend.generate(payload, start_index, count)
        except Exception as e:  # noqa: BLE001 — any backend failure demotes
            log.error("worker '%s' failed request: %s", self.label, e)
            self.health.record_result(False)
            self.set_state(State.UNAVAILABLE)
            return None
        finally:
            if watch is not None:
                watch.halt()  # hot path: signal only, never join
        elapsed = time.monotonic() - started
        self.response_time = elapsed
        self.health.record_result(True, elapsed)
        if predicted is not None:
            # an int8 sample refines the int8 factor only, never the bf16
            # MPE window
            eta_mod.record_eta_error(
                self.cal, predicted, elapsed,
                precision=self._payload_precision(payload))
        self.set_state(State.IDLE)
        return result

    def _start_interrupt_watch(self) -> Optional[StoppableDaemon]:
        """Poll the interrupt flag every ``interrupt_poll_s`` while a remote
        request is in flight and call ``backend.interrupt()`` once it
        latches. The master needs no watch: its chunked denoise loop reads
        the same flag between chunks."""
        if self.master:
            return None
        state = self.interrupt_state or interrupt_mod.STATE

        def watch():
            if not state.flag.interrupted:
                return
            log.info("interrupt: aborting in-flight request on '%s'",
                     self.label)
            try:
                self.backend.interrupt()
            except Exception as e:  # noqa: BLE001
                log.error("in-flight interrupt of '%s' failed: %s",
                          self.label, e)
            daemon.halt()  # fired once: the watch is done

        daemon = StoppableDaemon(f"interrupt-watch-{self.label}", watch,
                                 self.interrupt_poll_s)
        daemon.start()
        return daemon

    def _probe_memory(self) -> None:
        """First-contact memory probe: record the free device memory
        (webui's ``cuda.system.free``) and warn when it looks too tight;
        failures are not fatal."""
        try:
            info = self.backend.memory_info()
        except Exception:  # noqa: BLE001
            self.free_memory = -1
            return
        free = None
        cuda = info.get("cuda") or {}
        if isinstance(cuda, dict):
            free = (cuda.get("system") or {}).get("free")
        if free is None:
            # a JAX package node reports its accelerators under "tpu";
            # devices without memory stats don't count as 0 bytes free
            tpu = info.get("tpu") or {}
            devs = [d for d in (tpu.get("devices") or [])
                    if d.get("bytes_limit", 0) > 0]
            if devs:
                free = sum(max(0, d["bytes_limit"]
                               - d.get("bytes_in_use", 0)) for d in devs)
        self.free_memory = int(free) if free is not None else -1
        if 0 <= self.free_memory < 2 << 30:
            log.warning("worker '%s' reports only %.1f GiB free device "
                        "memory", self.label, self.free_memory / (1 << 30))

    def interrupt(self) -> None:
        try:
            self.backend.interrupt()
            self.set_state(State.INTERRUPTED)
        except Exception as e:  # noqa: BLE001
            log.error("interrupt of '%s' failed: %s", self.label, e)
            self.set_state(State.UNAVAILABLE)

    def restart(self) -> bool:
        """Ask the backend's server to restart; the node goes UNAVAILABLE
        until a ping sweep finds it back."""
        try:
            self.backend.restart()
        except Exception as e:  # noqa: BLE001
            log.error("restart of '%s' failed: %s", self.label, e)
            return False
        self.set_state(State.UNAVAILABLE)
        return True

    def reachable(self) -> bool:
        try:
            ok = self.backend.reachable()
        except Exception:  # noqa: BLE001
            return False
        if ok:
            # re-read at every ping: a restarted node may support other
            # scripts
            try:
                self.supported_scripts = self.backend.script_info()
            except Exception:  # noqa: BLE001
                pass  # keep the previous knowledge
        return ok

    def filter_payload_scripts(self, payload: GenerationPayload
                               ) -> GenerationPayload:
        """Strip alwayson-script args this backend doesn't support."""
        if not payload.alwayson_scripts or self.supported_scripts is None:
            return payload
        supported = {s.lower() for s in self.supported_scripts}
        kept = {k: v for k, v in payload.alwayson_scripts.items()
                if k.lower() in supported}
        if len(kept) == len(payload.alwayson_scripts):
            return payload
        dropped = set(payload.alwayson_scripts) - set(kept)
        log.debug("worker '%s': dropping unsupported script args %s",
                  self.label, sorted(dropped))
        payload = payload.model_copy()
        payload.alwayson_scripts = kept
        return payload

    def load_options(self, model: str, vae: str = "") -> bool:
        """Sync the loaded checkpoint (a no-op when the cache matches)."""
        if self.model_override:
            model = self.model_override
        with self._lock:
            if self.loaded_model == model and self.loaded_vae == vae:
                return True
        try:
            t0 = time.monotonic()
            self.backend.load_options(model, vae)
            log.info("worker '%s' loaded model '%s' in %.1fs", self.label,
                     model, time.monotonic() - t0)
            with self._lock:
                self.loaded_model, self.loaded_vae = model, vae
            return True
        except Exception as e:  # noqa: BLE001
            log.error("model sync to '%s' failed: %s", self.label, e)
            self.set_state(State.UNAVAILABLE)
            return False

    # -- benchmark ----------------------------------------------------------

    def benchmark(self, rebenchmark: bool = False) -> Optional[float]:
        """``WARMUP_SAMPLES`` warm-up and ``RECORDED_SAMPLES`` recorded
        runs of the benchmark payload -> the mean images per minute."""
        if self.cal.benchmarked and not rebenchmark:
            return self.cal.avg_ipm
        if not self.reachable():
            self.set_state(State.UNAVAILABLE)
            return None
        bp = self.benchmark_payload
        payload = GenerationPayload(
            prompt=bp.prompt, negative_prompt=bp.negative_prompt,
            steps=bp.steps, width=bp.width, height=bp.height,
            batch_size=bp.batch_size, sampler_name=bp.sampler_name, seed=1,
        )
        ipms = []
        for i in range(WARMUP_SAMPLES + RECORDED_SAMPLES):
            t0 = time.monotonic()
            try:
                result = self.backend.generate(payload, 0, bp.batch_size)
            except Exception as e:  # noqa: BLE001
                log.error("benchmark of '%s' failed: %s", self.label, e)
                self.set_state(State.UNAVAILABLE)
                return None
            elapsed = time.monotonic() - t0
            sample_ipm = len(result.images) / (elapsed / 60.0)
            if i >= WARMUP_SAMPLES:
                ipms.append(sample_ipm)
            log.debug("benchmark '%s' %s %d: %.2f ipm", self.label,
                      "sample" if i >= WARMUP_SAMPLES else "warm-up", i,
                      sample_ipm)
        self.cal.avg_ipm = sum(ipms) / len(ipms)
        self.cal.eta_percent_error.clear()  # stale MPE dies with re-bench
        log.info("worker '%s': %.2f ipm", self.label, self.cal.avg_ipm)
        return self.cal.avg_ipm


# --------------------------------------------------------------------------
# backends
# --------------------------------------------------------------------------

def sub_request(payload: GenerationPayload, start_index: int,
                count: int) -> GenerationPayload:
    """The request a backend runs for images ``[start_index,
    start_index+count)`` of ``payload``: the reference master's fan-out
    arithmetic. Seed and subseed are offset by ``start_index`` (a pinned
    seed stays: variation batches advance the subseed only, same-seed
    batches neither), per-image prompts are sliced, and the range is one
    batch of ``count``."""
    sub = payload.model_copy()
    if payload.subseed_strength == 0 and not payload.same_seed:
        sub.seed = payload.seed + start_index
    if not payload.same_seed:
        sub.subseed = payload.subseed + start_index
    if payload.all_prompts:
        sub.all_prompts = payload.all_prompts[start_index:
                                              start_index + count]
    sub.batch_size = count
    sub.n_iter = 1
    return sub


def cuda_memory(device: torch.device) -> Dict[str, Any]:
    """webui's ``cuda`` section of ``GET /sdapi/v1/memory`` for a CUDA
    device: the card's free, used and total bytes, and this process's
    allocator counters (current and peak)."""
    free, total = torch.cuda.mem_get_info(device)
    stats = torch.cuda.memory_stats(device)

    def pair(name):
        return {"current": int(stats.get(f"{name}.all.current", 0)),
                "peak": int(stats.get(f"{name}.all.peak", 0))}

    return {
        "system": {"free": int(free), "used": int(total - free),
                   "total": int(total)},
        "active": pair("active_bytes"),
        "allocated": pair("allocated_bytes"),
        "reserved": pair("reserved_bytes"),
        "inactive": pair("inactive_split_bytes"),
        "events": {"retries": int(stats.get("num_alloc_retries", 0)),
                   "oom": int(stats.get("num_ooms", 0))},
    }


class LocalBackend:
    """The in-process ``Engine`` (the master). A range runs through the
    engine's ``generate_range``, so on the engine's own device thread.

    With a ``registry`` (``pipeline/registry.py`` ``ModelRegistry``) the
    backend follows the registry's active engine, so a model switch takes
    effect with the next range, while a range in flight finishes on the
    engine it started on; ``load_options`` switches through the registry
    and ``available_models`` lists its checkpoints. Without one it serves
    ``engine`` alone and refuses any other model."""

    def __init__(self, engine=None, registry=None):
        self._engine = engine
        self.registry = registry

    @property
    def engine(self):
        return self.registry.engine if self.registry is not None \
            else self._engine

    def generate(self, payload, start_index, count):
        return self.engine.generate_range(
            sub_request(payload, start_index, count))

    def reachable(self) -> bool:
        return True

    def interrupt(self) -> None:
        self.engine.state.flag.interrupt()

    def restart(self) -> None:
        # the master restarts through its own /server-restart route
        raise RuntimeError("local master cannot restart itself")

    def load_options(self, model: str, vae: str = "") -> None:
        """Switch to checkpoint ``model`` and apply VAE ``vae`` ("" is the
        checkpoint's own). Without a registry, anything but the served
        model and its own VAE fails, as does a name the registry lacks."""
        registry = self.registry
        if registry is None:
            if (model and model != self.engine.model_name) or vae:
                raise Unsupported(f"cannot switch to model {model!r}, VAE "
                                  f"{vae!r}: the PyTorch engine serves "
                                  f"{self.engine.model_name!r} only")
            return
        if model and model != registry.current_name:
            if registry.checkpoint_path(model) is None:
                raise Unsupported(f"no checkpoint {model!r} in "
                                  f"{registry.model_dir!r}")
            registry.activate(model)
        if not registry.set_vae(vae or ""):
            raise Unsupported(f"no VAE {vae!r} in {registry.model_dir!r}")

    def script_info(self) -> List[str]:
        return ["controlnet"]  # ControlNet units run in the engine

    def available_models(self) -> List[str]:
        if self.registry is not None:
            return self.registry.model_names()
        return [self.engine.model_name]

    def memory_info(self) -> Dict[str, Any]:
        if self.engine.device.type != "cuda":
            return {}  # no device memory to report
        return {"cuda": cuda_memory(self.engine.device)}


@dataclasses.dataclass
class StubBehavior:
    """Failure-injection knobs for tests."""

    seconds_per_image: float = 0.0
    fail_generate: bool = False
    fail_reachable: bool = False
    fail_after_n_requests: Optional[int] = None
    supported_scripts: Tuple[str, ...] = ("controlnet",)


class StubBackend:
    """Deterministic in-process fake worker."""

    def __init__(self, behavior: Optional[StubBehavior] = None):
        self.behavior = behavior or StubBehavior()
        self.requests: List[Dict[str, Any]] = []
        self.interrupted = False
        self.restarted = False
        self.options: Dict[str, str] = {}
        self.models: List[str] = ["stub-model"]

    def generate(self, payload, start_index, count):
        n = len(self.requests)
        self.requests.append(
            {"payload": payload, "start": start_index, "count": count})
        b = self.behavior
        if b.fail_generate or (
            b.fail_after_n_requests is not None
            and n >= b.fail_after_n_requests
        ):
            raise ConnectionError("stub backend injected failure")
        result = GenerationResult()
        pinned = payload.same_seed or payload.subseed_strength > 0
        for i in range(start_index, start_index + count):
            if b.seconds_per_image:
                # sleep in slices so an interrupt lands mid-flight, like a
                # real remote that returns the images finished so far
                deadline = time.monotonic() + b.seconds_per_image
                while time.monotonic() < deadline and not self.interrupted:
                    time.sleep(0.01)
            if self.interrupted:
                break
            # the engine's per-image seed and prompt arithmetic
            seed_i = payload.seed + (0 if pinned else i)
            sub_i = payload.subseed + (0 if payload.same_seed else i)
            prompt_i = payload.prompt
            if payload.all_prompts and i < len(payload.all_prompts):
                prompt_i = payload.all_prompts[i]
            result.images.append(f"stub-image-{seed_i}")
            result.seeds.append(seed_i)
            result.subseeds.append(sub_i)
            result.prompts.append(prompt_i)
            result.negative_prompts.append(payload.negative_prompt)
            result.infotexts.append(f"{prompt_i}, Seed: {seed_i}")
            result.worker_labels.append("")
        return result

    def reachable(self) -> bool:
        return not self.behavior.fail_reachable

    def interrupt(self) -> None:
        self.interrupted = True

    def restart(self) -> None:
        if self.behavior.fail_reachable:
            raise ConnectionError("stub: restart failure")
        self.restarted = True

    def load_options(self, model: str, vae: str = "") -> None:
        if self.behavior.fail_generate:
            raise ConnectionError("stub: load_options failure")
        self.options = {"model": model, "vae": vae}

    def script_info(self) -> List[str]:
        return list(self.behavior.supported_scripts)

    def available_models(self) -> List[str]:
        return list(self.models)

    def memory_info(self) -> Dict[str, Any]:
        return {"ram": {"free": 1 << 30, "used": 0, "total": 1 << 30}}


class RemoteError(RuntimeError):
    """A remote answered with a status outside 2xx."""

    def __init__(self, status: int, detail: str):
        super().__init__(f"HTTP {status}: {detail}")
        self.status = status
        self.detail = detail


class HTTPBackend:
    """A remote sdapi-v1 server over HTTP(S): the reference's transport,
    on ``http.client``. ``timeout`` bounds the control-plane calls
    (reachability, interrupt, script info); a generation may take an
    hour and a model load ten minutes."""

    def __init__(self, address: str, port: int, tls: bool = False,
                 user: Optional[str] = None, password: Optional[str] = None,
                 verify_tls: bool = True, timeout: float = 3.0):
        self.address = address
        self.port = port
        self.tls = tls
        self.user = user
        self.password = password
        self.verify_tls = verify_tls
        self.timeout = timeout
        self._headers: Dict[str, str] = {}
        if user or password:
            token = base64.b64encode(
                f"{user or ''}:{password or ''}".encode()).decode()
            self._headers["Authorization"] = f"Basic {token}"

    def _connect(self, timeout: float) -> http.client.HTTPConnection:
        if self.tls:
            ctx = ssl.create_default_context()
            if not self.verify_tls:
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            conn = http.client.HTTPSConnection(
                self.address, self.port, timeout=timeout, context=ctx)
        else:
            conn = http.client.HTTPConnection(self.address, self.port,
                                              timeout=timeout)
        conn.connect()
        return conn

    def _exchange(self, conn, method: str, route: str,
                  body: Optional[Dict[str, Any]]) -> Tuple[int, bytes]:
        headers = dict(self._headers)
        data = None
        if body is not None:
            data = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
        conn.request(method, f"/sdapi/v1/{route}", body=data,
                     headers=headers)
        resp = conn.getresponse()
        return resp.status, resp.read()

    def _call(self, method: str, route: str,
              body: Optional[Dict[str, Any]] = None,
              timeout: Optional[float] = None) -> Tuple[int, bytes]:
        conn = self._connect(timeout or self.timeout)
        try:
            return self._exchange(conn, method, route, body)
        finally:
            conn.close()

    def _json(self, method: str, route: str,
              body: Optional[Dict[str, Any]] = None,
              timeout: Optional[float] = None) -> Any:
        status, data = self._call(method, route, body, timeout)
        if not 200 <= status < 300:
            raise RemoteError(status, data.decode(errors="replace")[:500])
        return json.loads(data) if data else {}

    def generate(self, payload: GenerationPayload, start_index: int,
                 count: int) -> GenerationResult:
        body = sub_request(payload, start_index, count).model_dump()
        route = "img2img" if payload.init_images else "txt2img"
        status, data = self._call("POST", route, body, timeout=3600)
        if status == 404 and b"sampler" in data.lower():
            # the remote lacks this sampler: retry with Euler a, the
            # reference's degraded-capability fallback
            log.warning("remote %s:%d lacks sampler '%s'; retrying with "
                        "Euler a", self.address, self.port,
                        body.get("sampler_name"))
            body["sampler_name"] = "Euler a"
            status, data = self._call("POST", route, body, timeout=3600)
        if not 200 <= status < 300:
            raise RemoteError(status, data.decode(errors="replace")[:500])
        resp = json.loads(data)
        result = GenerationResult(images=resp.get("images", []))
        info = resp.get("info")
        if isinstance(info, str):
            try:
                info = json.loads(info)
            except ValueError:
                info = {}
        info = info or {}
        result.seeds = info.get("all_seeds",
                                [body["seed"] + i for i in range(count)])
        result.subseeds = info.get("all_subseeds",
                                   [body["subseed"] + i for i in range(count)])
        result.prompts = info.get("all_prompts", [payload.prompt] * count)
        result.negative_prompts = info.get(
            "all_negative_prompts", [payload.negative_prompt] * count)
        result.infotexts = info.get("infotexts", [""] * count)
        result.worker_labels = [""] * len(result.images)
        return result

    def reachable(self) -> bool:
        try:
            status, _ = self._call("GET", "memory")
        except (OSError, http.client.HTTPException):
            return False
        return 200 <= status < 300

    def interrupt(self) -> None:
        self._call("POST", "interrupt")

    def restart(self) -> None:
        """POST /server-restart. A server that goes down before it answers
        drops the connection or never responds: both count as delivered;
        only failing to connect is a failure."""
        conn = self._connect(self.timeout)  # raises: never reached it
        try:
            self._exchange(conn, "POST", "server-restart", None)
        except (OSError, http.client.HTTPException):
            return  # went down (or stopped answering) to restart
        finally:
            conn.close()

    def load_options(self, model: str, vae: str = "") -> None:
        body = {"sd_model_checkpoint": model}
        if vae:
            body["sd_vae"] = vae
        self._json("POST", "options", body, timeout=600)

    def script_info(self) -> List[str]:
        names = []
        for entry in self._json("GET", "script-info"):
            if isinstance(entry, dict) and entry.get("name"):
                names.append(entry["name"])
            elif isinstance(entry, str):
                names.append(entry)
        return names

    def available_models(self) -> List[str]:
        return [m.get("model_name", m.get("title", "?"))
                for m in self._json("GET", "sd-models")]

    def memory_info(self) -> Dict[str, Any]:
        return self._json("GET", "memory")
