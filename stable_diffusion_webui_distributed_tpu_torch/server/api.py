"""sdapi-v1 HTTP server: one node of the fleet.

Port of the JAX package's ``server/api.py``. ``source`` executes payloads:
a ``World`` (``execute``: the fleet's fan-out) or a bare ``Engine``. As
there, a bare engine gets a serving dispatcher in front of it
(``serving/dispatcher.py``: shape bucketing, request coalescing, ragged
dispatch) unless ``SDTPU_SERVING=0``; a World keeps its own scheduler.

Routes, in webui's shapes: ``POST /sdapi/v1/txt2img`` and ``POST
/sdapi/v1/img2img`` (which needs ``init_images``), each request's
``styles`` expanded from ``<model_dir>/styles.csv`` and its script
(prompt matrix, prompts from file) expanded before anything runs; an
X/Y/Z plot bypasses the dispatcher and runs one generation per cell
(``pipeline/xyz.py``), each through the World on a fleet; ``GET
/sdapi/v1/samplers`` (the whole sampler table); ``GET /sdapi/v1/progress``
and ``POST /sdapi/v1/interrupt``; ``GET /sdapi/v1/memory`` (``ram`` and the
card's ``cuda`` section); ``GET``/``POST /sdapi/v1/options`` (a POST
records the options, and a World fans a model or VAE change out to its
remotes; a World whose local backend follows the ``registry`` switches
its checkpoint and standalone VAE there, blocking until the new engine is
built; any other node switches to no other model, and a model or VAE name
the node cannot serve answers 422 and changes nothing); ``GET
/sdapi/v1/sd-models`` (the registry's checkpoint files, or the served
models); ``GET /sdapi/v1/embeddings`` (the registry's textual-inversion
files); ``GET /sdapi/v1/script-info``
(the scripts the port runs: ControlNet, prompt matrix, prompts from file
or textbox, X/Y/Z plot); ``POST /sdapi/v1/refresh-checkpoints`` and ``POST
/sdapi/v1/refresh-loras`` (rescan the ``registry``'s directories;
``<lora:...>`` tags are served by the engine); ``POST
/sdapi/v1/server-restart``; ``GET /internal/workers`` and ``POST
/internal/benchmark`` for a World; the operator's surface: ``GET /`` (the
control panel, ``server/panel.py``), ``POST /internal/workers``
(``action`` add, update or remove: validated before anything changes, a
checkpoint pin probed against the endpoint the edit would leave, 422 for
a pin the node does not serve, the password never sent back), ``POST
/internal/worker-models`` (one worker's model list), ``POST
/internal/reset-mpe`` (every worker's ETA error history cleared), ``POST
/internal/restart-all`` and ``POST /internal/user-script`` (400 without a
fleet); ``GET /internal/cache`` (the caching
tier's summary, ``{"enabled": false}`` unless ``SDTPU_CACHE=1``); ``GET
/internal/autoscale`` (the autoscaler's decision audit, ``{"active":
false}`` without one); ``POST /internal/cancel`` (``{"request_id"}``,
422 without it: drops that request's images from its coalesced group,
answering ``{"cancelled": bool}``; a client makes its request addressable
by a ``request_id`` in its payload, which becomes the dispatcher's ticket
id); ``GET /internal/journal[?request_id=]`` (the request journal, ``obs/
journal.py``; ``enabled`` false unless ``SDTPU_JOURNAL=1``); ``GET
/internal/sim`` (the scenario engine's gate, the journal sink and the
armed chaos plan).

The request-observability plane (``obs/``): every generation request runs
under a request context whose id the client gives (``request_id`` in the
payload, or the ``X-SDTPU-Request-Id`` header a master's ``HTTPBackend``
sends) or the server mints, pinned onto the payload so the dispatcher,
the flight recorder and the log lines agree on it. ``GET
/internal/status`` (workers, World settings, the dispatcher's metrics,
ladders and fleet, the warm pool, the tracer's summary, progress, stage
timings and the log ring); ``GET /internal/trace.json`` (every kept
request's spans as Chrome trace events, for Perfetto); ``GET
/internal/metrics`` (Prometheus text exposition 0.0.4); ``GET
/internal/flightrec`` (the failed, interrupted, slow and stalled
requests); ``GET /internal/perf`` (the perf ledger, ``SDTPU_PERF``);
``POST /internal/profile`` (``{"action": "start" | "stop", "dir":
name}``) and ``GET /internal/profile?seconds=N&dir=name``: a
``torch.profiler`` capture written as a Chrome trace under
``./profile-traces/<basename of name>``.

The fleet telemetry plane (``obs/``): ``GET /internal/stitched-trace.json``
(this node's spans with each remote's, on this node's clock), ``GET
/internal/tsdb`` (the metric history, ``SDTPU_TSDB``), ``GET
/internal/alerts`` (the alert engine, ``SDTPU_ALERTS``), ``GET
/internal/fleet`` (the federated view, ``SDTPU_FEDERATION``), ``GET
/internal/fleet/timeline[?request_id=]`` (the fleet-merged journal), ``GET
/internal/deltas?cursor=N[&wait_s=]`` (the push plane's feed: 404 with
``SDTPU_PUSH`` off, 422 on a bad cursor, a hold of at most 5 s), ``GET
/internal/push`` (the push plane's status) and ``GET
/internal/executables`` (the census of the dispatcher's engine's CUDA
graphs against the serving budget). With ``SDTPU_FLEET`` a request the fleet refuses
(its tenant's quota, or an SLO no degrade rung meets) answers 429 with a
``Retry-After`` header. A request for something the port does not run
answers 422. Optional Basic auth. Served by the standard
library's ``ThreadingHTTPServer``; ``port=0`` binds a free port.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit
from typing import Any, Dict, Optional, Tuple

import torch
from pydantic import ValidationError

from stable_diffusion_webui_distributed_tpu_torch import cache, sim
from stable_diffusion_webui_distributed_tpu_torch.fleet import slices
from stable_diffusion_webui_distributed_tpu_torch.fleet.admission import (
    FleetRejected,
)
from stable_diffusion_webui_distributed_tpu_torch.fleet import (
    pool as fleet_pool,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    alerts as obs_alerts,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    federation as obs_federation,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    fleetlog as obs_fleetlog,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    flightrec as obs_flightrec,
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
    push as obs_push,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    spans as obs_spans,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    stitch as obs_stitch,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    tsdb as obs_tsdb,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
    GenerationResult,
    Unsupported,
    apply_scripts,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.registry import (
    AUTOMATIC_VAES,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.styles import (
    apply_styles,
    load_styles,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.xyz import (
    is_xyz,
    run_xyz,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import (
    interrupt as interrupt_mod,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import trace
from stable_diffusion_webui_distributed_tpu_torch.runtime.logging import (
    get_ring_buffer,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    env_flag,
)
from stable_diffusion_webui_distributed_tpu_torch.samplers.kdiffusion import (
    SAMPLERS,
)
from stable_diffusion_webui_distributed_tpu_torch.scheduler.worker import (
    State,
    cuda_memory,
)
from stable_diffusion_webui_distributed_tpu_torch.serving.dispatcher import (
    ServingDispatcher,
)
from stable_diffusion_webui_distributed_tpu_torch.server.panel import (
    PANEL_HTML,
)
from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
    METRICS,
)

log = logging.getLogger(__name__)

#: seconds a World without a local engine waits for its workers' model
#: lists (asked all at once) before it checks a model name
MODEL_LIST_TIMEOUT = 2.0


class TextResponse(str):
    """A handler's answer sent as plain text, not JSON (the Prometheus
    exposition's content type)."""

    content_type = "text/plain; version=0.0.4; charset=utf-8"


class HtmlResponse(TextResponse):
    """A handler's answer sent as an HTML page (the panel)."""

    content_type = "text/html; charset=utf-8"


class ApiError(Exception):
    def __init__(self, status: int, detail: str,
                 headers: Optional[Dict[str, str]] = None):
        super().__init__(detail)
        self.status = status
        self.detail = detail
        self.headers = headers or {}


class ApiServer:
    """One generation node's REST surface over ``source`` (a ``World`` or
    an ``Engine``); ``registry`` is the ``ModelRegistry`` whose files the
    engine's providers serve (None: nothing to rescan). Models switch
    through it when a World's local backend follows it (``cli serve``
    builds it so)."""

    def __init__(self, source, host: str = "127.0.0.1", port: int = 7860,
                 user: Optional[str] = None, password: Optional[str] = None,
                 registry=None):
        self.source = source
        self.registry = registry
        self.state = getattr(source, "state", None) or interrupt_mod.STATE
        self.host = host
        self.port = port
        self._auth = None
        if user or password:
            token = base64.b64encode(
                f"{user or ''}:{password or ''}".encode()).decode()
            self._auth = f"Basic {token}"
        self.options: Dict[str, Any] = {
            "sd_model_checkpoint": getattr(source, "current_model", "")
            or getattr(source, "model_name", ""),
            "sd_vae": "Automatic",
            "CLIP_stop_at_last_layers": 1,
        }
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._busy = threading.Lock()  # one fleet request at a time
        self._benchmarking = threading.Lock()
        self.restart_requested = False
        # styles.csv by (path, mtime)
        self._styles_cache: Tuple = ((None, None), {})
        # continuous-batching front end for a bare engine; a World keeps
        # its fleet scheduler; SDTPU_SERVING=0 calls the engine directly
        self.dispatcher = None
        if not hasattr(source, "execute") \
                and env_flag("SDTPU_SERVING", True):
            self.dispatcher = ServingDispatcher(source)

    def _engine(self):
        """The engine behind the source: the engine itself, or the first
        local backend's of a World (None for a thin client)."""
        if not hasattr(self.source, "execute"):
            return self.source
        return next((w.backend.engine
                     for w in self.source.workers_snapshot()
                     if hasattr(w.backend, "engine")), None)

    # -- handlers ------------------------------------------------------------

    @staticmethod
    def _generation_response(result: GenerationResult) -> Dict[str, Any]:
        info = {
            "all_seeds": result.seeds,
            "all_subseeds": result.subseeds,
            "all_prompts": result.prompts,
            "all_negative_prompts": result.negative_prompts,
            "infotexts": result.infotexts,
            "seed": result.seeds[0] if result.seeds else -1,
            "subseed": result.subseeds[0] if result.subseeds else -1,
        }
        return {"images": result.images, "parameters": result.parameters,
                # webui encodes info as a JSON string
                "info": json.dumps(info)}

    def handle_txt2img(self, body: Dict[str, Any]) -> Dict[str, Any]:
        return self._generate(body, "txt2img")

    def handle_img2img(self, body: Dict[str, Any]) -> Dict[str, Any]:
        return self._generate(body, "img2img")

    def _apply_styles(self, payload: GenerationPayload) -> None:
        """Expand the payload's style names from the registry's
        ``styles.csv`` (the working directory's without a registry),
        read again when its mtime changes."""
        if not payload.styles:
            return
        path = os.path.join(getattr(self.registry, "model_dir", "."),
                            "styles.csv")
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            mtime = None
        if self._styles_cache[0] != (path, mtime):
            self._styles_cache = ((path, mtime), load_styles(path))
        apply_styles(payload, self._styles_cache[1])

    def _execute(self, payload: GenerationPayload,
                 job: str = "txt2img") -> GenerationResult:
        """One generation through the World, or the bare engine as the
        top-level request."""
        if hasattr(self.source, "execute"):
            return self.source.execute(payload)  # resets the latch
        self.state.begin_request()
        return self.source.generate_range(apply_scripts(payload), job=job)

    def _run_scripted(self, payload: GenerationPayload,
                      job: str) -> GenerationResult:
        """An X/Y/Z plot runs one full generation per cell; anything else
        one generation."""
        if is_xyz(payload):
            try:
                return run_xyz(payload, lambda p: self._execute(p, job),
                               known_samplers=list(SAMPLERS))
            except ValueError as e:
                raise ApiError(422, str(e))
        return self._execute(payload, job)

    def _generate(self, body: Dict[str, Any], job: str) -> Dict[str, Any]:
        """A generation request: styles and scripts expanded, then through
        the dispatcher (an X/Y/Z plot on ``txt2img`` bypasses it, as in the
        JAX package), the World or the bare engine."""
        try:
            payload = GenerationPayload(**body)
            if job == "img2img" and not payload.init_images:
                raise Unsupported("img2img requires init_images")
            self._apply_styles(payload)
            # expanded before anything runs, so that invalid input (a
            # prompt matrix past its cap) answers 422; the World's and the
            # engine's expansion of the result changes nothing
            try:
                payload = apply_scripts(payload)
            except ValueError as e:
                raise ApiError(422, str(e))
            with self._mint_request(payload, f"/sdapi/v1/{job}"):
                if self.dispatcher is not None and not (
                        job == "txt2img" and is_xyz(payload)):
                    # the dispatcher serializes execution itself, so that
                    # concurrent compatible requests can merge in its
                    # window
                    result = self._submit_dispatch(payload, job)
                else:
                    with self._busy:
                        result = self._run_scripted(payload, job)
        except (ValidationError, Unsupported) as e:
            raise ApiError(422, str(e))
        return self._generation_response(result)

    @staticmethod
    def _mint_request(payload: GenerationPayload, route: str):
        """The root request context of one generation request: the
        payload's ``request_id``, else a new one, pinned back onto the
        payload."""
        rid = str(getattr(payload, "request_id", "") or uuid.uuid4().hex)
        payload.request_id = rid
        return obs_spans.request(rid, name=route.rsplit("/", 1)[-1],
                                 route=route)

    def _submit_dispatch(self, payload: GenerationPayload,
                         job: str) -> GenerationResult:
        """The dispatcher's submit, a fleet refusal (quota or SLO,
        ``fleet/admission.py``) answered as 429 with ``Retry-After``."""
        try:
            return self.dispatcher.submit(payload, job=job)
        except FleetRejected as e:
            raise ApiError(429, e.detail, headers={
                "Retry-After": str(max(1, round(e.retry_after)))})

    def handle_samplers(self) -> Any:
        return [{"name": n, "aliases": [], "options": {}}
                for n in SAMPLERS]

    def handle_progress(self) -> Dict[str, Any]:
        p = self.state.progress_snapshot()
        eta = p.eta_seconds()
        return {
            "progress": p.fraction,
            "eta_relative": eta if eta is not None else 0.0,
            "state": {"job": p.job, "sampling_step": p.sampling_step,
                      "sampling_steps": p.sampling_steps,
                      "interrupted": p.interrupted},
            "current_image": None,
            "textinfo": None,
        }

    def handle_interrupt(self) -> Dict[str, Any]:
        self.state.flag.interrupt()
        if hasattr(self.source, "interrupt_all"):
            self.source.interrupt_all()
        return {}

    def handle_memory(self) -> Dict[str, Any]:
        """``ram`` from ``/proc/meminfo`` and webui's ``cuda`` section for
        the engine's card (zeros without one)."""
        out: Dict[str, Any] = {}
        try:
            with open("/proc/meminfo") as f:
                mem = {line.split(":")[0]: int(line.split()[1]) * 1024
                       for line in f if ":" in line}
            total = mem.get("MemTotal", 0)
            free = mem.get("MemAvailable", 0)
            out["ram"] = {"free": free, "used": total - free, "total": total}
        except OSError:
            out["ram"] = {}
        engine = self._engine()
        device = getattr(engine, "device", torch.device("cpu"))
        out["cuda"] = (cuda_memory(device) if device.type == "cuda" else
                       {"system": {"free": 0, "used": 0, "total": 0}})
        return out

    def handle_options_get(self) -> Dict[str, Any]:
        return dict(self.options)

    def handle_options_post(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """Record the options; switch the checkpoint and the standalone VAE
        where the node's engine follows the registry (a blocking load, as
        webui's; the standing ``sd_vae`` applies to a new engine too); fan a
        model or VAE change out to a World's remotes, and apply scheduler
        settings (bare or ``distributed_``-prefixed) live to it. A model or
        VAE this node cannot serve answers 422 before anything is recorded,
        loaded or fanned out."""
        model = body.get("sd_model_checkpoint")
        vae = body.get("sd_vae")
        self._check_servable(model, vae)
        registry = self._switching_registry()
        if registry is not None and (model or vae is not None):
            # after the fleet request in flight, whose engine is dropped
            with self._busy:
                if model:
                    registry.activate(model)
                standing = vae if vae is not None else \
                    self.options.get("sd_vae", "")
                registry.set_vae(standing or "")
        if model:
            self.options["sd_model_checkpoint"] = model
        if (model or vae is not None) and hasattr(self.source, "sync_models"):
            sync_model = model or self.options.get("sd_model_checkpoint", "")
            sync_vae = _vae_for_sync(vae if vae is not None else
                                     self.options.get("sd_vae", ""))
            if model:
                self.source.current_model = sync_model
            if vae is not None:
                self.source.current_vae = sync_vae
            if sync_model:
                self.source.sync_models(sync_model, sync_vae)
        if hasattr(self.source, "apply_settings"):
            settings = {}
            for key in ("job_timeout", "complement_production",
                        "step_scaling", "thin_client_mode"):
                if key in body:
                    settings[key] = body[key]
                elif f"distributed_{key}" in body:
                    settings[key] = body[f"distributed_{key}"]
            if settings:
                self.source.apply_settings(settings)
        for k, v in body.items():
            if k != "sd_model_checkpoint":
                self.options[k] = v
        return {}

    def _switching_registry(self):
        """The registry when a local backend of the World follows it (its
        model switch then reaches the engine that generates), else None."""
        if self.registry is None or not hasattr(self.source,
                                                "workers_snapshot"):
            return None
        for w in self.source.workers_snapshot():
            if getattr(w.backend, "registry", None) is self.registry:
                return self.registry
        return None

    def _served_models(self) -> Optional[set]:
        """The model names this node serves: the switching registry's, its
        engine's, or for a World without a local engine the names its
        workers list (None when none answers: nothing to check against).
        The workers are asked all at once, those the last ping found
        unavailable not at all, and a list that takes longer than
        :data:`MODEL_LIST_TIMEOUT` is not waited for."""
        registry = self._switching_registry()
        if registry is not None:
            return set(registry.model_names())
        engine = self._engine()
        if engine is not None:
            return {engine.model_name}
        names: set = set()
        lock = threading.Lock()

        def ask(w):
            try:
                listed = w.backend.available_models()
            except Exception:  # noqa: BLE001 — an unreachable worker
                log.debug("worker %s lists no models", w.label)
                return
            with lock:
                names.update(listed)

        threads = [threading.Thread(target=ask, args=(w,), daemon=True)
                   for w in self.source.workers_snapshot()
                   if w.current_state() != State.UNAVAILABLE]
        for t in threads:
            t.start()
        deadline = time.monotonic() + MODEL_LIST_TIMEOUT
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        with lock:
            return set(names) or None

    def _check_servable(self, model: Optional[str],
                        vae: Optional[str]) -> None:
        """A model must be one the node serves (a checkpoint of the
        switching registry, which takes file names too); a standalone VAE
        needs the switching registry and one of its VAE files. Anything
        else would be answered with another model's images."""
        registry = self._switching_registry()
        if vae is not None and vae not in AUTOMATIC_VAES:
            if registry is None:
                raise ApiError(422, f"sd_vae {vae!r}: this node serves its "
                                    f"checkpoint's own VAE only")
            if registry.vae_path(vae) is None:
                raise ApiError(422, f"sd_vae {vae!r}: no such VAE in "
                                    f"{sorted(registry.available_vaes())}")
        if not model:
            return
        if registry is not None and registry.checkpoint_path(model):
            return
        served = self._served_models()
        if served is not None and model not in served:
            raise ApiError(422, f"sd_model_checkpoint {model!r}: this node "
                                f"serves {sorted(served)}")

    def handle_sd_models(self) -> Any:
        """The switching registry's checkpoints (the active engine first
        when no file has it), else the models this node serves
        (``unknown`` when it cannot tell)."""
        registry = self._switching_registry()
        if registry is not None:
            paths = registry.available()
            return [{"title": name, "model_name": name,
                     "filename": paths.get(name, ""), "hash": None,
                     "sha256": None} for name in registry.model_names()]
        names = sorted(self._served_models() or {
            self.options.get("sd_model_checkpoint") or "unknown"})
        return [{"title": name, "model_name": name, "filename": "",
                 "hash": None, "sha256": None} for name in names]

    def handle_embeddings(self) -> Dict[str, Any]:
        """webui's ``GET /sdapi/v1/embeddings``: the loaded embeddings
        with their width and vector count, an unloadable file under
        ``skipped``: the registry's store (none without a registry)."""
        loaded: Dict[str, Any] = {}
        skipped: Dict[str, Any] = {}
        store = getattr(self.registry, "embedding_store", None)
        if store is not None:
            for name in store.names():
                e = store.lookup(name)
                if e is None:
                    skipped[name] = {}
                    continue
                loaded[name] = {
                    "step": None, "sd_checkpoint": None,
                    "sd_checkpoint_name": None,
                    "shape": int(e.clip_l.shape[1]),
                    "vectors": int(e.n_vectors),
                }
        return {"loaded": loaded, "skipped": skipped}

    def handle_script_info(self) -> Any:
        # a master strips the alwayson-script args a node does not list;
        # the selectable scripts expand here (payload.apply_scripts, xyz)
        return [
            {"name": "controlnet", "is_alwayson": True, "is_img2img": True,
             "args": []},
            {"name": "prompt matrix", "is_alwayson": False,
             "is_img2img": False, "args": []},
            {"name": "prompts from file or textbox", "is_alwayson": False,
             "is_img2img": False, "args": []},
            {"name": "x/y/z plot", "is_alwayson": False,
             "is_img2img": True, "args": []},
        ]

    def handle_refresh(self) -> Dict[str, Any]:
        """Rescan the registry's directories: a checkpoint, VAE, ControlNet
        or adapter added since is served, and the engine's latch retries
        the adapter names it skipped."""
        if self.registry is not None:
            self.registry.refresh()
        return {}

    def handle_server_restart(self) -> Dict[str, Any]:
        """Flag the serving process to re-exec itself (the CLI's ``serve``
        does) and stop serving."""
        self.restart_requested = True
        threading.Thread(target=self._shutdown_later, daemon=True).start()
        return {}

    def _shutdown_later(self):
        time.sleep(0.2)
        self.stop()

    def handle_workers(self) -> Any:
        """The fleet's workers: state, speed, caps, health, endpoint
        (the password is never sent back)."""
        if not hasattr(self.source, "workers_snapshot"):
            return []
        return [_worker_dict(w) for w in self.source.workers_snapshot()]

    def _find_worker(self, label: str):
        """The worker of ``label``, or None (a bare engine has none)."""
        get = getattr(self.source, "get_worker", None)
        return get(label) if get is not None else None

    def handle_reset_mpe(self) -> Dict[str, Any]:
        """Clear every worker's ETA error history (the reference's 'reset
        mpe' button) and save the config."""
        cleared = []
        if hasattr(self.source, "workers_snapshot"):
            # under _busy: the save must not interleave with the one at
            # the end of a generation (both write the same .tmp file)
            with self._busy:
                for w in self.source.workers_snapshot():
                    if w.cal.eta_percent_error:
                        w.cal.eta_percent_error.clear()
                        cleared.append(w.label)
                self.source.save_config()
        return {"cleared": cleared}

    def handle_user_script(self) -> Dict[str, Any]:
        """Run the operator's ``sync*`` script from ``<config
        dir>/user/`` (``World.run_user_script``)."""
        if not hasattr(self.source, "run_user_script"):
            raise ApiError(400, "no fleet attached to this node")
        return {"ran": self.source.run_user_script()}

    def handle_restart_all(self) -> Dict[str, Any]:
        """Ask every enabled remote to restart (the reference's 'Restart
        All Workers'; the panel confirms first, an API caller is its own
        confirmation)."""
        if not hasattr(self.source, "restart_all"):
            raise ApiError(400, "no fleet attached to this node")
        return {"restarted": self.source.restart_all()}

    def handle_workers_post(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """Worker edits, live and persisted: ``action`` "update" (the
        default: ``model_override``, ``pixel_cap``, ``disabled`` and the
        endpoint fields), "add" (``label``, ``address``, ``port``, ``tls``,
        ``user``, ``password``, ``pixel_cap``) or "remove". Everything is
        validated before anything changes; the password is never sent
        back."""
        if not hasattr(self.source, "configure_worker"):
            raise ApiError(400, "no fleet attached to this node")
        label = body.get("label", "")
        if not label:
            raise ApiError(422, "label required")
        action = body.get("action", "update")
        if action == "add":
            try:
                with self._busy:
                    self.source.add_remote_worker(
                        label, body.get("address", ""),
                        int(body.get("port", 7860)),
                        tls=bool(body.get("tls", False)),
                        user=body.get("user") or None,
                        password=body.get("password") or None,
                        pixel_cap=int(body.get("pixel_cap", 0)))
            except (ValueError, TypeError) as e:
                raise ApiError(422, str(e))
            return {"added": label}
        if action == "remove":
            try:
                with self._busy:
                    ok = self.source.remove_worker(label)
            except ValueError as e:
                raise ApiError(422, str(e))
            if not ok:
                raise ApiError(404, f"no worker '{label}'")
            return {"removed": label}
        if action != "update":
            raise ApiError(422, f"unknown action '{action}'")
        endpoint = {k: body[k] for k in
                    ("address", "port", "tls", "user", "password")
                    if k in body}
        kwargs = {k: body[k] for k in
                  ("model_override", "pixel_cap", "disabled") if k in body}
        # validate before any change, a pin against the endpoint the edit
        # would leave: a 422 must not leave the edit half applied
        pin_validated = None
        if kwargs.get("model_override"):
            pin_validated = self._validate_model_pin(
                label, kwargs["model_override"], endpoint or None)
        if endpoint and not hasattr(self.source, "update_worker_endpoint"):
            raise ApiError(
                422, "this server's worker source does not support "
                f"endpoint edits (fields: {', '.join(sorted(endpoint))})")
        if endpoint:
            try:
                with self._busy:
                    ok = self.source.update_worker_endpoint(label, **endpoint)
            except (ValueError, TypeError) as e:
                raise ApiError(422, str(e))
            if not ok:
                raise ApiError(404, f"no worker '{label}'")
        if kwargs or not endpoint:
            with self._busy:
                ok = self.source.configure_worker(label, **kwargs)
            if not ok:
                raise ApiError(404, f"no worker '{label}'")
        if pin_validated is not None:
            # configure_worker reset the provenance to False: True only
            # when the node's model list held the pin (ping_workers
            # re-checks an unvalidated one)
            w = self._find_worker(label)
            if w is not None and w.model_override:
                w.pin_validated = pin_validated
        endpoint.pop("password", None)
        return {"updated": label, **endpoint, **kwargs}

    def _validate_model_pin(self, label: str, pin: str,
                            endpoint: Optional[Dict[str, Any]] = None
                            ) -> bool:
        """422 for a checkpoint pin the worker does not serve (its
        ``/sd-models``, probed at the endpoint the pending ``endpoint``
        edits would give). True on a positive match; False when the node
        cannot be asked or lists no model: the pin is then accepted
        unvalidated."""
        w = self._find_worker(label)
        if w is None:
            return False
        backend = w.backend
        if endpoint and hasattr(self.source, "candidate_backend"):
            try:
                candidate = self.source.candidate_backend(label, **endpoint)
            except (ValueError, TypeError):
                return False  # the edit itself answers 422 for these
            if candidate is not None:
                backend = candidate
        try:
            models = backend.available_models()
        except Exception:  # noqa: BLE001 — node down: accept unvalidated
            log.warning("worker '%s' unreachable; accepting pin '%s' "
                        "UNVALIDATED", label, pin)
            return False
        if models and pin not in models:
            raise ApiError(
                422, f"worker '{label}' does not serve model '{pin}' "
                f"(available: {', '.join(models[:20])})")
        return bool(models)

    def handle_worker_models(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """One worker's model list (the panel's pin dropdown), or none and
        the error when its node is down."""
        label = body.get("label", "")
        w = self._find_worker(label)
        if w is None:
            raise ApiError(404, f"no worker '{label}'")
        try:
            return {"label": label, "models": w.backend.available_models()}
        except Exception as e:  # noqa: BLE001 — node down
            return {"label": label, "models": [], "error": str(e)}

    def handle_panel(self) -> "HtmlResponse":
        """The operator's control panel (``server/panel.py``)."""
        return HtmlResponse(PANEL_HTML)

    def handle_benchmark(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """Start a fleet benchmark sweep in the background; returns at
        once (the speeds update as it goes)."""
        if not hasattr(self.source, "benchmark_all"):
            raise ApiError(400, "no fleet attached to this node")
        # released by the sweep's thread: a double click starts one sweep
        if not self._benchmarking.acquire(blocking=False):
            return {"started": False, "reason": "benchmark already running"}

        def run():
            try:
                self.source.benchmark_all(
                    rebenchmark=bool(body.get("rebenchmark", True)))
            except Exception:  # noqa: BLE001 — a background sweep reports
                log.exception("benchmark sweep failed")
            finally:
                self._benchmarking.release()

        threading.Thread(target=run, daemon=True,
                         name="benchmark-sweep").start()
        return {"started": True}

    def handle_cache(self) -> Dict[str, Any]:
        """The caching tier's counts per layer (``cache.summary``), or
        ``{"enabled": False}`` with the gate off."""
        if not cache.enabled():
            return {"enabled": False}
        return cache.summary()

    def handle_autoscale(self) -> Dict[str, Any]:
        """The autoscaler's decision audit (``fleet/slices.py``): the
        bounded ring of every scale decision with its wall-clock time and
        its execution outcome."""
        engine = slices.get_autoscale()
        if engine is None:
            return {"active": False}
        return engine.audit()

    def handle_cancel(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """Per-request cancel (``/interrupt`` latches the whole engine):
        the request's images are dropped when its group is split, and the
        requests batched with it are unaffected."""
        rid = str(body.get("request_id", "") or "")
        if not rid:
            raise ApiError(422, "request_id required")
        cancelled = (self.dispatcher is not None
                     and self.dispatcher.cancel(rid))
        return {"cancelled": cancelled}

    def handle_journal(self, query: Dict[str, str]) -> Dict[str, Any]:
        """The request journal; ``?request_id=`` narrows it to one
        request's events."""
        return obs_journal.JOURNAL.snapshot(query.get("request_id") or None)

    def handle_sim(self) -> Dict[str, Any]:
        """The scenario engine's state (``sim.summary``); ``enabled`` is
        false until ``SDTPU_SIM=1``, the document is always served."""
        return sim.summary()

    def handle_internal_status(self) -> Dict[str, Any]:
        """What a status panel shows: the fleet's workers and settings,
        the dispatcher's metrics, ladders and fleet, the warm pool, the
        tracer, progress, stage timings and the log ring."""
        workers = []
        if hasattr(self.source, "workers_snapshot"):
            workers = [_worker_dict(w)
                       for w in self.source.workers_snapshot()]
        p = self.state.progress_snapshot()
        settings = None
        if hasattr(self.source, "job_timeout"):
            settings = {
                "job_timeout": self.source.job_timeout,
                "complement_production": getattr(
                    self.source, "complement_production", True),
                "step_scaling": getattr(self.source, "step_scaling", False),
                "thin_client_mode": getattr(
                    self.source, "thin_client_mode", False),
            }
        serving = None
        if self.dispatcher is not None:
            serving = METRICS.summary()
            serving["coalesce_window_s"] = self.dispatcher.window
            serving["bucket_ladder"] = [
                f"{w}x{h}" for w, h in self.dispatcher.bucketer.shapes]
            serving["batch_ladder"] = list(self.dispatcher.bucketer.batches)
            serving["eta_overhead"] = self.dispatcher.eta_overhead()
            serving["fleet"] = self.dispatcher.fleet_summary()
        obs = obs_spans.TRACER.summary()
        obs["flightrec_entries"] = len(obs_flightrec.RECORDER)
        active_pool = fleet_pool.get_pool()
        pool_block = active_pool.summary() if active_pool is not None \
            else {"enabled": fleet_pool.enabled()}
        return {
            "model": self.options.get("sd_model_checkpoint", ""),
            "workers": workers,
            "settings": settings,
            "serving": serving,
            "pool": pool_block,
            "obs": obs,
            "progress": {
                "job": p.job,
                "sampling_step": p.sampling_step,
                "sampling_steps": p.sampling_steps,
                "fraction": p.fraction,
                "interrupted": p.interrupted,
            },
            "timings": trace.STATS.summary(),
            "logs": get_ring_buffer().dump(),
        }

    def handle_trace_json(self) -> Dict[str, Any]:
        """Every kept request trace as Chrome trace events (load the body
        in Perfetto or chrome://tracing)."""
        return obs_spans.TRACER.export_chrome()

    def handle_metrics(self) -> TextResponse:
        """The Prometheus text exposition."""
        return TextResponse(obs_prom.render())

    def handle_flightrec(self) -> Dict[str, Any]:
        """The flight recorder: the last failed, interrupted, slow or
        stalled requests with their spans and log lines."""
        return obs_flightrec.RECORDER.dump()

    def handle_perf(self) -> Dict[str, Any]:
        """The perf ledger's summary (empty until ``SDTPU_PERF=1``)."""
        return obs_perf.LEDGER.summary()

    @staticmethod
    def _profile_dir(name: Any) -> str:
        """``./profile-traces/<basename>``: a client names a capture, never
        where it lands."""
        base = os.path.basename(str(name or "trace"))
        if base in ("", ".", ".."):
            base = "trace"
        return os.path.join("profile-traces", base)

    def handle_profile(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """Start or stop a ``torch.profiler`` capture
        (``runtime/trace.py``)."""
        action = body.get("action", "")
        if action == "start":
            log_dir = self._profile_dir(body.get("dir"))
            return {"started": trace.start_trace(log_dir), "dir": log_dir}
        if action == "stop":
            return {"stopped_dir": trace.stop_trace()}
        raise ApiError(422, "action must be 'start' or 'stop'")

    def handle_profile_get(self, query: Dict[str, str]) -> Dict[str, Any]:
        """A capture of ``?seconds=N`` (0.1 to 60) into ``?dir=``."""
        try:
            seconds = float(query.get("seconds", "1"))
        except ValueError:
            raise ApiError(422, "seconds must be a number")
        seconds = min(60.0, max(0.1, seconds))
        log_dir = self._profile_dir(query.get("dir"))
        if not trace.start_trace(log_dir):
            raise ApiError(409, "a profiler capture is already running")
        time.sleep(seconds)
        return {"captured_dir": trace.stop_trace(), "seconds": seconds}

    def handle_stitched_trace(self) -> Dict[str, Any]:
        """The master's spans merged with every reachable remote's trace,
        each shifted by its clock offset and tagged
        ``pid="worker:<label>"`` (``obs/stitch.py``)."""
        return obs_stitch.stitch(self.source)

    def handle_tsdb(self) -> Dict[str, Any]:
        """The metric-history store (``obs/tsdb.py``); ``enabled`` is false
        until ``SDTPU_TSDB=1``, the document is always served."""
        return obs_tsdb.summary()

    def handle_alerts(self) -> Dict[str, Any]:
        """The alert engine (``obs/alerts.py``): the rule registry, each
        rule's state and the transition history."""
        return obs_alerts.summary()

    def handle_fleet(self) -> Dict[str, Any]:
        """The federated fleet view (``obs/federation.py``): each worker's
        poll and staleness status and the fleet's latest aggregates."""
        return obs_federation.summary()

    def handle_fleet_timeline(self, query: Dict[str, str]) -> Dict[str, Any]:
        """The fleet-merged journal timeline (``obs/fleetlog.py``);
        ``?request_id=`` narrows it to one request's cross-node story."""
        return obs_fleetlog.timeline(query.get("request_id") or None)

    def handle_deltas(self, query: Dict[str, str]) -> Dict[str, Any]:
        """The push plane's worker feed (``obs/push.py``): ``?cursor=N``
        long-polls (``?wait_s=``, at most 5 s) for the journal events, TSDB
        samples and counter totals after N. 404 with ``SDTPU_PUSH`` off: a
        master reads that as "poll this node"."""
        if not obs_push.enabled():
            raise ApiError(404, "push plane disabled (SDTPU_PUSH=0)")
        try:
            cursor = int(query.get("cursor", "0"))
        except ValueError:
            raise ApiError(422, "cursor must be an integer")
        try:
            hold = float(query.get("wait_s", str(obs_push.wait_s())))
        except ValueError:
            raise ApiError(422, "wait_s must be a number")
        return obs_push.serve_deltas(cursor,
                                     hold_s=min(5.0, max(0.0, hold)))

    def handle_push(self) -> Dict[str, Any]:
        """The push plane's status (``obs/push.py``): each subscriber's
        mode, cursor and loss and duplicate counts, and the worker-side
        buffer; always served."""
        return obs_push.summary()

    def handle_executables(self) -> Dict[str, Any]:
        """The census of the dispatcher's engine's CUDA graphs against the
        serving budget per shape bucket (``obs/perf.py``); ``alarm`` trips
        when a bucket passes it. ``{"available": false}`` without a
        dispatcher (a World's node)."""
        engine = getattr(self.dispatcher, "engine", None) \
            if self.dispatcher is not None else None
        if engine is None or not hasattr(engine, "executable_keys"):
            return {"available": False}
        census = obs_perf.executables_census(engine)
        census["available"] = True
        return census

    def routes(self):
        return {
            ("POST", "/sdapi/v1/txt2img"): self.handle_txt2img,
            ("POST", "/sdapi/v1/img2img"): self.handle_img2img,
            ("GET", "/sdapi/v1/samplers"): self.handle_samplers,
            ("GET", "/sdapi/v1/progress"): self.handle_progress,
            ("POST", "/sdapi/v1/interrupt"): self.handle_interrupt,
            ("GET", "/sdapi/v1/memory"): self.handle_memory,
            ("GET", "/sdapi/v1/options"): self.handle_options_get,
            ("POST", "/sdapi/v1/options"): self.handle_options_post,
            ("GET", "/sdapi/v1/sd-models"): self.handle_sd_models,
            ("GET", "/sdapi/v1/embeddings"): self.handle_embeddings,
            ("GET", "/sdapi/v1/script-info"): self.handle_script_info,
            ("POST", "/sdapi/v1/refresh-checkpoints"): self.handle_refresh,
            ("POST", "/sdapi/v1/refresh-loras"): self.handle_refresh,
            ("POST", "/sdapi/v1/server-restart"): self.handle_server_restart,
            ("GET", ""): self.handle_panel,  # "/", its slash stripped
            ("GET", "/internal/workers"): self.handle_workers,
            ("POST", "/internal/workers"): self.handle_workers_post,
            ("POST", "/internal/worker-models"): self.handle_worker_models,
            ("POST", "/internal/reset-mpe"): self.handle_reset_mpe,
            ("POST", "/internal/restart-all"): self.handle_restart_all,
            ("POST", "/internal/user-script"): self.handle_user_script,
            ("POST", "/internal/benchmark"): self.handle_benchmark,
            ("GET", "/internal/cache"): self.handle_cache,
            ("GET", "/internal/autoscale"): self.handle_autoscale,
            ("POST", "/internal/cancel"): self.handle_cancel,
            ("GET", "/internal/journal"): self.handle_journal,
            ("GET", "/internal/sim"): self.handle_sim,
            ("GET", "/internal/status"): self.handle_internal_status,
            ("GET", "/internal/trace.json"): self.handle_trace_json,
            ("GET", "/internal/metrics"): self.handle_metrics,
            ("GET", "/internal/flightrec"): self.handle_flightrec,
            ("GET", "/internal/perf"): self.handle_perf,
            ("GET", "/internal/stitched-trace.json"):
                self.handle_stitched_trace,
            ("GET", "/internal/tsdb"): self.handle_tsdb,
            ("GET", "/internal/alerts"): self.handle_alerts,
            ("GET", "/internal/fleet"): self.handle_fleet,
            ("GET", "/internal/fleet/timeline"): self.handle_fleet_timeline,
            ("GET", "/internal/deltas"): self.handle_deltas,
            ("GET", "/internal/push"): self.handle_push,
            ("GET", "/internal/executables"): self.handle_executables,
            ("GET", "/internal/profile"): self.handle_profile_get,
            ("POST", "/internal/profile"): self.handle_profile,
        }

    # -- HTTP ----------------------------------------------------------------

    def make_handler(self):
        routes = self.routes()
        auth = self._auth

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                log.debug("http: " + fmt, *args)

            def _dispatch(self, method: str):
                if auth is not None \
                        and self.headers.get("Authorization") != auth:
                    self.send_response(401)
                    self.send_header("WWW-Authenticate", "Basic")
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                path = self.path.split("?")[0].rstrip("/")
                fn = routes.get((method, path))
                if fn is None:
                    self._send(404, {"detail": "Not Found"})
                    return
                try:
                    if method == "POST":
                        length = int(self.headers.get("Content-Length", 0))
                        raw = self.rfile.read(length) if length else b""
                        body = json.loads(raw or b"{}")
                        rid_hdr = self.headers.get("X-SDTPU-Request-Id")
                        if rid_hdr and isinstance(body, dict) \
                                and not body.get("request_id") \
                                and path in ("/sdapi/v1/txt2img",
                                             "/sdapi/v1/img2img"):
                            # a master's hop: this node's trace joins it
                            body["request_id"] = rid_hdr
                        result = (fn(body) if fn.__code__.co_argcount > 1
                                  else fn())
                    elif fn.__code__.co_argcount > 1:
                        # a GET handler with a parameter takes the query
                        # string as a flat dict of single values
                        query = parse_qs(urlsplit(self.path).query)
                        result = fn({k: v[0] for k, v in query.items()})
                    else:
                        result = fn()
                    self._send(200, result)
                except ApiError as e:
                    self._send(e.status, {"detail": e.detail}, e.headers)
                except Exception as e:  # noqa: BLE001 — answer, keep serving
                    log.exception("api error on %s %s", method, self.path)
                    self._send(500, {"detail": str(e)})

            def _send(self, status: int, obj: Any,
                      headers: Optional[Dict[str, str]] = None):
                if isinstance(obj, TextResponse):
                    data = str(obj).encode()
                    ctype = obj.content_type
                else:
                    data = json.dumps(obj).encode()
                    ctype = "application/json"
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                self._dispatch("GET")

            def do_POST(self):
                self._dispatch("POST")

        return Handler

    def _bind(self) -> None:
        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          self.make_handler())
        self.port = self._httpd.server_port  # resolves port 0
        log.info("sdapi server on %s:%d", self.host, self.port)

    def start(self) -> "ApiServer":
        """Serve in a daemon thread; returns once the port is bound."""
        self._bind()
        threading.Thread(target=self._httpd.serve_forever,
                         name="sdapi-server", daemon=True).start()
        return self

    def serve_forever(self) -> None:
        """Blocking serve (the CLI's ``serve``)."""
        self._bind()
        try:
            self._httpd.serve_forever()
        finally:
            self._httpd.server_close()

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


def _worker_dict(w) -> Dict[str, Any]:
    """One worker's row of ``GET /internal/workers``."""
    state = w.current_state()
    d = {
        "label": w.label,
        "state": state.name,
        "avg_ipm": w.cal.avg_ipm,
        "master": w.master,
        "pixel_cap": w.pixel_cap,
        "model_override": w.model_override,
        "pin_validated": w.pin_validated,
        "disabled": state.name == "DISABLED",
        "health": w.health.summary(),
    }
    backend = w.backend
    if hasattr(backend, "address"):
        d["address"] = backend.address
        d["port"] = backend.port
        d["tls"] = backend.tls
        d["user"] = backend.user or ""
    return d


def _vae_for_sync(vae: str) -> str:
    """'Automatic'/'None' mean "the checkpoint's own": empty on the
    wire."""
    return "" if vae in AUTOMATIC_VAES else (vae or "")
