"""sdapi-v1 HTTP server: one node of the fleet.

Port of the JAX package's ``server/api.py``. ``source`` executes payloads:
a ``World`` (``execute``: the fleet's fan-out) or a bare ``Engine``. As
there, a bare engine gets a serving dispatcher in front of it
(``serving/dispatcher.py``: shape bucketing, request coalescing, ragged
dispatch) unless ``SDTPU_SERVING=0``; a World keeps its own scheduler.

Routes, in webui's shapes: ``POST /sdapi/v1/txt2img``; ``GET
/sdapi/v1/samplers`` (the samplers the port runs); ``GET /sdapi/v1/progress``
and ``POST /sdapi/v1/interrupt``; ``GET /sdapi/v1/memory`` (``ram`` and the
card's ``cuda`` section); ``GET``/``POST /sdapi/v1/options`` (a POST records
the model name, and a World fans it out to its remotes: without a
checkpoint registry, a model sync is by name only); ``GET
/sdapi/v1/sd-models``; ``GET /sdapi/v1/script-info`` (what the port runs:
no script yet); ``POST /sdapi/v1/server-restart``; ``GET /internal/workers``
and ``POST /internal/benchmark`` for a World. A request for something the
port does not run answers 422. Optional Basic auth. Served by the standard
library's ``ThreadingHTTPServer``; ``port=0`` binds a free port.
"""

from __future__ import annotations

import base64
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import torch
from pydantic import ValidationError

from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
    GenerationResult,
    Unsupported,
    apply_scripts,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import (
    interrupt as interrupt_mod,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    env_flag,
)
from stable_diffusion_webui_distributed_tpu_torch.samplers.kdiffusion import (
    SamplerNotPorted,
    ported_sampler_names,
)
from stable_diffusion_webui_distributed_tpu_torch.scheduler.worker import (
    cuda_memory,
)
from stable_diffusion_webui_distributed_tpu_torch.serving.dispatcher import (
    ServingDispatcher,
)

log = logging.getLogger(__name__)


class ApiError(Exception):
    def __init__(self, status: int, detail: str):
        super().__init__(detail)
        self.status = status
        self.detail = detail


class ApiServer:
    """One generation node's REST surface over ``source`` (a ``World`` or
    an ``Engine``)."""

    def __init__(self, source, host: str = "127.0.0.1", port: int = 7860,
                 user: Optional[str] = None, password: Optional[str] = None):
        self.source = source
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
        try:
            payload = GenerationPayload(**body)
            if payload.styles:
                raise Unsupported("styles are not ported to the PyTorch "
                                  "server yet")
            payload = apply_scripts(payload)
            if hasattr(self.source, "execute"):
                with self._busy:
                    result = self.source.execute(payload)  # resets the latch
            elif self.dispatcher is not None:
                # the dispatcher serializes execution itself, so that
                # concurrent compatible requests can merge in its window
                result = self.dispatcher.submit(payload, job="txt2img")
            else:
                with self._busy:
                    # a bare engine: this request is the top level
                    self.state.begin_request()
                    result = self.source.generate_range(payload)
        except (ValidationError, Unsupported, SamplerNotPorted) as e:
            raise ApiError(422, str(e))
        return self._generation_response(result)

    def handle_samplers(self) -> Any:
        return [{"name": n, "aliases": [], "options": {}}
                for n in ported_sampler_names()]

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
        """Record the options; a model or VAE change fans out to a World's
        remotes, and scheduler settings (bare or ``distributed_``-prefixed)
        apply live to it."""
        model = body.get("sd_model_checkpoint")
        vae = body.get("sd_vae")
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

    def handle_sd_models(self) -> Any:
        name = self.options.get("sd_model_checkpoint") or "unknown"
        return [{"title": name, "model_name": name, "filename": "",
                 "hash": None, "sha256": None}]

    def handle_script_info(self) -> Any:
        # a master strips the alwayson-script args a node does not list;
        # the port runs no webui script yet
        return []

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

    def routes(self):
        return {
            ("POST", "/sdapi/v1/txt2img"): self.handle_txt2img,
            ("GET", "/sdapi/v1/samplers"): self.handle_samplers,
            ("GET", "/sdapi/v1/progress"): self.handle_progress,
            ("POST", "/sdapi/v1/interrupt"): self.handle_interrupt,
            ("GET", "/sdapi/v1/memory"): self.handle_memory,
            ("GET", "/sdapi/v1/options"): self.handle_options_get,
            ("POST", "/sdapi/v1/options"): self.handle_options_post,
            ("GET", "/sdapi/v1/sd-models"): self.handle_sd_models,
            ("GET", "/sdapi/v1/script-info"): self.handle_script_info,
            ("POST", "/sdapi/v1/server-restart"): self.handle_server_restart,
            ("GET", "/internal/workers"): self.handle_workers,
            ("POST", "/internal/benchmark"): self.handle_benchmark,
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
                fn = routes.get((method, self.path.split("?")[0].rstrip("/")))
                if fn is None:
                    self._send(404, {"detail": "Not Found"})
                    return
                try:
                    if method == "POST":
                        length = int(self.headers.get("Content-Length", 0))
                        raw = self.rfile.read(length) if length else b""
                        body = json.loads(raw or b"{}")
                        result = (fn(body) if fn.__code__.co_argcount > 1
                                  else fn())
                    else:
                        result = fn()
                    self._send(200, result)
                except ApiError as e:
                    self._send(e.status, {"detail": e.detail})
                except Exception as e:  # noqa: BLE001 — answer, keep serving
                    log.exception("api error on %s %s", method, self.path)
                    self._send(500, {"detail": str(e)})

            def _send(self, status: int, obj: Any):
                data = json.dumps(obj).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
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
    return "" if vae in ("Automatic", "None") else (vae or "")
