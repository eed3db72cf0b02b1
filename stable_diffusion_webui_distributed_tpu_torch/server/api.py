"""sdapi-v1 HTTP server over a bare PyTorch engine.

Port of the JAX package's ``server/api.py`` for one generation node without
the fleet. As there, a bare engine gets a serving dispatcher in front of it
(``serving/dispatcher.py``: shape bucketing, request coalescing, ragged
dispatch) unless ``SDTPU_SERVING=0``; ``POST /sdapi/v1/txt2img`` submits
through it and answers in webui's response shape. ``GET
/sdapi/v1/samplers`` lists the samplers the port runs; ``/progress`` and
``/interrupt`` read and set the engine's generation state. A request for
something the port does not run answers 422. Served by the standard
library's ``ThreadingHTTPServer``; ``port=0`` binds a free port.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from pydantic import ValidationError

from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
    GenerationResult,
    Unsupported,
    apply_scripts,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    env_flag,
)
from stable_diffusion_webui_distributed_tpu_torch.samplers.kdiffusion import (
    SamplerNotPorted,
    ported_sampler_names,
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
    """One generation node's REST surface over ``engine``."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 7860):
        self.engine = engine
        self.state = engine.state
        self.host = host
        self.port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._busy = threading.Lock()  # one generation at a time
        # continuous-batching front end: shape bucketing + request
        # coalescing; SDTPU_SERVING=0 calls the engine directly
        self.dispatcher = None
        if env_flag("SDTPU_SERVING", True):
            self.dispatcher = ServingDispatcher(engine)

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
            if self.dispatcher is not None:
                # the dispatcher serializes execution itself, so that
                # concurrent compatible requests can merge in its window
                result = self.dispatcher.submit(payload, job="txt2img")
            else:
                with self._busy:
                    # a bare engine: this request is the top level
                    self.state.begin_request()
                    result = self.engine.generate_range(payload)
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
        return {}

    def routes(self):
        return {
            ("POST", "/sdapi/v1/txt2img"): self.handle_txt2img,
            ("GET", "/sdapi/v1/samplers"): self.handle_samplers,
            ("GET", "/sdapi/v1/progress"): self.handle_progress,
            ("POST", "/sdapi/v1/interrupt"): self.handle_interrupt,
        }

    # -- HTTP ----------------------------------------------------------------

    def make_handler(self):
        routes = self.routes()

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                log.debug("http: " + fmt, *args)

            def _dispatch(self, method: str):
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
