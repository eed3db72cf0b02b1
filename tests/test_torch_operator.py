"""The port's operator surface against the JAX package's, over real HTTP.

One ``ApiServer`` of each package, each over a ``World`` of its own (a
stub master, ``StubBackend``; the remotes real ``HTTPBackend``s against a
stub sdapi node on localhost that lists two models and takes a restart,
and against a closed port for a node that is down), gets the same
sequence of requests: ``POST /internal/workers`` (add, a duplicate add, a
missing address, a pin the node serves, one it does not, an endpoint edit
with a pin, an unreachable node's pin, an unknown label, a missing label,
a bad action, disable, remove, removing the master),
``POST /internal/worker-models`` (up, down, unknown), ``POST
/internal/reset-mpe``, ``POST /internal/restart-all`` (the down node
disabled: the port fails a refused connection's restart, which the JAX
package counts as delivered), and ``POST
/internal/user-script`` with no ``user/`` directory and with a
``sync.sh`` in it. Each answer's status and body (an error's text aside,
which names each package's HTTP client), the worker rows after it (the
health transitions' times aside) and the saved config files must be
equal. A source with no fleet answers 400 in both. The panel at ``GET /``
is the JAX package's HTML; every URL its script calls is a route of the
port, and every status field it reads is one the port sends.
"""

import json
import re
import socket
import types
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
import threading

import pytest

from stable_diffusion_webui_distributed_tpu.runtime.config import (
    ConfigModel as JaxConfig,
)
from stable_diffusion_webui_distributed_tpu.scheduler.worker import (
    StubBackend as JaxStub,
    WorkerNode as JaxNode,
)
from stable_diffusion_webui_distributed_tpu.scheduler.world import (
    World as JaxWorld,
)
from stable_diffusion_webui_distributed_tpu.server import api as j_api
from stable_diffusion_webui_distributed_tpu.server.panel import (
    PANEL_HTML as JAX_PANEL,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import trace
from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    ConfigModel,
)
from stable_diffusion_webui_distributed_tpu_torch.scheduler.worker import (
    StubBackend,
    WorkerNode,
)
from stable_diffusion_webui_distributed_tpu_torch.scheduler.world import World
from stable_diffusion_webui_distributed_tpu_torch.server import api as t_api

SERVED = ["served.safetensors", "other.safetensors"]


class StubNode(BaseHTTPRequestHandler):
    """A remote sdapi node: its model list and a restart."""

    def log_message(self, *args):
        pass

    def _send(self, status, obj):
        data = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        if self.path == "/sdapi/v1/sd-models":
            self._send(200, [{"title": f"{m} [0]", "model_name": m}
                             for m in SERVED])
        else:
            self._send(404, {"detail": "Not Found"})

    def do_POST(self):
        self.rfile.read(int(self.headers.get("Content-Length", 0)))
        self._send(200 if self.path == "/sdapi/v1/server-restart" else 404,
                   {})


@pytest.fixture(scope="module")
def node():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), StubNode)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield srv.server_port
    srv.shutdown()
    srv.server_close()


@pytest.fixture(scope="module")
def dead_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]  # closed: nothing listens there


def make_pair(tmp_path, monkeypatch):
    """One server of each package over a World with a stub master, each
    World's config in a directory of its own."""
    monkeypatch.setenv("SDTPU_SERVING", "0")
    out = []
    for name, world_cls, cfg_cls, node_cls, stub_cls, api in (
            ("jax", JaxWorld, JaxConfig, JaxNode, JaxStub, j_api),
            ("port", World, ConfigModel, WorkerNode, StubBackend, t_api)):
        base = tmp_path / name
        base.mkdir()
        world = world_cls(cfg_cls(), config_path=str(base / "config.json"))
        world.add_worker(node_cls("m", stub_cls(), master=True, avg_ipm=10.0))
        out.append(api.ApiServer(world, host="127.0.0.1", port=0).start())
    return out


def call(server, route, body=None):
    """``(status, decoded body)`` of one request."""
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        f"http://127.0.0.1:{server.port}{route}", data=data,
        method="POST" if data is not None else "GET",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def rows(server):
    """The worker rows, the health transitions' times dropped."""
    status, doc = call(server, "/internal/workers")
    assert status == 200
    for row in doc:
        for t in row.get("health", {}).get("transitions", []):
            t.pop("at")
    return doc


def scrub(doc):
    """An error text names each package's HTTP client: keep its presence."""
    if isinstance(doc, dict) and "error" in doc:
        return {**doc, "error": bool(doc["error"])}
    return doc


def sequence(port, dead):
    """The operator's requests, in order: (route, body)."""
    add = {"action": "add", "label": "r", "address": "127.0.0.1",
           "port": port, "user": "op", "password": "secret"}
    return [
        ("/internal/workers", add),
        ("/internal/workers", add),  # duplicate label: 422
        ("/internal/workers", {"action": "add", "label": "x"}),  # 422
        ("/internal/workers", {"label": "r",
                               "model_override": "served.safetensors"}),
        ("/internal/workers", {"label": "r",
                               "model_override": "typo.safetensors"}),
        ("/internal/workers", {"label": "r", "address": "127.0.0.1",
                               "port": port, "password": "rotated",
                               "model_override": "other.safetensors",
                               "pixel_cap": 262144}),
        ("/internal/workers", {"action": "add", "label": "down",
                               "address": "127.0.0.1", "port": dead}),
        ("/internal/workers", {"label": "down",
                               "model_override": "any.safetensors"}),
        ("/internal/workers", {"label": "r", "model_override": ""}),
        ("/internal/workers", {"label": "ghost", "pixel_cap": 5}),  # 404
        ("/internal/workers", {"pixel_cap": 5}),  # no label: 422
        ("/internal/workers", {"label": "r", "action": "frob"}),  # 422
        ("/internal/workers", {"label": "m", "address": "h"}),  # 422
        ("/internal/workers", {"label": "down", "disabled": True}),
        ("/internal/worker-models", {"label": "r"}),
        ("/internal/worker-models", {"label": "down"}),
        ("/internal/worker-models", {"label": "ghost"}),  # 404
        ("/internal/reset-mpe", {}),
        ("/internal/restart-all", {}),  # "down" is disabled: skipped
        ("/internal/workers", {"label": "down", "disabled": False}),
        ("/internal/workers", {"action": "remove", "label": "m"}),  # 422
        ("/internal/workers", {"action": "remove", "label": "down"}),
        ("/internal/workers", {"action": "remove", "label": "down"}),  # 404
    ]


def test_operator_sequence_matches_jax(node, dead_port, tmp_path,
                                       monkeypatch):
    servers = make_pair(tmp_path, monkeypatch)
    try:
        for s in servers:
            s.source.get_worker("m").cal.eta_percent_error.extend([5.0, -3.0])
        seen = []
        for route, body in sequence(node, dead_port):
            answers = [call(s, route, body) for s in servers]
            assert scrub(answers[0][1]) == scrub(answers[1][1]) \
                and answers[0][0] == answers[1][0], (route, body, answers)
            assert rows(servers[0]) == rows(servers[1]), (route, body)
            seen.append(answers[1][0])
            assert "secret" not in json.dumps(answers[1][1])
            assert "rotated" not in json.dumps(answers[1][1])
        assert seen.count(200) == 13 and seen.count(422) == 7 \
            and seen.count(404) == 3
        port_rows = {r["label"]: r for r in rows(servers[1])}
        assert port_rows["r"]["model_override"] is None
        assert port_rows["r"]["pixel_cap"] == 262144
        assert port_rows["r"]["state"] == "UNAVAILABLE"  # restarted
        saved = [json.loads((tmp_path / n / "config.json").read_text())
                 for n in ("jax", "port")]
        assert saved[0] == saved[1]
        remote = next(e["r"] for e in saved[1]["workers"] if "r" in e)
        assert remote["password"] == "rotated" and remote["user"] == "op"
        master = next(e["m"] for e in saved[1]["workers"] if "m" in e)
        assert master["eta_percent_error"] == []
    finally:
        for s in servers:
            s.stop()


@pytest.mark.parametrize("label,pin,validated", [
    ("r", "served.safetensors", True),   # the node lists it
    ("down", "any.safetensors", False),  # unreachable: accepted unvalidated
])
def test_pin_provenance_matches_jax(node, dead_port, tmp_path, monkeypatch,
                                    label, pin, validated):
    servers = make_pair(tmp_path, monkeypatch)
    try:
        for s in servers:
            port = node if label == "r" else dead_port
            assert call(s, "/internal/workers", {
                "action": "add", "label": label, "address": "127.0.0.1",
                "port": port})[0] == 200
            assert call(s, "/internal/workers",
                        {"label": label, "model_override": pin})[0] == 200
        got = [s.source.get_worker(label) for s in servers]
        assert [w.pin_validated for w in got] == [validated, validated]
        assert [w._pin_refuted for w in got] == [False, False]
        assert [w._pin_checked_at for w in got] == [0.0, 0.0]
    finally:
        for s in servers:
            s.stop()


def test_restart_of_a_refused_node_fails(dead_port, tmp_path, monkeypatch):
    """Connection refused never reached the node: the port answers False
    (the JAX package counts any ``ConnectionError`` as delivered)."""
    servers = make_pair(tmp_path, monkeypatch)
    try:
        s = servers[1]
        call(s, "/internal/workers", {"action": "add", "label": "down",
                                      "address": "127.0.0.1",
                                      "port": dead_port})
        assert call(s, "/internal/restart-all", {}) == (
            200, {"restarted": {"down": False}})
        assert s.source.get_worker("down").current_state().name == "IDLE"
    finally:
        for s in servers:
            s.stop()


@pytest.mark.parametrize("script", [None, "#!/bin/sh\necho ran > {out}\n",
                                    "echo ran > {out}\nexit 3\n"])
def test_user_script_matches_jax(tmp_path, monkeypatch, script):
    servers = make_pair(tmp_path, monkeypatch)
    try:
        answers = []
        for name, s in zip(("jax", "port"), servers):
            out = tmp_path / name / "marker"
            if script is not None:
                user = tmp_path / name / "user"
                user.mkdir()
                (user / "sync.sh").write_text(script.format(out=out))
                (user / "zzz-not-sync.sh").write_text("exit 1\n")
            answers.append(call(s, "/internal/user-script", {}))
            assert out.exists() == (script is not None)
        assert answers[0] == answers[1]
        want = script is not None and "exit 3" not in script
        assert answers[1] == (200, {"ran": want})
    finally:
        for s in servers:
            s.stop()


@pytest.mark.parametrize("route,body", [
    ("/internal/user-script", {}),
    ("/internal/restart-all", {}),
    ("/internal/workers", {"label": "r"}),
    ("/internal/reset-mpe", {}),
    ("/internal/worker-models", {"label": "r"}),
])
def test_no_fleet_answers_match_jax(monkeypatch, route, body):
    monkeypatch.setenv("SDTPU_SERVING", "0")
    servers = [api.ApiServer(types.SimpleNamespace(model_name="bare"),
                             host="127.0.0.1", port=0).start()
               for api in (j_api, t_api)]
    try:
        answers = [call(s, route, body) for s in servers]
        assert answers[0] == answers[1]
        assert answers[1][0] in (200, 400, 404)
    finally:
        for s in servers:
            s.stop()


def test_routes_cover_the_jax_table():
    jax_keys = set(j_api.ApiServer.routes(
        j_api.ApiServer.__new__(j_api.ApiServer)))
    port_keys = set(t_api.ApiServer.routes(
        t_api.ApiServer.__new__(t_api.ApiServer)))
    assert jax_keys <= port_keys


def test_panel_is_the_jax_html_and_served(node, tmp_path, monkeypatch):
    servers = make_pair(tmp_path, monkeypatch)
    try:
        pages = []
        for s in servers:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{s.port}/", timeout=30) as r:
                assert r.headers["Content-Type"].startswith("text/html")
                pages.append(r.read().decode())
        assert pages[0] == pages[1] == JAX_PANEL
        port_routes = set(path for _, path in t_api.ApiServer.routes(
            t_api.ApiServer.__new__(t_api.ApiServer)))
        urls = set(re.findall(r"'(/(?:sdapi|internal)/[a-z0-9/_.-]+)'",
                              JAX_PANEL))
        assert len(urls) == 9 and urls <= port_routes, urls - port_routes

        # every field the script reads from /internal/status is sent
        world = servers[1].source
        call(servers[1], "/internal/workers", {
            "action": "add", "label": "r", "address": "127.0.0.1",
            "port": node})
        trace.STATS.record("panel-stage", 0.25)
        status, doc = call(servers[1], "/internal/status")
        assert status == 200 and world.get_worker("r") is not None
        script = JAX_PANEL[JAX_PANEL.index("<script>"):]
        for top, sub in re.findall(r"\bs\.([a-z_]+)(?:\.([a-z_]+))?",
                                   script):
            assert top in doc, top
            if sub and sub != "join":  # s.logs.join: a JS array's method
                assert sub in doc[top], (top, sub)
        remote = next(w for w in doc["workers"] if w["label"] == "r")
        for field in set(re.findall(r"\bw\.([a-z_]+)", script)):
            assert field in remote, field
        for field in set(re.findall(r"\bv\.([a-z0-9_]+)", script)):
            assert field in doc["timings"]["panel-stage"], field
    finally:
        for s in servers:
            s.stop()
