"""The port's observability routes through its ``ApiServer`` on TINY on
the CPU, beside the JAX package's documents.

``GET /internal/status``, ``/internal/trace.json``, ``/internal/metrics``
(parsed as Prometheus text exposition: the request histogram counts every
request sent), ``/internal/flightrec``, ``/internal/perf`` and ``GET`` /
``POST /internal/profile`` (a ``torch.profiler`` capture written as a
Chrome trace under ``./profile-traces/<basename>``) all answer; the status
document has the JAX package's keys; a request id the client names (in
the payload, or the ``X-SDTPU-Request-Id`` header a master sends) roots
its trace; a bad profile action answers 422. The weights are TINY's tree
filled from a seeded numpy stream.
"""

import json
import os
import re
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax

from stable_diffusion_webui_distributed_tpu.models.configs import TINY as JTINY
from stable_diffusion_webui_distributed_tpu.pipeline.engine import (
    Engine as JaxEngine,
)
from stable_diffusion_webui_distributed_tpu.runtime.interrupt import (
    GenerationState as JaxState,
)
from stable_diffusion_webui_distributed_tpu.server.api import (
    ApiServer as JaxApiServer,
)
from stable_diffusion_webui_distributed_tpu_torch import bridge
from stable_diffusion_webui_distributed_tpu_torch.models.configs import TINY
from stable_diffusion_webui_distributed_tpu_torch.obs import flightrec
from stable_diffusion_webui_distributed_tpu_torch.obs import perf
from stable_diffusion_webui_distributed_tpu_torch.obs import prometheus
from stable_diffusion_webui_distributed_tpu_torch.obs import spans
from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import Engine
from stable_diffusion_webui_distributed_tpu_torch.runtime.interrupt import (
    GenerationState,
)
from stable_diffusion_webui_distributed_tpu_torch.server.api import ApiServer
from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
    METRICS,
)
from test_pipeline import init_params

BODY = dict(prompt="a route cow", negative_prompt="blurry", steps=2,
            width=32, height=32, cfg_scale=7, sampler_name="Euler a")
#: a sample line of the text exposition
SAMPLE = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? '
                    r'(-?[0-9.e+-]+|NaN|\+Inf)$')


@pytest.fixture(scope="module")
def params():
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda: init_params(JTINY))
    return jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.05).astype(s.dtype),
        shapes)


@pytest.fixture(scope="module")
def server(params, tmp_path_factory):
    engine = Engine(TINY, bridge.flax_to_torch(TINY, params), chunk_size=2,
                    state=GenerationState(), device="cpu")
    cwd = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("profiles"))  # ./profile-traces here
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SDTPU_BUCKET_LADDER", "32x32")
        mp.setenv("SDTPU_BATCH_LADDER", "1,2")
        mp.setenv("SDTPU_PERF", "1")
        for name in ("SDTPU_STAGE_GRAPH", "SDTPU_CACHE", "SDTPU_FLEET"):
            mp.delenv(name, raising=False)
        srv = ApiServer(engine, port=0).start()
        METRICS.clear()
        prometheus.clear_histograms()
        perf.LEDGER.clear()
        try:
            yield srv
        finally:
            srv.stop()
            os.chdir(cwd)


def call(srv, route, body=None, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{route}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read(), r.headers.get("Content-Type", "")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), ""


@pytest.fixture(scope="module")
def served(server):
    """Three requests: one naming its id, one with the header, one
    minted."""
    rids = []
    for i, (extra, headers) in enumerate((
            ({"request_id": "route-0"}, None),
            ({}, {"X-SDTPU-Request-Id": "route-1"}),
            ({}, None))):
        status, data, _ = call(server, "/sdapi/v1/txt2img",
                               dict(BODY, seed=10 + i, **extra), headers)
        assert status == 200
        rids.append(json.loads(data)["parameters"].get("request_id"))
    return rids


def test_request_ids_root_their_traces(served):
    assert served[:2] == ["route-0", "route-1"]
    assert served[2] and served[2] not in served[:2]
    for rid in served:
        tr = next(t for t in spans.TRACER.finished() if t.request_id == rid)
        assert tr.name == "txt2img" and tr.status == "ok"
        assert tr.attrs == {"route": "/sdapi/v1/txt2img"}


def test_trace_json_holds_every_request(server, served):
    status, data, ctype = call(server, "/internal/trace.json")
    assert status == 200 and ctype == "application/json"
    doc = json.loads(data)
    assert doc["displayTimeUnit"] == "ms" and "clock_us" in doc
    for rid in served:
        names = {e["name"] for e in doc["traceEvents"]
                 if e["args"]["request_id"] == rid}
        assert {"txt2img", "queue_wait", "dispatch.device",
                "denoise_range"} <= names
    for e in doc["traceEvents"]:
        assert e["ph"] == "X" and e["dur"] >= 0


def test_metrics_parse_as_text_exposition(server, served):
    status, data, ctype = call(server, "/internal/metrics")
    assert status == 200 and ctype.startswith("text/plain; version=0.0.4")
    text = data.decode()
    types = {}
    for line in text.splitlines():
        m = re.match(r"# TYPE (\S+) (counter|gauge|histogram)$", line)
        if m:
            types[m.group(1)] = m.group(2)
        elif not line.startswith("# HELP "):
            assert SAMPLE.match(line), line
    assert types["sdtpu_request_e2e_seconds"] == "histogram"
    count = re.search(r"^sdtpu_request_e2e_seconds_count (\d+)$", text,
                      re.M)
    assert int(count.group(1)) == len(served)
    assert re.search(r"^sdtpu_serving_requests_total 3$", text, re.M)
    assert "sdtpu_perf_mfu" in types


def test_perf_reports_the_group(server, served):
    status, data, _ = call(server, "/internal/perf")
    doc = json.loads(data)
    assert status == 200 and doc["enabled"] is True
    (row,) = doc["groups"]
    assert (row["bucket"], row["cadence"], row["precision"]) == \
        ("32x32", 1, "bf16")
    assert row["dispatches"] == 3 and row["requests"] == 3
    assert row["flops"] > 0 and row["device_s"] > 0
    assert row["mfu"] is None  # the CPU has no peak
    assert doc["peak_flops_bf16"] is None


def test_status_has_the_jax_documents_keys(server, served, params):
    status, data, _ = call(server, "/internal/status")
    doc = json.loads(data)
    ref = JaxApiServer(JaxEngine(JTINY, params, state=JaxState()),
                       port=0).handle_internal_status()
    assert status == 200 and set(doc) == set(ref)
    assert set(doc["obs"]) == set(ref["obs"])
    assert set(doc["serving"]) >= set(ref["serving"]) - {"aot_loads"}
    assert doc["serving"]["requests"] == 3
    assert doc["obs"]["enabled"] is True
    assert doc["timings"]["denoise_chunk"]["count"] >= 3


def test_flightrec_serves_a_cancelled_request(server, served):
    flightrec.RECORDER.clear()
    with spans.request("route-cancel", name="txt2img") as req:
        spans.mark(req, "interrupted", "cancelled by client")
    status, data, _ = call(server, "/internal/flightrec")
    doc = json.loads(data)
    assert status == 200 and doc["count"] == 1
    assert doc["entries"][0]["request_id"] == "route-cancel"
    assert doc["entries"][0]["reason"] == "interrupted"


def test_profile_writes_a_chrome_trace(server):
    status, data, _ = call(server, "/internal/profile",
                           {"action": "start", "dir": "../../cap"})
    doc = json.loads(data)
    assert status == 200 and doc == {"started": True,
                                     "dir": os.path.join("profile-traces",
                                                         "cap")}
    again = json.loads(call(server, "/internal/profile",
                            {"action": "start"})[1])
    assert again["started"] is False
    assert call(server, "/sdapi/v1/txt2img", dict(BODY, seed=30))[0] == 200
    stopped = json.loads(call(server, "/internal/profile",
                              {"action": "stop"})[1])
    assert stopped == {"stopped_dir": os.path.join("profile-traces", "cap")}
    with open(os.path.join("profile-traces", "cap", "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("denoise[" in str(e.get("name", "")) for e in events)
    assert json.loads(call(server, "/internal/profile",
                           {"action": "stop"})[1]) == {"stopped_dir": None}
    assert call(server, "/internal/profile", {"action": "go"})[0] == 422
    status, data, _ = call(server, "/internal/profile?seconds=0.1&dir=g")
    assert status == 200
    assert json.loads(data)["captured_dir"] == os.path.join(
        "profile-traces", "g")
    assert call(server, "/internal/profile?seconds=x")[0] == 422
