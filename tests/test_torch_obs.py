"""The port's request-observability plane against the JAX package's, on
TINY on the CPU: span trees (``obs/spans.py``, ``runtime/trace.py``), the
flight recorder (``obs/flightrec.py``), request-correlated logging
(``runtime/logging.py``) and the hang watchdog (``obs/watchdog.py``).

- The same config #1-shaped TINY request (Euler a, CFG 7, batch 1) through
  each package's ``ApiServer`` (``SDTPU_BUCKET_LADDER=32x32``,
  ``SDTPU_BATCH_LADDER=2``) gives the same span tree: names, nesting and
  attribute keys, on the coalesced path, the solo path (``n_iter`` 3,
  past the batch ladder) and the stage-graph path. The one stated map:
  the JAX package's ``compile`` spans (its XLA builds) are the port's
  ``capture`` spans (its CUDA-graph captures); the two packages build
  different things (the port captures UNet evaluations only, and nothing
  on the CPU), so both are taken out of the compared trees, and a port
  engine on the graph layer's CPU stand-in shows ``capture`` where the
  JAX package shows ``compile``, with the same attribute keys. No
  assertion reads a span's duration.
- A coalesced pair: the leader's ``dispatch.device`` mirrored into the
  follower as ``coalesced.dispatch`` with ``leader_request_id``.
- A failed request lands in the flight recorder with its spans and its own
  log lines; the watchdog fires once for a fake operation that outlives
  ``factor x eta`` (stack dump, counter, ``watchdog_stall`` journal
  event), never when disarmed in time; a ``World`` job that stalls is
  requeued (JAX ``tests/test_obsplane.py``), with the JAX World's seeds.

The weights are TINY's tree filled from a seeded numpy stream (both
packages take the same tree).
"""

import json
import logging
import threading
import time
import urllib.request
from collections import defaultdict

import numpy as np
import pytest

import jax

from stable_diffusion_webui_distributed_tpu.models.configs import TINY as JTINY
from stable_diffusion_webui_distributed_tpu.obs import flightrec as jflightrec
from stable_diffusion_webui_distributed_tpu.obs import journal as jjournal
from stable_diffusion_webui_distributed_tpu.obs import prometheus as jprom
from stable_diffusion_webui_distributed_tpu.obs import spans as jspans
from stable_diffusion_webui_distributed_tpu.obs import watchdog as jwatchdog
from stable_diffusion_webui_distributed_tpu.pipeline.engine import (
    Engine as JaxEngine,
)
from stable_diffusion_webui_distributed_tpu.pipeline.payload import (
    GenerationPayload as JaxPayload,
)
from stable_diffusion_webui_distributed_tpu.runtime import config as jconfig
from stable_diffusion_webui_distributed_tpu.runtime import trace as jtrace
from stable_diffusion_webui_distributed_tpu.runtime.interrupt import (
    GenerationState as JaxState,
)
from stable_diffusion_webui_distributed_tpu.scheduler import worker as jworker
from stable_diffusion_webui_distributed_tpu.scheduler import world as jworld
from stable_diffusion_webui_distributed_tpu.server.api import (
    ApiServer as JaxApiServer,
)
from stable_diffusion_webui_distributed_tpu.serving.bucketer import (
    ShapeBucketer as JaxBucketer,
)
from stable_diffusion_webui_distributed_tpu.serving.dispatcher import (
    ServingDispatcher as JaxDispatcher,
)
from stable_diffusion_webui_distributed_tpu_torch import bridge
from stable_diffusion_webui_distributed_tpu_torch.models.configs import TINY
from stable_diffusion_webui_distributed_tpu_torch.obs import flightrec
from stable_diffusion_webui_distributed_tpu_torch.obs import journal
from stable_diffusion_webui_distributed_tpu_torch.obs import prometheus
from stable_diffusion_webui_distributed_tpu_torch.obs import spans
from stable_diffusion_webui_distributed_tpu_torch.obs import watchdog
from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import Engine
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import graphs
from stable_diffusion_webui_distributed_tpu_torch.runtime import (
    logging as port_logging,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import trace
from stable_diffusion_webui_distributed_tpu_torch.runtime.interrupt import (
    GenerationState,
)
from stable_diffusion_webui_distributed_tpu_torch.scheduler import worker
from stable_diffusion_webui_distributed_tpu_torch.scheduler import world
from stable_diffusion_webui_distributed_tpu_torch.server.api import ApiServer
from stable_diffusion_webui_distributed_tpu_torch.serving.bucketer import (
    ShapeBucketer,
)
from stable_diffusion_webui_distributed_tpu_torch.serving.dispatcher import (
    ServingDispatcher,
)
from test_pipeline import init_params
from test_torch_warmup import Stub

#: config #1's request at TINY's scale
BODY = dict(prompt="an obs cow", negative_prompt="blurry", steps=4,
            width=32, height=32, cfg_scale=7, sampler_name="Euler a",
            batch_size=1)
#: the JAX package's span name -> the port's (the only renamed span)
SPAN_MAP = {"compile": "capture"}
#: what each package builds, taken out of the compared trees
BUILD_SPANS = ("compile", "capture")


@pytest.fixture(scope="module")
def params():
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda: init_params(JTINY))
    return jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.05).astype(s.dtype),
        shapes)


@pytest.fixture(scope="module")
def engine(params):
    return Engine(TINY, bridge.flax_to_torch(TINY, params), chunk_size=2,
                  state=GenerationState(), device="cpu")


@pytest.fixture(scope="module")
def jax_engine(params):
    return JaxEngine(JTINY, params, chunk_size=2, state=JaxState())


@pytest.fixture(autouse=True)
def gates_off(monkeypatch):
    for name in ("SDTPU_STAGE_GRAPH", "SDTPU_CACHE", "SDTPU_RAGGED",
                 "SDTPU_FLEET", "SDTPU_PERF", "SDTPU_WATCHDOG_FACTOR",
                 "SDTPU_JOURNAL"):
        monkeypatch.delenv(name, raising=False)


def post(port, body, route="txt2img"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/sdapi/v1/{route}",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def tree(trace):
    """A trace's shape: (name, attribute keys, children) from the root,
    children sorted; the JAX names mapped, build spans left out."""
    children = defaultdict(list)
    root = None
    for sp in trace.spans:
        if sp.parent_id is None:
            root = sp
        else:
            children[sp.parent_id].append(sp)

    def node(sp):
        kids = tuple(sorted(repr(node(c)) for c in children[sp.span_id]
                            if SPAN_MAP.get(c.name, c.name)
                            not in BUILD_SPANS))
        return (SPAN_MAP.get(sp.name, sp.name),
                tuple(sorted(sp.attrs)), kids)

    assert root is not None
    return node(root)


def finished(tracer, rid):
    return next(t for t in tracer.finished() if t.request_id == rid)


#: path -> (environment, request fields)
PATHS = {
    "coalesced": ({}, {}),
    "solo": ({}, {"n_iter": 3}),
    "staged": ({"SDTPU_STAGE_GRAPH": "1"}, {}),
}


@pytest.fixture(scope="module")
def traces(engine, jax_engine):
    """Each path's request through both servers (one warm request first),
    with the first request's traces kept for the build-span map."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SDTPU_BUCKET_LADDER", "32x32")
        mp.setenv("SDTPU_BATCH_LADDER", "2")
        port = ApiServer(engine, port=0).start()
        ref = JaxApiServer(jax_engine, port=0).start()
        try:
            for pkg, srv in (("port", port), ("jax", ref)):
                post(srv.port, dict(BODY, seed=1, request_id=f"{pkg}-first"))
            for path, (env, extra) in PATHS.items():
                for k, v in env.items():
                    mp.setenv(k, v)
                for pkg, srv in (("port", port), ("jax", ref)):
                    rid = f"{pkg}-{path}"
                    resp = post(srv.port, dict(BODY, seed=2, request_id=rid,
                                               **extra))
                    out[(pkg, path)] = resp
                for k in env:
                    mp.delenv(k)
        finally:
            port.stop()
            ref.stop()
    return out


@pytest.mark.parametrize("path", sorted(PATHS))
def test_span_tree_matches_jax(traces, path):
    got = finished(spans.TRACER, f"port-{path}")
    want = finished(jspans.TRACER, f"jax-{path}")
    assert got.status == want.status == "ok"
    assert got.name == want.name == "txt2img"
    assert tree(got) == tree(want)
    names = {sp.name for sp in got.spans}
    assert {"bucket", "queue_wait", "dispatch.device",
            "denoise_range"} <= names
    if path == "solo":
        assert "generate_range" in names
    if path == "staged":
        lanes = {sp.name: sp.tid for sp in got.spans
                 if sp.name.startswith("stage.")}
        assert lanes == {"stage.encode": -101, "stage.denoise": -103,
                         "stage.decode": -104, "stage.merge": -105}


def test_capture_spans_sit_where_jax_compiles(params, traces):
    """The stated map: with the graph layer's CPU stand-in the port
    captures its UNet evaluation, a ``capture`` span inside
    ``denoise_range`` with the keys of the JAX package's ``compile``
    span there."""
    want = finished(jspans.TRACER, "jax-first")
    by_id = {sp.span_id: sp for sp in want.spans}
    jax_compiles = [sp for sp in want.spans if sp.name == "compile"
                    and by_id.get(sp.parent_id) is not None
                    and by_id[sp.parent_id].name == "denoise_range"]
    assert jax_compiles
    eng = Engine(TINY, bridge.flax_to_torch(TINY, params), chunk_size=2,
                 state=GenerationState(), device="cpu")
    eng._graphs = graphs.GraphCache(capture=Stub())
    with spans.request("capture-0", name="txt2img"):
        eng.generate_range(GenerationPayload(**BODY, seed=3))
    got = finished(spans.TRACER, "capture-0")
    by_id = {sp.span_id: sp for sp in got.spans}
    captures = [sp for sp in got.spans if sp.name == "capture"]
    assert captures
    for sp in captures:
        assert by_id[sp.parent_id].name == "denoise_range"
        assert set(sp.attrs) == set(jax_compiles[0].attrs) == {"key", "kind"}
        assert sp.attrs["kind"] == "unet"


def pair(disp, make, rids):
    out, threads = {}, []
    for i, rid in enumerate(rids):
        def run(i=i, rid=rid):
            out[rid] = disp.submit(make(**BODY, seed=40 + i,
                                        request_id=rid))
        threads.append(threading.Thread(target=run))
        threads[-1].start()
        time.sleep(0.05)
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    return out


def test_coalesced_follower_mirrors_the_leaders_dispatch(engine,
                                                         jax_engine):
    rids = ("mirror-a", "mirror-b")
    disp = ServingDispatcher(engine, bucketer=ShapeBucketer(
        shapes=[(32, 32)], batches=[2]), window=0.6)
    pair(disp, GenerationPayload, rids)
    ref = JaxDispatcher(jax_engine, bucketer=JaxBucketer(
        shapes=[(32, 32)], batches=[2]), window=0.6)
    pair(ref, JaxPayload, tuple(f"jax-{r}" for r in rids))
    for tracer, (lead, follow) in ((spans.TRACER, rids),
                                   (jspans.TRACER, tuple(
                                       f"jax-{r}" for r in rids))):
        leader, follower = finished(tracer, lead), finished(tracer, follow)
        assert leader.name == "serve.txt2img"
        dsp = [sp for sp in leader.spans if sp.name == "dispatch.device"]
        assert len(dsp) == 1
        mirrored = [sp for sp in follower.spans
                    if sp.name == "coalesced.dispatch"]
        assert len(mirrored) == 1
        assert mirrored[0].attrs["leader_request_id"] == lead
        assert mirrored[0].attrs["leader_span_id"] == dsp[0].span_id
        assert "dispatch.device" not in {sp.name for sp in follower.spans}
    assert tree(finished(spans.TRACER, rids[1])) == \
        tree(finished(jspans.TRACER, f"jax-{rids[1]}"))


def test_device_time_follows_the_work_onto_the_device_thread(engine):
    """The engine's device thread runs a task in its caller's request
    context: the span a task opens nests under the caller's."""
    def inner():
        with spans.span("inner"):
            return spans.current_request_id()

    with spans.request("runner-0", name="probe"):
        with spans.span("outer"):
            rid = engine.run_on_device(inner)
    assert rid == "runner-0"
    got = finished(spans.TRACER, "runner-0")
    by_name = {sp.name: sp for sp in got.spans}
    assert by_name["inner"].parent_id == by_name["outer"].span_id


def test_stage_stats_and_chrome_export_match_jax():
    stats, ref = trace.StageStats(), jtrace.StageStats()
    for s, v in (("a", 0.5), ("b", 1.5), ("a", 0.25), ("a", 2.0)):
        stats.record(s, v)
        ref.record(s, v)
    assert stats.summary() == ref.summary()
    for mod in (spans, jspans):
        with mod.request("export-0", name="probe", route="/x"):
            with mod.span("child", a=1):
                mod.stage_event("text_encode", 0.01)
    got = [e for e in spans.TRACER.export_chrome()["traceEvents"]
           if e["args"]["request_id"] == "export-0"]
    want = [e for e in jspans.TRACER.export_chrome()["traceEvents"]
            if e["args"]["request_id"] == "export-0"]
    assert [(e["name"], e["ph"], e["cat"], sorted(e["args"]))
            for e in got] == [(e["name"], e["ph"], e["cat"],
                               sorted(e["args"])) for e in want]


def test_failed_request_is_recorded_with_its_log_lines(tmp_path):
    port_logging.configure(log_dir=str(tmp_path))
    log = logging.getLogger(
        "stable_diffusion_webui_distributed_tpu_torch.tests")
    before = len(flightrec.RECORDER)
    with pytest.raises(RuntimeError):
        with spans.request("fail-0", name="txt2img"):
            with spans.span("dispatch.device", requests=1):
                log.warning("about to fail")
                raise RuntimeError("boom")
    assert len(flightrec.RECORDER) == before + 1
    entry = flightrec.RECORDER.dump()["entries"][-1]
    ref = jflightrec.FlightRecorder(capacity=2).record(
        "x", "error", "d", events=[])
    assert set(entry) == set(ref)
    assert entry["request_id"] == "fail-0" and entry["reason"] == "error"
    assert entry["detail"] == "RuntimeError: boom"
    assert {e["name"] for e in entry["spans"]} == {"dispatch.device",
                                                    "txt2img"}
    assert len(entry["logs"]) == 1
    assert entry["logs"][0].endswith("WARNING about to fail")
    assert port_logging.lines_for_request("no-such") == []


def fire(mod, prom, rec, jr, monkeypatch, disarm_in_time):
    monkeypatch.setenv("SDTPU_WATCHDOG_FACTOR", "2.0")
    monkeypatch.setenv("SDTPU_JOURNAL", "1")
    jr.JOURNAL.clear()
    # the recorder is a ring (16 entries by default) that earlier tests
    # of the worker process may have filled: at capacity its length stays
    # put, so a stall's entry would neither be waited for nor found
    rec.RECORDER.clear()
    stalls0, recorded0 = prom.watchdog_stalls_total(), len(rec.RECORDER)
    called = []
    handle = mod.arm("wd-0", "fake-op", 0.05,
                     on_stall=lambda: called.append(1))
    if disarm_in_time:
        mod.disarm(handle)
        time.sleep(0.5)
    else:
        # the stall's flight-recorder entry, then its on_stall call, land
        # on the timer's thread: wait for both, up to a deadline, since a
        # loaded machine can run that thread late
        deadline = time.monotonic() + 5.0
        while (len(rec.RECORDER) == recorded0 or not called) \
                and time.monotonic() < deadline:
            time.sleep(0.01)
    mod.disarm(handle)
    events = [e["event"] for e in jr.JOURNAL.snapshot()["events"]]
    new = rec.RECORDER.dump()["entries"][recorded0:]
    return (len(called), prom.watchdog_stalls_total() - stalls0, events,
            [(e["reason"], e["request_id"]) for e in new],
            [e["detail"] for e in new])


@pytest.mark.parametrize("in_time", [False, True])
def test_watchdog_fires_once_as_jax(monkeypatch, in_time):
    got = fire(watchdog, prometheus, flightrec, journal, monkeypatch,
               in_time)
    want = fire(jwatchdog, jprom, jflightrec, jjournal, monkeypatch,
                in_time)
    assert got[:4] == want[:4]
    if in_time:
        assert got[0] == 0 and got[3] == []
    else:
        assert got[0] == 1 and got[1] == 1
        assert got[2] == ["watchdog_stall"]
        assert got[3] == [("watchdog_stall", "wd-0")]
        assert "Thread" in got[4][0] and "fake-op" in got[4][0]
    assert watchdog.arm("wd-1", "x", None) is None


def stall_world(world_mod, worker_mod, cfg):
    w = world_mod.World(*cfg)
    for label, spi in (("survivor", 0.001), ("staller", 0.5)):
        w.add_worker(worker_mod.WorkerNode(
            label, worker_mod.StubBackend(
                worker_mod.StubBehavior(seconds_per_image=spi)),
            avg_ipm=2400.0))
    return w


def test_stalled_world_job_is_requeued_as_jax(monkeypatch):
    monkeypatch.setenv("SDTPU_WATCHDOG_FACTOR", "2.0")
    body = dict(prompt="p", steps=20, width=512, height=512, batch_size=4,
                seed=10, request_id="stall-0")
    runs = {}
    for name, (wmod, kmod, cfg, pay, prom, rec) in {
            "port": (world, worker, (), GenerationPayload, prometheus,
                     flightrec),
            "jax": (jworld, jworker, (jconfig.ConfigModel(),), JaxPayload,
                    jprom, jflightrec)}.items():
        w = stall_world(wmod, kmod, cfg)
        stalls0 = prom.watchdog_stalls_total()
        result = w.execute(pay(**body))
        stall = [e for e in rec.RECORDER.dump()["entries"]
                 if e["reason"] == "watchdog_stall"][-1]
        runs[name] = (result, prom.watchdog_stalls_total() - stalls0,
                      w.get_worker("staller").health.summary()[
                          "requeued_images"], stall)
    (got, n, requeued, stall), (want, jn, jrequeued, _) = \
        runs["port"], runs["jax"]
    assert got.seeds == want.seeds and len(got.images) == 4
    assert got.images == want.images
    assert all("survivor" in t for t in got.infotexts)
    assert (n, requeued) == (jn, jrequeued) == (1, 2)
    assert "Thread" in stall["detail"] and "job-staller" in stall["detail"]
    failures = [e for e in flightrec.RECORDER.dump()["entries"]
                if e["reason"] == "worker_failure"]
    assert "stalled past the watchdog deadline" in failures[-1]["detail"]
