"""The port's fleet telemetry plane against the JAX package's on the CPU:
the fleet timeline, trace stitching, federation, the push plane, the
eight routes and the executables census, the autoscaler's two feeds, and
the gates' bytes.

- ``obs/fleetlog.py`` and ``obs/stitch.py``: the same events, offsets and
  round trips give the same timeline order, the same
  ``causal_violations`` and the same merged trace.
- ``obs/federation.py``: ``parse_prom_text`` reads the port's exposition;
  against fake backends serving the same documents, each package's prober
  records the same series and values under the same clock; a dead backend
  journals one ``federation_poll_failed``.
- ``obs/push.py``: ``DeltaBuffer``'s cursors, eviction and ``lost`` are the
  JAX package's; a ``DeltaSubscriber`` against a port ``ApiServer`` (TINY)
  resumes after the server stops and starts again with no loss and no
  duplicate, and demotes to polling on a 404.
- The routes: with the gates off and on, each body has the JAX package's
  keys for the same state; ``/internal/deltas`` answers 404 off and 422 on
  a bad cursor; ``/internal/executables`` shows a bucket per captured
  shape and trips ``alarm`` on one precision variant too many.
- ``fleet/slices.py``'s feeds read federation and the alert engine.
- A TINY txt2img through the port's ``ApiServer`` gives the same PNG bytes
  with every gate unset and with each gate set in turn (its daemons
  running); with the gates unset no daemon thread lives and ``tsdb.tick``
  returns 0.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax

from stable_diffusion_webui_distributed_tpu.models.configs import TINY as JTINY
from stable_diffusion_webui_distributed_tpu.obs import (
    federation as j_fed,
)
from stable_diffusion_webui_distributed_tpu.obs import fleetlog as j_fleetlog
from stable_diffusion_webui_distributed_tpu.obs import (
    prometheus as j_prom,
)
from stable_diffusion_webui_distributed_tpu.obs import push as j_push
from stable_diffusion_webui_distributed_tpu.obs import stitch as j_stitch
from stable_diffusion_webui_distributed_tpu.obs import tsdb as j_tsdb
from stable_diffusion_webui_distributed_tpu.obs import alerts as j_alerts
from stable_diffusion_webui_distributed_tpu.obs import notify as j_notify
from stable_diffusion_webui_distributed_tpu.pipeline.engine import (
    Engine as JaxEngine,
)
from stable_diffusion_webui_distributed_tpu.runtime import (
    config as j_config,
)
from stable_diffusion_webui_distributed_tpu.runtime.interrupt import (
    GenerationState as JaxState,
)
from stable_diffusion_webui_distributed_tpu.scheduler import (
    world as j_world,
)
from stable_diffusion_webui_distributed_tpu.server import api as j_api
from stable_diffusion_webui_distributed_tpu_torch import bridge
from stable_diffusion_webui_distributed_tpu_torch.fleet import (
    slices as t_slices,
)
from stable_diffusion_webui_distributed_tpu_torch.models.configs import TINY
from stable_diffusion_webui_distributed_tpu_torch.obs import alerts as t_alerts
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    federation as t_fed,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    fleetlog as t_fleetlog,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    journal as t_journal,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import notify as t_notify
from stable_diffusion_webui_distributed_tpu_torch.obs import perf as t_perf
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    prometheus as t_prom,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import push as t_push
from stable_diffusion_webui_distributed_tpu_torch.obs import spans as t_spans
from stable_diffusion_webui_distributed_tpu_torch.obs import stitch as t_stitch
from stable_diffusion_webui_distributed_tpu_torch.obs import tsdb as t_tsdb
from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import Engine
from stable_diffusion_webui_distributed_tpu_torch.runtime import graphs
from stable_diffusion_webui_distributed_tpu_torch.runtime.interrupt import (
    GenerationState,
)
from stable_diffusion_webui_distributed_tpu_torch.scheduler import (
    world as t_world,
)
from stable_diffusion_webui_distributed_tpu_torch.scheduler.worker import (
    HTTPBackend,
    LocalBackend,
    WorkerNode,
)
from stable_diffusion_webui_distributed_tpu_torch.server import api as t_api
from test_pipeline import init_params

GATES = ("SDTPU_TSDB", "SDTPU_ALERTS", "SDTPU_NOTIFY_URL",
         "SDTPU_NOTIFY_ROUTES", "SDTPU_FEDERATION", "SDTPU_PUSH")
#: the daemon threads of the plane
DAEMONS = ("sdtpu-tsdb-sampler", "sdtpu-federation-prober",
           "sdtpu-notify-drain", "sdtpu-push-")
BODY = dict(prompt="a fleet cow", negative_prompt="blurry", steps=2,
            width=32, height=32, cfg_scale=7, sampler_name="Euler a",
            seed=31)


def reset_all():
    for mod in (t_tsdb, j_tsdb, t_alerts, j_alerts, t_notify, j_notify,
                t_fed, j_fed, t_push, j_push, t_fleetlog, j_fleetlog):
        mod.reset()
    t_prom.clear_histograms()
    j_prom.clear_histograms()


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for name in GATES + ("SDTPU_JOURNAL", "SDTPU_JOURNAL_MAX",
                         "SDTPU_PUSH_CURSOR_BUF", "SDTPU_PUSH_WAIT_S",
                         "SDTPU_TSDB_INTERVAL_S"):
        monkeypatch.delenv(name, raising=False)
    reset_all()
    t_journal.JOURNAL.clear()
    yield
    reset_all()
    t_journal.JOURNAL.clear()


class Clock:
    """A clock that advances 10 ms a read, from ``start``."""

    def __init__(self, start=100.0):
        self.t = start

    def __call__(self):
        self.t += 0.01
        return self.t


def plane_threads():
    return [t.name for t in threading.enumerate()
            if t.is_alive() and t.name.startswith(DAEMONS)]


# -- fleetlog and stitch -------------------------------------------------------

def journal_batches(seed):
    """Per node, batches of journal events with parents, some delivered
    twice, with offsets that move between batches."""
    rng = np.random.default_rng(seed)
    out = []
    for node in ("w1", "w2"):
        seq, t = 0, float(rng.uniform(0, 5))
        events = []
        for _ in range(30):
            seq += int(rng.integers(1, 3))
            t += float(rng.uniform(0.0, 0.2))
            parent = seq - int(rng.integers(1, 4)) if rng.random() < 0.7 \
                else None
            events.append({"seq": seq, "event": "dispatched",
                           "request_id": f"r{int(rng.integers(0, 3))}",
                           "t_mono": t, "parent": parent,
                           "attrs": {"i": seq}})
        for start in range(0, 30, 7):
            batch = events[max(0, start - 2):start + 7]  # a redelivery
            out.append((node, batch, float(rng.normal(0.0, 0.5))))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_fleetlog_matches(seed, monkeypatch):
    monkeypatch.setenv("SDTPU_JOURNAL_MAX", "20")  # evicts per node
    logs = (j_fleetlog.FleetLog(), t_fleetlog.FleetLog())
    for node, batch, offset in journal_batches(seed):
        assert logs[0].ingest(node, batch, offset) == \
            logs[1].ingest(node, batch, offset)
    assert logs[0].stats() == logs[1].stats()
    assert logs[1].stats()["deduped"] > 0 and logs[1].stats()["evicted"] > 0
    assert logs[0].nodes() == logs[1].nodes()
    for rid in (None, "r0", "r2"):
        a, b = logs[0].merged(rid), logs[1].merged(rid)
        assert a == b and len(b) > 0
        assert j_fleetlog.causal_violations(a) == \
            t_fleetlog.causal_violations(b) == []
    rows = logs[1].merged()
    shuffled = [rows[i] for i in np.random.default_rng(seed).permutation(
        len(rows))]
    assert j_fleetlog.causal_violations(shuffled) == \
        t_fleetlog.causal_violations(shuffled)
    assert t_fleetlog.causal_violations(shuffled)


def test_timeline_merges_the_local_journal(monkeypatch):
    monkeypatch.setenv("SDTPU_JOURNAL", "1")
    t_journal.emit("received", "rq")
    t_journal.emit("completed", "rq")
    t_fleetlog.ingest("remote", [
        {"seq": 1, "event": "received", "request_id": "rq",
         "t_mono": time.monotonic(), "parent": None},
        {"seq": 2, "event": "completed", "request_id": "rq",
         "t_mono": time.monotonic(), "parent": 1}], offset_s=0.0)
    doc = t_fleetlog.timeline("rq")
    assert set(doc) == set(j_fleetlog.timeline("rq"))
    assert {e["node"] for e in doc["events"]} == {"local", "remote"}
    assert doc["count"] == 4 and doc["violations"] == 0


class FakeTracer:
    def __init__(self, events):
        self.events = events

    def export_chrome(self):
        return {"traceEvents": [dict(e) for e in self.events]}


def trace_doc(seed, n=6):
    rng = np.random.default_rng(seed)
    events = [{"name": f"s{i}", "ph": "X", "ts": float(rng.uniform(0, 1e6)),
               "dur": 10.0, "pid": 1, "tid": 2,
               "args": {"request_id": "rq", "device_ms": 1.5}}
              for i in range(n)]
    return {"traceEvents": events, "clock_us": float(rng.uniform(1e6, 2e6))}


class JaxRemote:
    """The JAX package's HTTP backend as stitch reads it (``session``)."""

    def __init__(self, doc, label):
        outer = self

        class Resp:
            def raise_for_status(self):
                if outer.doc is None:
                    raise OSError("remote down")

            def json(self):
                return outer.doc

        class Session:
            def get(self, url, timeout=None):
                return Resp()

        self.doc, self.address, self.port = doc, "10.0.0.1", 1
        self.session = Session()
        self.label = label


class PortRemote:
    """The port's HTTP backend as stitch reads it (``fetch``)."""

    def __init__(self, doc, label):
        self.doc, self.address, self.port, self.label = doc, "10.0.0.1", 1, \
            label

    def fetch(self, path, timeout=None):
        if self.doc is None:
            return 503, b""
        return 200, json.dumps(self.doc).encode()


class Node:
    def __init__(self, label, backend):
        self.label, self.backend = label, backend


@pytest.mark.parametrize("seed", [3, 4])
def test_stitch_matches(seed, monkeypatch):
    docs = {"a": trace_doc(seed), "b": trace_doc(seed + 10), "dead": None}
    base = trace_doc(seed + 20)["traceEvents"]
    out = []
    for stitch_mod, Remote in ((j_stitch, JaxRemote), (t_stitch, PortRemote)):
        clock = Clock(start=5e5)
        monkeypatch.setattr(stitch_mod.spans, "now_us", clock)
        source = [Node(label, Remote(doc, label))
                  for label, doc in docs.items()]
        out.append(stitch_mod.stitch(source, tracer=FakeTracer(base)))
    a, b = out
    for node in a["nodes"]:
        node["error"] = bool(node["error"])
    for node in b["nodes"]:
        node["error"] = bool(node["error"])
    assert a == b
    remote = [e for e in b["traceEvents"] if e["pid"] == "worker:a"]
    assert len(remote) == 6 and all(e["args"]["device_ms"] == 1.5
                                    for e in remote)
    offset, rtt = t_stitch.clock_offset_us(docs["a"], 5e5, 5e5 + 20.0)
    assert (offset, rtt) == j_stitch.clock_offset_us(docs["a"], 5e5,
                                                     5e5 + 20.0)


# -- federation ----------------------------------------------------------------

def test_parse_prom_text_reads_the_ports_exposition():
    t_prom.clear_histograms()
    t_prom.worker_count("requests", 4, worker="remote")
    t_prom.worker_count("requests", 2, worker="master")
    t_prom.worker_count("failures", worker="remote")
    text = t_prom.render()
    got = t_fed.parse_prom_text(text)
    want = j_fed.parse_prom_text(text)
    assert set(got) == set(want)
    assert all(got[k] == want[k] or (np.isnan(got[k]) and np.isnan(want[k]))
               for k in got)
    assert got["sdtpu_worker_requests_total"] == 6.0
    assert got["sdtpu_worker_failures_total"] == 1.0
    assert "sdtpu_request_e2e_seconds_count" in got
    t_prom.clear_histograms()


class FedBackend:
    def __init__(self, text, doc):
        self.text, self.doc = text, doc

    def fed_fetch(self):
        if self.doc is None:
            raise ConnectionError("worker down")
        return self.text, self.doc


def fed_workers(seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(3):
        req = int(rng.integers(1, 50))
        fail = int(rng.integers(0, req))
        text = (f"# HELP sdtpu_worker_requests_total x\n"
                f'sdtpu_worker_requests_total{{worker="m"}} {req}\n'
                f'sdtpu_worker_failures_total{{worker="m"}} {fail}\n')
        doc = {"series": {
            "queue_wait_p95_s": {"latest": [1.0, float(rng.uniform(0, 3))]},
            "e2e_p95_s": {"latest": [1.0, float(rng.uniform(0, 9))]}}}
        out.append(Node(f"w{i}", FedBackend(text, doc)))
    out.append(Node("dead", FedBackend("", None)))
    return out


@pytest.mark.parametrize("seed", [0, 5])
def test_prober_records_the_same_series(seed, monkeypatch):
    monkeypatch.setenv("SDTPU_FEDERATION", "1")
    monkeypatch.setenv("SDTPU_JOURNAL", "1")
    out = []
    for fed, tsdb in ((j_fed, j_tsdb), (t_fed, t_tsdb)):
        store = tsdb.SeriesStore()
        prober = fed.FederationProber(source=fed_workers(seed), store=store,
                                      clock=Clock())
        landed = [prober.tick(now=200.0 + i) for i in range(3)]
        summary = prober.summary()
        summary.pop("daemon")
        out.append((landed, store.snapshot(), summary))
    assert out[0] == out[1]
    landed, snap, summary = out[1]
    assert "worker:w0/error_rate" in snap and "fleet/error_rate" in snap
    assert snap["worker:dead/staleness_s"]["latest"][1] > 0
    assert summary["workers"]["dead"]["failures"] == 3
    failed = [e for e in t_journal.JOURNAL.snapshot()["events"]
              if e["event"] == "federation_poll_failed"]
    assert len(failed) == 3 and {e["attrs"]["worker"] for e in failed} == \
        {"dead"}  # one a tick


def test_prober_gate_and_fleet_signal(monkeypatch):
    prober = t_fed.FederationProber(source=fed_workers(0))
    assert prober.tick() == 0 and t_fed.fleet_queue_wait_p95() == 0.0
    assert not t_fed.start_daemon()
    monkeypatch.setenv("SDTPU_FEDERATION", "1")
    t_tsdb.STORE.record("fleet/queue_wait_p95_s", 7.5)
    assert t_fed.fleet_queue_wait_p95() == 7.5
    # the autoscaler's quantile feed folds the federated p95 in
    assert t_slices._default_quantile_source() == 7.5
    eng = t_slices.AutoscaleEngine(t_slices.SliceRegistry(), cooldown_s=0)
    assert eng.quantile_source() == 7.5 and eng.firing_alerts() == []
    t_slices.set_autoscale(None)
    assert set(t_fed.summary()) == set(j_fed.summary())


def test_world_registers_as_source_with_the_gates_on(monkeypatch):
    w = t_world.World()
    assert t_fed.source() is None and t_push.source() is None
    monkeypatch.setenv("SDTPU_FEDERATION", "1")
    monkeypatch.setenv("SDTPU_PUSH", "1")
    w = t_world.World()
    assert t_fed.source() is w and t_push.source() is w
    assert plane_threads() == []  # registration starts nothing


# -- push ----------------------------------------------------------------------

@pytest.mark.parametrize("cap", [16, 40])
def test_delta_buffer_matches(cap):
    out = []
    for push in (j_push, t_push):
        buf = push.DeltaBuffer(capacity=cap, clock=Clock())
        evicted = [buf.publish("sample", {"name": "x", "t": float(i),
                                          "v": float(i * i)})
                   for i in range(30)]
        docs = [buf.collect(c) for c in (0, 5, 14, 29, 30)]
        out.append((evicted, docs, buf.stats()))
    assert out[0] == out[1]
    docs = out[1][1]
    assert docs[0]["lost"] == max(0, 30 - cap)
    assert docs[-1]["entries"] == [] and docs[-1]["next_cursor"] == 30


def test_delta_buffer_ingests_the_ports_sources(monkeypatch):
    monkeypatch.setenv("SDTPU_JOURNAL", "1")
    monkeypatch.setenv("SDTPU_TSDB", "1")
    t_prom.clear_histograms()
    buf = t_push.DeltaBuffer(capacity=64)
    t_journal.emit("received", "rq")
    t_tsdb.STORE.record("queue_wait_p95_s", 0.5, t=1.0)
    t_prom.worker_count("requests", 3, worker="remote")
    kinds = [e["kind"] for e in buf.collect(0)["entries"]]
    assert kinds.count("journal") == 1 and kinds.count("sample") == 1 \
        and kinds.count("counter") == 1
    assert buf.collect(0)["next_cursor"] == 3  # nothing new: no cursor
    t_prom.clear_histograms()


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


def remote_world(engine):
    w = t_world.World()
    w.add_worker(WorkerNode("master", LocalBackend(engine), master=True,
                            avg_ipm=60.0))
    return w


def post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/sdapi/v1/txt2img",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def get(port, route):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                    timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_subscriber_resumes_after_a_restart_and_demotes_on_404(
        engine, monkeypatch):
    monkeypatch.setenv("SDTPU_PUSH", "1")
    monkeypatch.setenv("SDTPU_JOURNAL", "1")
    monkeypatch.setenv("SDTPU_PUSH_WAIT_S", "0")
    monkeypatch.setenv("SDTPU_BUCKET_LADDER", "32x32")
    source = remote_world(engine)
    srv = t_api.ApiServer(source, port=0).start()
    port = srv.port
    sub = t_push.DeltaSubscriber("remote", HTTPBackend("127.0.0.1", port))
    try:
        post(port, dict(BODY, request_id="push-0"))
        assert sub.poll_once() > 0
        srv.stop()
        t_journal.emit("received", "while-down")
        assert sub.poll_once() == 0  # the node is down: a failure, kept
        assert sub.status()["failures"] == 1
        srv = t_api.ApiServer(source, port=port).start()
        t_journal.emit("completed", "while-down")
        sub.poll_once()
        sub.poll_once()
    finally:
        srv.stop()
    st = sub.status()
    assert st["mode"] == "push" and st["lost"] == 0 \
        and st["duplicates"] == 0
    held = t_fleetlog.LOG.merged()
    remote = sorted(e["seq"] for e in held if e["node"] == "remote")
    local = [e["seq"] for e in t_journal.JOURNAL.snapshot()["events"]]
    # every journal event of the worker exactly once, the failure's
    # journal entry and the events while the node was down included
    assert remote == sorted(set(remote)) and set(local) <= set(remote)
    assert {"push-0", "while-down"} <= {e["request_id"] for e in held
                                        if e["node"] == "remote"}

    # a node with the gate off answers 404: the subscriber polls it
    monkeypatch.delenv("SDTPU_PUSH")
    srv = t_api.ApiServer(source, port=0).start()
    try:
        sub2 = t_push.DeltaSubscriber("old", HTTPBackend("127.0.0.1",
                                                         srv.port))
        assert sub2.poll_once() > 0
    finally:
        srv.stop()
    assert sub2.status()["mode"] == "poll"
    assert "worker:old/requests_total" in t_tsdb.STORE.names()
    fallback = [e for e in t_journal.JOURNAL.snapshot()["events"]
                if e["event"] == "push_fallback"]
    assert len(fallback) == 1 and fallback[0]["attrs"]["worker"] == "old"


def test_manager_ticks_and_aggregates(monkeypatch):
    monkeypatch.setenv("SDTPU_PUSH", "1")

    class Seam:
        def __init__(self, buf):
            self.buf = buf

        def push_fetch(self, cursor):
            return self.buf.collect(cursor)

    out = []
    for push, tsdb in ((j_push, j_tsdb), (t_push, t_tsdb)):
        buf = push.DeltaBuffer(capacity=64, clock=Clock())
        for name, total in (("requests_total", 10.0),
                            ("failures_total", 1.0)):
            buf.publish("counter", {"name": name, "total": total})
        store = tsdb.SeriesStore()
        manager = push.PushManager(store=store, clock=Clock())
        manager.set_source([Node("w", Seam(buf))])
        applied = [manager.tick(now=300.0 + i) for i in range(2)]
        status = manager.summary()["workers"]["w"]
        status.pop("daemon")
        out.append((applied, store.snapshot(), status))
    assert out[0] == out[1]
    assert out[1][1]["worker:w/error_rate"]["latest"][1] == 0.1
    assert "fleet/worker_stale_count" in out[1][1]


# -- the routes ----------------------------------------------------------------

ROUTES = ("stitched", "tsdb", "alerts", "fleet", "timeline", "push",
          "executables")


def bodies(server):
    return {
        "stitched": server.handle_stitched_trace(),
        "tsdb": server.handle_tsdb(),
        "alerts": server.handle_alerts(),
        "fleet": server.handle_fleet(),
        "timeline": server.handle_fleet_timeline({"request_id": "x"}),
        "push": server.handle_push(),
        "executables": server.handle_executables(),
    }


def keyset(doc):
    """A document's keys, and those of its dict values, one level down."""
    return {k: sorted(v) if isinstance(v, dict) and k not in (
        "series", "workers", "rules", "registered", "nodes") else None
        for k, v in doc.items()}


@pytest.mark.parametrize("gates", [False, True])
def test_route_bodies_have_the_jax_keys(gates, params, engine,
                                        monkeypatch):
    if gates:
        for name in ("SDTPU_TSDB", "SDTPU_ALERTS", "SDTPU_FEDERATION",
                     "SDTPU_PUSH", "SDTPU_JOURNAL"):
            monkeypatch.setenv(name, "1")
    monkeypatch.setenv("SDTPU_BUCKET_LADDER", "32x32")
    port_world = t_api.ApiServer(remote_world(engine), port=0)
    jax_world = j_api.ApiServer(j_world.World(j_config.ConfigModel()),
                                port=0)
    port_engine = t_api.ApiServer(engine, port=0)
    jax_engine = j_api.ApiServer(JaxEngine(JTINY, params, state=JaxState()),
                                 port=0)
    a, b = bodies(jax_world), bodies(port_world)
    for route in ROUTES:
        assert keyset(a[route]) == keyset(b[route]), route
    assert b["executables"] == {"available": False}
    assert b["tsdb"]["enabled"] is gates and b["push"]["enabled"] is gates
    ja, tb = jax_engine.handle_executables(), port_engine.handle_executables()
    assert set(ja) == set(tb) and tb["available"] and not tb["alarm"]
    for query in ({"cursor": "x"}, {"cursor": "0", "wait_s": "y"},
                  {"cursor": "0", "wait_s": "0"}):
        got = []
        for server in (jax_world, port_world):
            try:
                doc = server.handle_deltas(query)
                got.append((200, sorted(doc)))
            except (j_api.ApiError, t_api.ApiError) as e:
                got.append((e.status, None))
        assert got[0] == got[1]
        if not gates:
            assert got[1][0] == 404
    if gates:
        assert got[1][0] == 200


def test_deltas_over_http_hold_and_codes(engine, monkeypatch):
    monkeypatch.setenv("SDTPU_BUCKET_LADDER", "32x32")
    srv = t_api.ApiServer(remote_world(engine), port=0).start()
    try:
        assert get(srv.port, "/internal/deltas?cursor=0")[0] == 404
        monkeypatch.setenv("SDTPU_PUSH", "1")
        assert get(srv.port, "/internal/deltas?cursor=zz")[0] == 422
        t0 = time.monotonic()
        status, doc = get(srv.port, "/internal/deltas?cursor=999&wait_s=0.3")
        held = time.monotonic() - t0
        assert status == 200 and doc["entries"] == [] and held >= 0.25
        t0 = time.monotonic()
        get(srv.port, "/internal/deltas?cursor=999&wait_s=60")
        assert time.monotonic() - t0 < 5.0 + 2.0  # the hold is capped
        status, doc = get(srv.port, "/internal/push")
        assert status == 200 and doc["enabled"] is True
        for route in ("/internal/tsdb", "/internal/alerts", "/internal/fleet",
                      "/internal/fleet/timeline?request_id=q",
                      "/internal/stitched-trace.json",
                      "/internal/executables"):
            assert get(srv.port, route)[0] == 200, route
    finally:
        srv.stop()


# -- the executables census ----------------------------------------------------

def graph_key(kind, flags, rows=2, lat=(4, 4, 4), lora=None, units=()):
    run = [("ctx", (2 * rows, 77, 32), "f32", False)]
    if lora:
        run.append(("lora/a", lora, "f32", False))
    call = [("x", (rows, *lat), "f32", False)]
    return ("tiny", ((kind, flags, units), tuple(run), tuple(call), 1))


def test_census_maps_graphs_to_the_budget():
    bf16, int8, conv = (False, False), (True, False), (True, True)
    keys = [graph_key("unet", bf16), graph_key("deep", bf16),
            graph_key("reuse", bf16), graph_key("deep-trunc", bf16),
            graph_key("reuse-trunc", bf16), graph_key("unet", int8),
            graph_key("unet", conv), graph_key("cnres", bf16),
            graph_key("cnstep", bf16), graph_key("unet", bf16, rows=1),
            graph_key("unet", bf16, lora=(2, 4, 8)), ("stray",)]
    doc = t_perf.census_from_keys(keys)
    rows = {r["bucket"]: r for r in doc["buckets"]}
    big = rows["tiny latent 4x4x4 rows 2"]
    assert big["step_cache_variants"] == 2
    assert big["precisions"] == ["bf16", "int8", "int8+conv"]
    assert big["lora_variants"] == 1
    # plain x 3 precisions, the step cache at bf16, a LoRA cell at bf16
    assert big["executables"] == 5
    assert not doc["alarm"] and doc["other_executables"] == 1
    assert rows["tiny latent 4x4x4 rows 1"]["executables"] == 1
    ref = __import__("stable_diffusion_webui_distributed_tpu.obs.perf",
                     fromlist=["census_from_keys"]).census_from_keys([])
    assert set(doc) == set(ref)
    assert set(big) == {"bucket", "executables", "step_cache_variants",
                        "precisions", "lora_variants", "over_budget"}
    # a fourth precision variant passes the budget of three
    over = t_perf.census_from_keys(keys + [graph_key("unet", (False, True))])
    assert over["alarm"] and over["over_budget"] == [
        "tiny latent 4x4x4 rows 2"]
    lora = t_perf.census_from_keys(
        [graph_key("unet", bf16, lora=(2, r, 8)) for r in range(5)])
    assert lora["alarm"]


class StubCapture:
    """A capture backend for the CPU: the graph is the function."""

    def eager(self, fn):
        return fn()

    def capture(self, fn):
        out = fn()
        return fn, out

    def replay(self, graph):
        pass


def test_executables_route_on_a_served_engine(params, monkeypatch):
    monkeypatch.setenv("SDTPU_BUCKET_LADDER", "32x32")
    monkeypatch.setenv("SDTPU_BATCH_LADDER", "1")
    eng = Engine(TINY, bridge.flax_to_torch(TINY, params), chunk_size=2,
                 state=GenerationState(), device="cpu")
    eng._graphs = graphs.GraphCache(capture=StubCapture())
    srv = t_api.ApiServer(eng, port=0).start()
    try:
        post(srv.port, BODY)
        status, doc = get(srv.port, "/internal/executables")
        assert status == 200 and doc["available"] and not doc["alarm"]
        assert [r["bucket"] for r in doc["buckets"]] == [
            "tiny latent 16x16x4 rows 1"]
        assert doc["buckets"][0]["precisions"] == ["bf16"]
        keys = eng.executable_keys()
        monkeypatch.setattr(eng, "executable_keys", lambda: keys + [
            (m, ((k[0][0], flags) + k[0][2:], *k[1:])) for m, k in keys
            for flags in ((True, False), (True, True), (False, True))])
        status, doc = get(srv.port, "/internal/executables")
        assert doc["alarm"] and doc["over_budget"] == [
            "tiny latent 16x16x4 rows 1"]
    finally:
        srv.stop()


# -- the gates' bytes ----------------------------------------------------------

GATE_VALUES = {"SDTPU_TSDB": "1", "SDTPU_ALERTS": "1",
               "SDTPU_NOTIFY_URL": "http://127.0.0.1:9/hook",
               "SDTPU_NOTIFY_ROUTES": "page=http://127.0.0.1:9/page",
               "SDTPU_FEDERATION": "1", "SDTPU_PUSH": "1"}


def test_every_gate_gives_the_gates_off_bytes(engine, monkeypatch):
    monkeypatch.setenv("SDTPU_BUCKET_LADDER", "32x32")
    monkeypatch.setenv("SDTPU_TSDB_INTERVAL_S", "0.01")
    srv = t_api.ApiServer(engine, port=0).start()
    try:
        ref = post(srv.port, BODY)["images"]
        assert plane_threads() == []
        assert t_tsdb.tick() == 0 and t_fed.tick() == 0 \
            and t_push.tick() == 0
        for gate, value in GATE_VALUES.items():
            monkeypatch.setenv(gate, value)
            t_fed.set_source(remote_world(engine))
            t_push.set_source(remote_world(engine))
            started = (t_tsdb.start_daemon(), t_fed.start_daemon(),
                       t_push.start_daemons())
            assert post(srv.port, BODY)["images"] == ref, gate
            t_tsdb.stop_daemon()
            t_fed.stop_daemon()
            t_push.stop_daemons()
            t_notify.reset()
            assert started[0] == (gate == "SDTPU_TSDB")
            monkeypatch.delenv(gate)
    finally:
        srv.stop()
    assert plane_threads() == []


# -- no synchronisation ----------------------------------------------------------

@pytest.mark.parametrize("module", [t_tsdb, t_alerts, t_notify, t_stitch,
                                    t_fleetlog, t_fed, t_push],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_the_plane_never_waits_for_the_card(module, monkeypatch):
    """No sample, poll, delivery or merge synchronises the card: the
    plane's modules name no synchronising call, and a tick with every gate
    on runs with ``torch.cuda.synchronize`` made to fail."""
    import ast
    import inspect

    import torch

    calls = {node.func.attr for node in ast.walk(ast.parse(
        inspect.getsource(module)))
        if isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)}
    assert not calls & {"synchronize", "item", "cpu", "tolist"}
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: pytest.fail(
        "the plane synchronised the card"))
    for gate in ("SDTPU_TSDB", "SDTPU_ALERTS", "SDTPU_FEDERATION",
                 "SDTPU_PUSH"):
        monkeypatch.setenv(gate, "1")
    monkeypatch.setenv("SDTPU_PUSH_WAIT_S", "0")
    t_fed.set_source(fed_workers(1))
    assert t_tsdb.tick() > 0 and t_fed.tick() > 0
    t_push.tick()
