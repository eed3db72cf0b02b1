"""The port's request journal, chaos plan and their routes against the JAX
package's, on the CPU.

- ``obs/journal.py``: the ring, the causal parents, the closed event set,
  the sink spill and its one rotation give the JAX journal's documents
  and files for the same emits;
- the journal of one dispatcher flow (a coalesced pair, a result-cache
  hit, a prefix resume) on TINY engines, and of one World flow over stub
  workers with a ``kill`` fault, equal the JAX package's: event names,
  request ids and attributes per request, in order; the ``received``
  fingerprints are equal (the two payload dumps are);
- ``ChaosPlan.consult`` delivers each kind (``at_request``, ``count``, the
  worker match) as the JAX plan does; a ``kill`` is requeued to a complete
  gallery with the seeds of the request; ``arm`` refuses without
  ``SDTPU_SIM`` and ``disarm`` leaves every seam None;
- ``POST /internal/cancel``, ``GET /internal/journal`` and ``GET
  /internal/sim`` answer the JAX server's documents, and a cancel through
  the route empties one member of a coalesced group and leaves its peer's
  bytes unchanged.

Pixels of the two packages' engines agree within 1 uint8 level
(``tests/test_torch_engine.py``'s tolerance); the journal's ``completed``
events carry seeds and infotexts, which are equal.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax

from stable_diffusion_webui_distributed_tpu import cache as jax_cache
from stable_diffusion_webui_distributed_tpu import sim as jax_sim
from stable_diffusion_webui_distributed_tpu.models.configs import TINY as JTINY
from stable_diffusion_webui_distributed_tpu.obs import journal as jax_journal
from stable_diffusion_webui_distributed_tpu.pipeline.engine import (
    Engine as JaxEngine,
)
from stable_diffusion_webui_distributed_tpu.pipeline.payload import (
    GenerationPayload as JaxPayload,
)
from stable_diffusion_webui_distributed_tpu.runtime import config as jconfig
from stable_diffusion_webui_distributed_tpu.runtime.interrupt import (
    GenerationState as JaxState,
)
from stable_diffusion_webui_distributed_tpu.scheduler import worker as jworker
from stable_diffusion_webui_distributed_tpu.scheduler import world as jworld
from stable_diffusion_webui_distributed_tpu.server.api import (
    ApiError as JaxApiError,
)
from stable_diffusion_webui_distributed_tpu.server.api import (
    ApiServer as JaxApiServer,
)
from stable_diffusion_webui_distributed_tpu.serving import (
    dispatcher as jdispatcher,
)
from stable_diffusion_webui_distributed_tpu.serving.bucketer import (
    ShapeBucketer as JaxBucketer,
)
from stable_diffusion_webui_distributed_tpu.sim import chaos as jax_chaos
from stable_diffusion_webui_distributed_tpu_torch import bridge, cache, sim
from stable_diffusion_webui_distributed_tpu_torch.models.configs import TINY
from stable_diffusion_webui_distributed_tpu_torch.obs import journal
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    prometheus as obs_prom,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import Engine
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
    b64png_to_array,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.interrupt import (
    GenerationState,
)
from stable_diffusion_webui_distributed_tpu_torch.scheduler import (
    worker as pworker,
)
from stable_diffusion_webui_distributed_tpu_torch.scheduler import (
    world as pworld,
)
from stable_diffusion_webui_distributed_tpu_torch.server.api import (
    ApiError,
    ApiServer,
)
from stable_diffusion_webui_distributed_tpu_torch.serving import (
    dispatcher as pdispatcher,
)
from stable_diffusion_webui_distributed_tpu_torch.serving.bucketer import (
    ShapeBucketer,
)
from stable_diffusion_webui_distributed_tpu_torch.sim import chaos
from test_pipeline import init_params

#: seconds any one thread of a test may take before the test fails
THREAD_LIMIT = 60.0

DEFAULTS = dict(prompt="a journal cow", steps=4, width=32, height=32,
                seed=7, subseed=3, sampler_name="DPM++ 2M")


def payload(**kw):
    return GenerationPayload(**{**DEFAULTS, **kw})


def jax_payload(**kw):
    return JaxPayload(**{**DEFAULTS, **kw})


@pytest.fixture(scope="module")
def params():
    """TINY's parameter tree filled from a seeded numpy stream: the
    journal does not read the weights, and a traced shape costs a second
    where compiling ``init_params`` costs twenty."""
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


@pytest.fixture()
def journal_on(monkeypatch):
    monkeypatch.setenv("SDTPU_JOURNAL", "1")
    journal.JOURNAL.clear()
    jax_journal.JOURNAL.clear()
    yield
    journal.JOURNAL.clear()
    jax_journal.JOURNAL.clear()


@pytest.fixture()
def sim_on(monkeypatch):
    monkeypatch.setenv("SDTPU_SIM", "1")
    yield
    chaos.disarm()
    jax_chaos.disarm()


def strip(events):
    """Events without their clock reading."""
    return [{k: v for k, v in e.items() if k != "t_mono"} for e in events]


def by_request(events):
    """Each request's ``(event, attrs, parent index)`` in seq order; a
    parent is the index of the request's own earlier event, so the two
    packages' interleaving of concurrent requests does not matter."""
    out, index = {}, {}
    for e in sorted(events, key=lambda e: e["seq"]):
        rows = out.setdefault(e["request_id"], [])
        rows.append((e["event"], e["attrs"], index.get(e["parent"])))
        index[e["seq"]] = len(rows) - 1
    return out


def joined(threads):
    for t in threads:
        t.join(THREAD_LIMIT)
        assert not t.is_alive(), "a thread outlived its limit"


# -- the journal ---------------------------------------------------------------

def test_event_set_is_the_jax_set():
    assert journal.EVENTS == jax_journal.EVENTS


def emits(j):
    """A fixed sequence: default and explicit parents, a request id past
    the ring, attributes of several types."""
    j.emit("received", "a", job="txt2img", payload={"seed": 1})
    j.emit("bucketed", "a", bucketed=True, bucket="32x32")
    j.emit("coalesced_leader", "a", images=1, leader_request_id="a")
    first = j.emit("received", "b", job="txt2img")
    j.emit("coalesced_follower", "b", parent=first["seq"] - 1, images=2,
           leader_request_id="a")
    j.emit("dispatched", "a", group=2, precision="bf16")
    j.emit("completed", "b", images=2, seeds=[3, 4], infotexts=["x", "y"])
    j.emit("completed", "a", images=1, seeds=[1], infotexts=["z"])


def test_ring_and_parents_match_jax(journal_on):
    port, ref = journal.EventJournal(5), jax_journal.EventJournal(5)
    emits(port)
    emits(ref)
    got, want = port.snapshot(), ref.snapshot()
    assert {k: v for k, v in got.items() if k != "events"} == \
        {k: v for k, v in want.items() if k != "events"}
    assert strip(got["events"]) == strip(want["events"])
    assert got["count"] == 5 and got["total_emitted"] == 8
    assert strip(port.snapshot("b")["events"]) == \
        strip(ref.snapshot("b")["events"])
    assert strip(port.events_for("a")) == strip(ref.events_for("a"))


def test_unregistered_event_raises_and_off_is_a_noop(monkeypatch):
    monkeypatch.setenv("SDTPU_JOURNAL", "1")
    for j in (journal.EventJournal(4), jax_journal.EventJournal(4)):
        with pytest.raises(ValueError):
            j.emit("meteor_strike", "r")
    monkeypatch.delenv("SDTPU_JOURNAL")
    for j in (journal.EventJournal(4), jax_journal.EventJournal(4)):
        assert j.emit("received", "r") is None
        assert len(j) == 0


def lines(path):
    try:
        with open(path) as f:
            return [{k: v for k, v in json.loads(line).items()
                     if k != "t_mono"} for line in f]
    except FileNotFoundError:
        return None


def test_sink_spill_and_rotation_match_jax(journal_on, tmp_path,
                                           monkeypatch):
    monkeypatch.setenv("SDTPU_JOURNAL_SINK_MAX_MB", str(700 / 2**20))
    out = {}
    for name, mod in (("port", journal), ("jax", jax_journal)):
        sink = str(tmp_path / f"{name}.jsonl")
        monkeypatch.setenv("SDTPU_JOURNAL_SINK", sink)
        j = mod.EventJournal(2)
        for i in range(9):
            j.emit("received", f"r{i % 3}", index=i, note="x" * 40)
        status = j.sink_status()
        assert status.pop("path") == sink
        # the lines' clock readings differ in length
        assert status.pop("bytes") == os.path.getsize(sink)
        out[name] = (status, lines(sink), lines(sink + ".1"),
                     strip(j.snapshot()["events"]))
    assert out["port"] == out["jax"]
    status, current, rotated, ring = out["port"]
    assert status["spilled"] == 7 and status["rotations"] >= 1
    # ring and sink together keep every event once
    seqs = sorted(e["seq"] for part in (current, rotated or [], ring)
                  for e in part)
    assert seqs[-len(ring) - len(current):] == list(
        range(10 - len(ring) - len(current), 10))


# -- the chaos plan ----------------------------------------------------------------

CONSULTS = [("worker.generate", "w1"), ("dispatcher.submit", ""),
            ("worker.generate", "w2"), ("worker.generate", "w1"),
            ("world.execute", ""), ("worker.generate", "w2"),
            ("worker.generate", "w1"), ("other.site", ""),
            ("worker.generate", "w1"), ("worker.generate", "w2")]


def deliveries(mod, faults):
    """What each consult of the script delivered: the error raised (or
    None) and the plan's status after it."""
    plan = mod.ChaosPlan([mod.Fault(**f) for f in faults], seed=5)
    out = []
    for site, worker in CONSULTS:
        try:
            plan.consult(site, worker=worker)
            err = None
        except ConnectionError as e:
            err = str(e)
        out.append((err, plan.status()))
    return out


@pytest.mark.parametrize("faults", [
    [dict(kind="kill", worker="w1", at_request=1)],
    [dict(kind="http_error", worker="w2", at_request=1, count=2)],
    [dict(kind="stall", at_request=2)],
    [dict(kind="slow", worker="any", count=3)],
    [dict(kind="kill", worker="w2", at_request=2),
     dict(kind="http_error", worker="", count=2)],
], ids=["kill-w1", "http-error-count-2", "stall-at-2", "slow-any-3",
        "two-faults"])
def test_consult_delivers_as_jax(faults, journal_on):
    counted = obs_prom.SIM_FAULT_COUNTER.total()
    got = deliveries(chaos, faults)
    want = deliveries(jax_chaos, faults)
    assert got == want
    injected = sum(f["injected"] for f in got[-1][1]["faults"])
    assert obs_prom.SIM_FAULT_COUNTER.total() - counted == injected
    assert [e["event"] for e in journal.JOURNAL.snapshot()["events"]] == \
        [e["event"] for e in jax_journal.JOURNAL.snapshot()["events"]]


def test_unknown_kind_rejected():
    with pytest.raises(ValueError):
        chaos.Fault(kind="meteor")


def seams():
    return (pworker.CHAOS_HOOK, pworld.CHAOS_HOOK, pdispatcher.CHAOS_HOOK)


def test_arm_refused_without_sim(monkeypatch):
    monkeypatch.delenv("SDTPU_SIM", raising=False)
    assert seams() == (None, None, None)
    with pytest.raises(RuntimeError):
        chaos.arm(chaos.ChaosPlan([chaos.Fault(kind="kill")]))
    with pytest.raises(RuntimeError):
        jax_chaos.arm(jax_chaos.ChaosPlan([jax_chaos.Fault(kind="kill")]))
    assert seams() == (None, None, None)
    assert chaos.status() == {"armed": False, "plan": None}


def stub_world(pkg):
    world_mod, worker_mod = pkg
    cfg = (jconfig.ConfigModel(),) if world_mod is jworld else ()
    w = world_mod.World(*cfg)
    for label in ("survivor", "victim"):
        w.add_worker(worker_mod.WorkerNode(
            label, worker_mod.StubBackend(
                worker_mod.StubBehavior(seconds_per_image=0.001)),
            avg_ipm=2400.0))
    return w


ORDERED = ("planned", "fault_injected", "fault_cleared", "job_failed",
           "requeued", "completed")


def test_kill_is_requeued_and_journaled_as_jax(sim_on, journal_on):
    """A ``kill`` on the victim at request 1: the gallery is complete with
    the request's seeds, the fault is counted once, and the journal holds
    the JAX package's events (fault_injected, fault_cleared, job_failed,
    requeued, completed in that order)."""
    out = {}
    for name, pkg, ch, jmod, pay in (
            ("port", (pworld, pworker), chaos, journal, payload),
            ("jax", (jworld, jworker), jax_chaos, jax_journal,
             jax_payload)):
        w = stub_world(pkg)
        plan = ch.ChaosPlan([ch.Fault(kind="kill", worker="victim",
                                      at_request=1)], seed=11)
        counted = obs_prom.SIM_FAULT_COUNTER.total()
        ch.arm(plan)
        try:
            result = w.execute(pay(seed=50, subseed=9, steps=8,
                                   batch_size=4, width=512, height=512,
                                   request_id="kill-0"))
        finally:
            ch.disarm()
        events = jmod.JOURNAL.snapshot()["events"]
        out[name] = (result.seeds, result.images, result.worker_labels,
                     plan.status(), events)
        if name == "port":
            assert obs_prom.SIM_FAULT_COUNTER.total() - counted == 1
            assert seams() == (None, None, None)
    seeds, images, labels, status, events = out["port"]
    assert seeds == [50, 51, 52, 53] and len(set(images)) == 4
    assert labels == ["survivor"] * 4
    assert status["faults"][0]["injected"] == 1
    assert status["faults"][0]["cleared"] is True
    assert out["port"][:4] == out["jax"][:4]

    def rows(evs):
        return sorted(json.dumps([e["event"], e["request_id"], e["attrs"]],
                                 sort_keys=True) for e in evs)

    # the fan-out threads interleave: the same events, the decisions in
    # order
    assert rows(events) == rows(out["jax"][4])
    names = [e["event"] for e in events if e["event"] in ORDERED]
    assert names == [e["event"] for e in out["jax"][4]
                     if e["event"] in ORDERED] == list(ORDERED)


def test_http_error_clears_after_count(sim_on):
    w = stub_world((pworld, pworker))
    plan = chaos.arm(chaos.ChaosPlan([chaos.Fault(
        kind="http_error", worker="victim", at_request=1, count=1)],
        seed=13))
    try:
        first = w.execute(payload(seed=70, batch_size=4))
        second = w.execute(payload(seed=80, batch_size=4))
    finally:
        chaos.disarm()
    assert first.seeds == [70, 71, 72, 73]
    assert second.seeds == [80, 81, 82, 83]
    assert plan.status()["faults"][0]["remaining"] == 0


# -- the dispatcher's journal ----------------------------------------------------

def coalesced_pair(disp, pay):
    """Two requests submitted 50 ms apart inside one coalesce window."""
    results, threads = {}, []
    for rid, seed in (("pair-a", 31), ("pair-b", 32)):
        def run(rid=rid, seed=seed):
            results[rid] = disp.submit(pay(seed=seed, request_id=rid))
        threads.append(threading.Thread(target=run))
        threads[-1].start()
        time.sleep(0.05)
    joined(threads)
    return results


def test_dispatcher_journal_matches_jax(engine, jax_engine, journal_on,
                                        monkeypatch):
    """A coalesced pair, a repeat of its first member (a result hit) and a
    prefix pair through both packages' dispatchers: each request's events,
    attributes and causal links equal the JAX journal's."""
    monkeypatch.setenv("SDTPU_CACHE", "1")
    monkeypatch.setenv("SDTPU_CACHE_PREFIX_MIN_STEPS", "2")
    results = {}
    for name, disp_cls, bucketer, eng, pay, jmod, cache_mod in (
            ("port", pdispatcher.ServingDispatcher, ShapeBucketer, engine,
             payload, journal, cache),
            ("jax", jdispatcher.ServingDispatcher, JaxBucketer, jax_engine,
             jax_payload, jax_journal, jax_cache)):
        cache_mod.clear_all()
        try:
            pair = disp_cls(eng, bucketer=bucketer(shapes=[(32, 32)],
                                                   batches=[2]), window=0.4)
            got = coalesced_pair(pair, pay)
            got["hit"] = pair.submit(pay(seed=31, request_id="hit"))
            # a group of one request of 2 images: its range is the whole
            # request, so its carry is prefix-keyed
            for rid, strength in (("prefix-a", 0.4), ("prefix-b", 0.7)):
                got[rid] = pair.submit(pay(
                    seed=41, prompt="prefix cow", batch_size=2,
                    denoising_strength=strength, request_id=rid))
        finally:
            cache_mod.clear_all()
        results[name] = (got, by_request(jmod.JOURNAL.snapshot()["events"]))
    (got, events), (want, want_events) = results["port"], results["jax"]
    assert events == want_events
    assert set(events) == {"pair-a", "pair-b", "hit", "prefix-a",
                           "prefix-b"}
    # the follower shares its leader's negative prompt: one embed hit
    assert [e for e, _, _ in events["pair-b"]] == [
        "received", "bucketed", "coalesced_follower", "dispatched",
        "embed_cache_hit", "merged", "completed"]
    assert [e for e, _, _ in events["hit"]] == [
        "received", "result_dedupe_hit", "completed"]
    assert "prefix_resumed" in [e for e, _, _ in events["prefix-b"]]
    fp = events["pair-a"][0][1]["fingerprint"]
    assert fp == want_events["pair-a"][0][1]["fingerprint"]
    for rid, res in got.items():
        assert res.seeds == want[rid].seeds
        assert res.infotexts == want[rid].infotexts
        for a, b in zip(res.images, want[rid].images):
            diff = np.abs(b64png_to_array(a).astype(np.int32)
                          - b64png_to_array(b).astype(np.int32))
            assert diff.max() <= 1


# -- the routes ----------------------------------------------------------------

def test_route_documents_match_jax(monkeypatch, journal_on):
    port = ApiServer(stub_world((pworld, pworker)), port=0)
    ref = JaxApiServer(stub_world((jworld, jworker)), state=JaxState(),
                       port=0)
    for srv in (port, ref):
        assert ("POST", "/internal/cancel") in srv.routes()
        assert ("GET", "/internal/journal") in srv.routes()
        assert ("GET", "/internal/sim") in srv.routes()
    with pytest.raises(ApiError) as e:
        port.handle_cancel({})
    with pytest.raises(JaxApiError) as je:
        ref.handle_cancel({})
    assert e.value.status == je.value.status == 422
    assert port.handle_cancel({"request_id": "nobody"}) == \
        ref.handle_cancel({"request_id": "nobody"}) == {"cancelled": False}
    journal.emit("received", "r1", job="txt2img")
    jax_journal.emit("received", "r1", job="txt2img")
    for query in ({}, {"request_id": "r1"}, {"request_id": "none"}):
        got = port.handle_journal(query)
        want = ref.handle_journal_get(query)
        assert strip(got.pop("events")) == strip(want.pop("events"))
        assert got == want
    monkeypatch.delenv("SDTPU_SIM", raising=False)
    got, want = port.handle_sim(), ref.handle_sim()
    assert got == want == {
        "enabled": False, "chaos": {"armed": False, "plan": None},
        "last_run": None, "sink": got["sink"]}
    assert set(got["sink"]) == {"path", "spilled", "bytes", "rotations"}
    monkeypatch.setenv("SDTPU_SIM", "1")
    for mod, ch, srv in ((sim, chaos, port), (jax_sim, jax_chaos, ref)):
        ch.arm(ch.ChaosPlan([ch.Fault(kind="slow", worker="w0",
                                      duration_s=0.1)]))
        mod.record_last_run("steady", {"requests": 3})
        try:
            body = srv.handle_sim()
        finally:
            ch.disarm()
            mod.clear_last_run()
        assert body["enabled"] is True and body["chaos"]["armed"] is True
        assert body["chaos"]["plan"]["faults"][0]["kind"] == "slow"
        assert body["last_run"] == {"name": "steady",
                                    "score": {"requests": 3}}


def http(srv, route, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{route}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=THREAD_LIMIT) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_cancel_through_the_route_empties_one_member(engine, journal_on,
                                                     monkeypatch):
    """Two requests coalesce into one group; the second is cancelled over
    ``POST /internal/cancel`` while the group denoises: its result is
    empty and marked cancelled, the first's bytes are those of the same
    group run without a cancel, and the journal shows the cancelled
    member merged nowhere."""
    monkeypatch.delenv("SDTPU_CACHE", raising=False)
    srv = ApiServer(engine, port=0)
    srv.dispatcher = pdispatcher.ServingDispatcher(
        engine, bucketer=ShapeBucketer(shapes=[(32, 32)], batches=[2]),
        window=0.4)
    srv.start()
    bodies = [dict(DEFAULTS, seed=51, request_id="keep"),
              dict(DEFAULTS, seed=52, request_id="drop")]
    try:
        def run_pair():
            out, threads = {}, []
            for body in bodies:
                def post(body=body):
                    out[body["request_id"]] = http(srv, "/sdapi/v1/txt2img",
                                                   body)
                threads.append(threading.Thread(target=post))
                threads[-1].start()
                time.sleep(0.05)
            joined(threads)
            return out

        baseline = run_pair()
        answers = []
        denoise = engine._denoise

        def cancelling(*a, **k):
            answers.append(http(srv, "/internal/cancel",
                                {"request_id": "drop"}))
            return denoise(*a, **k)

        monkeypatch.setattr(engine, "_denoise", cancelling)
        journal.JOURNAL.clear()
        got = run_pair()
        status, missing = http(srv, "/internal/cancel", {})
        journal_doc = http(srv, "/internal/journal?request_id=drop")[1]
    finally:
        srv.stop()
    assert answers == [(200, {"cancelled": True})]
    assert status == 422 and "request_id" in missing["detail"]
    assert got["drop"][0] == 200 and got["drop"][1]["images"] == []
    assert got["drop"][1]["parameters"]["cancelled"] is True
    assert got["keep"][1]["images"] == baseline["keep"][1]["images"]
    assert len(baseline["drop"][1]["images"]) == 1
    names = [e["event"] for e in journal_doc["events"]]
    assert names[:3] == ["received", "bucketed", "coalesced_follower"]
    assert "merged" not in names and names[-1] == "completed"
    assert journal_doc["events"][-1]["attrs"]["images"] == 0
