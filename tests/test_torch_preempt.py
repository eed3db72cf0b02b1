"""Chunk-boundary preemption and the fleet-gated dispatcher of the port, on
TINY engines on the CPU.

The JAX package's ``TestEnginePreemptResume`` and
``TestDispatcherPreemption`` / ``TestDispatcherFleet``
(``tests/test_fleet.py``) carried to the port, whose generations all run
on one engine thread (``runtime/runner.py``): a yield serves the
interloper nested on that thread. Held here:

- a preempted batch-class request (5 images, 32 steps at ``chunk_size``
  4, through the dispatcher with ``SDTPU_FLEET=1`` and quantum 0) gives
  its unpreempted bytes and the JAX TINY engine's pixels within 1 uint8
  level (``tests/test_torch_engine.py``'s tolerance), and the preemption
  ends: every thread is joined under its own time limit, so a deadlock
  on the engine thread fails the test instead of stalling the suite;
- the resumed job's graph inputs come back (a stand-in capture backend,
  the interloper on the same graph entry with other conditioning), its
  adapters come back after a merged-LoRA interloper, an interloper's
  interrupt does not truncate it and a pre-yield interrupt survives;
- the hook is cleared between requests; ``SDTPU_FLEET`` off builds no
  gate, quotas or admission and installs no hook;
- quota refusals, SLO degrade and reject (no metric fed, quota refunded),
  a cancelled ticket's missing wait, the server's 429 with
  ``Retry-After`` and ``GET /internal/autoscale``.
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
from stable_diffusion_webui_distributed_tpu.pipeline.engine import (
    Engine as JaxEngine,
)
from stable_diffusion_webui_distributed_tpu.pipeline.payload import (
    GenerationPayload as JaxPayload,
)
from stable_diffusion_webui_distributed_tpu.runtime.interrupt import (
    GenerationState as JaxState,
)
from stable_diffusion_webui_distributed_tpu_torch import bridge
from stable_diffusion_webui_distributed_tpu_torch.fleet import slices
from stable_diffusion_webui_distributed_tpu_torch.fleet.admission import (
    FleetRejected,
)
from stable_diffusion_webui_distributed_tpu_torch.fleet.policy import (
    BATCH,
    INTERACTIVE,
)
from stable_diffusion_webui_distributed_tpu_torch.models.configs import TINY
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    prometheus as obs_prom,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import Engine
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
    b64png_to_array,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import graphs
from stable_diffusion_webui_distributed_tpu_torch.runtime.interrupt import (
    GenerationState,
)
from stable_diffusion_webui_distributed_tpu_torch.scheduler.eta import (
    EtaCalibration,
)
from stable_diffusion_webui_distributed_tpu_torch.server.api import ApiServer
from stable_diffusion_webui_distributed_tpu_torch.serving.bucketer import (
    ShapeBucketer,
)
from stable_diffusion_webui_distributed_tpu_torch.serving.dispatcher import (
    ServingDispatcher,
)
from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
    METRICS,
)
from test_pipeline import init_params
from test_torch_lora import make_adapter
from test_torch_warmup import Stub

#: seconds any one thread of a test may take before the test fails
THREAD_LIMIT = 30.0


@pytest.fixture(scope="module")
def params():
    return jax.device_get(jax.jit(init_params, static_argnums=0)(JTINY))


@pytest.fixture(scope="module")
def engine(params):
    return Engine(TINY, bridge.flax_to_torch(TINY, params), chunk_size=4,
                  state=GenerationState(), device="cpu")


@pytest.fixture
def bucketer():
    return ShapeBucketer(shapes=[(32, 32), (48, 48)], batches=[4])


@pytest.fixture(autouse=True)
def fleet_env(monkeypatch):
    for name in ("SDTPU_FLEET", "SDTPU_QUOTA_IPM", "SDTPU_QUOTA_BURST",
                 "SDTPU_POOL", "SDTPU_CACHE", "SDTPU_SLO_INTERACTIVE_S"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("SDTPU_FLEET_QUANTUM_S", "0")


def tiny(**kw):
    defaults = dict(prompt="a cow", steps=4, width=32, height=32, seed=7,
                    sampler_name="Euler a")
    defaults.update(kw)
    return GenerationPayload(**defaults)


def in_thread(fn, *args):
    """``fn(*args)`` on a daemon thread: (thread, box); ``finish`` joins
    it under :data:`THREAD_LIMIT` and returns its result."""
    box = {}

    def run():
        try:
            box["result"] = fn(*args)
        except BaseException as e:  # noqa: BLE001 — re-raised by finish
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, box


def finish(t, box):
    t.join(timeout=THREAD_LIMIT)
    assert not t.is_alive(), "a thread did not finish: deadlock"
    if "error" in box:
        raise box["error"]
    return box["result"]


def wait_for(cond, what: str):
    deadline = time.monotonic() + THREAD_LIMIT
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.002)


# -- engine resume (a stand-in hook, as the JAX package's tests) -------------

class OneShotHook:
    """Fires at the second chunk boundary and runs a whole request on the
    same engine from inside the yield (on the engine thread: inline, as a
    served interloper runs), then never fires again."""

    def __init__(self, engine, interloper):
        self.engine = engine
        self.interloper = interloper
        self.polls = 0
        self.fired = 0
        self.result = None

    def should_yield(self):
        self.polls += 1
        return self.fired == 0 and self.polls >= 2

    def yield_device(self):
        self.fired += 1
        self.result = self.engine.generate_range(self.interloper, 0, None,
                                                 "txt2img")


def preempted(engine, hook, payload):
    """``payload`` with ``hook`` installed, under the thread limit."""
    engine.preempt_hook = hook
    try:
        return finish(*in_thread(engine.generate_range, payload, 0, None,
                                 "txt2img"))
    finally:
        engine.preempt_hook = None


def test_resume_restores_its_graph_inputs(params, engine):
    # the stand-in capture backend: both requests run the one graph entry
    # of their signature (batch 1, 32x32, 77 tokens) with their own
    # conditioning, so the resumed job must get its per-run inputs back;
    # the eager engine gives both requests' bytes
    eng = Engine(TINY, bridge.flax_to_torch(TINY, params), chunk_size=4,
                 state=GenerationState(), device="cpu")
    eng._graphs = graphs.GraphCache(capture=Stub())
    batch_p = tiny(steps=8, seed=70, prompt="a red barn")
    inter_p = tiny(steps=4, seed=71, prompt="a cow in snow")
    baseline = engine.generate_range(batch_p, 0, None, "txt2img")
    warm_inter = engine.generate_range(inter_p, 0, None, "txt2img")
    assert eng.generate_range(batch_p, 0, None, "txt2img").images \
        == baseline.images
    assert len(eng._graphs) == 1
    METRICS.clear()
    hook = OneShotHook(eng, inter_p)
    got = preempted(eng, hook, batch_p)
    assert hook.fired == 1
    assert hook.result.images == warm_inter.images
    assert got.images == baseline.images
    assert got.seeds == baseline.seeds and got.infotexts == baseline.infotexts
    assert METRICS.summary()["compiles"] == {}  # every call replayed


def test_resume_after_lora_interloper_keeps_its_weights(engine, monkeypatch):
    adapters = {"style": make_adapter(TINY, seed=5, scale=0.5)}
    monkeypatch.setattr(engine, "lora_provider", adapters.get)
    batch_p = tiny(steps=8, seed=72)
    inter_p = tiny(steps=4, seed=73, prompt="a cow <lora:style:1.0>")
    baseline = engine.generate_range(batch_p, 0, None, "txt2img")
    warm_inter = engine.generate_range(inter_p, 0, None, "txt2img")
    engine.set_loras(())
    hook = OneShotHook(engine, inter_p)
    got = preempted(engine, hook, batch_p)
    assert hook.fired == 1
    assert hook.result.images == warm_inter.images
    assert warm_inter.images != baseline.images  # the adapter changes it
    assert got.images == baseline.images
    assert engine._pristine == {}  # back on the pristine weights


def test_interloper_interrupt_does_not_truncate_resumed_job(engine):
    batch_p = tiny(steps=8, seed=74)
    inter_p = tiny(steps=4, seed=75)
    baseline = engine.generate_range(batch_p, 0, None, "txt2img")

    class InterruptingHook(OneShotHook):
        def yield_device(self):
            super().yield_device()
            # still latched when the yielded job takes the device back
            self.engine.state.flag.interrupt()

    hook = InterruptingHook(engine, inter_p)
    try:
        got = preempted(engine, hook, batch_p)
    finally:
        engine.state.flag.clear()
    assert hook.fired == 1
    assert got.images == baseline.images
    assert got.seeds == baseline.seeds


def test_pre_yield_interrupt_survives_interloper(engine):
    batch_p = tiny(steps=8, seed=76)
    inter_p = tiny(steps=4, seed=77)
    warm_inter = engine.generate_range(inter_p, 0, None, "txt2img")

    class LatchThenYieldHook(OneShotHook):
        def should_yield(self):
            fire = super().should_yield()
            if fire:
                self.engine.state.flag.interrupt()
            return fire

        def yield_device(self):
            self.fired += 1
            # a top-level interloper clears the process-global latch
            self.engine.state.begin_request()
            self.result = self.engine.generate_range(self.interloper, 0,
                                                     None, "txt2img")

    hook = LatchThenYieldHook(engine, inter_p)
    try:
        engine.state.begin_request()
        preempted(engine, hook, batch_p)
    finally:
        engine.state.flag.clear()
    assert hook.fired == 1
    assert hook.result.images == warm_inter.images
    # the saved latch came back: the job stopped at the yield boundary
    assert engine.state.progress.interrupted
    assert engine.state.progress.sampling_step == 4


def test_hook_cleared_between_requests(engine):
    assert engine.preempt_hook is None


# -- the dispatcher with the gate on -----------------------------------------

BATCH_JOB = dict(steps=32, batch_size=5, seed=40, priority_class=BATCH,
                 tenant="batch-tenant")
INTERACTIVE_JOB = dict(steps=4, seed=41)


@pytest.fixture(scope="module")
def jax_batch_job(params):
    """The batch job on the JAX TINY engine, unpreempted."""
    jeng = JaxEngine(JTINY, params, chunk_size=4, state=JaxState())
    body = dict(prompt="a cow", width=32, height=32,
                sampler_name="Euler a", **BATCH_JOB)
    return jeng.generate_range(JaxPayload(**body), 0, None, "txt2img")


def test_preempted_batch_job_gives_its_own_bytes(engine, bucketer,
                                                 monkeypatch, jax_batch_job):
    monkeypatch.setenv("SDTPU_FLEET", "1")
    disp = ServingDispatcher(engine, bucketer=bucketer, window=0.0)
    yields = []
    gate_yield = disp.fleet.yield_device

    def spied(entry):
        yields.append(threading.current_thread().name)
        gate_yield(entry)

    monkeypatch.setattr(disp.fleet, "yield_device", spied)
    # batch 5 > the ladder's 4: the solo path, 8 chunk boundaries
    baseline = finish(*in_thread(disp.submit, tiny(**BATCH_JOB)))
    finish(*in_thread(disp.submit, tiny(**INTERACTIVE_JOB)))
    assert disp.fleet.preemption_count() == 0  # nobody waited

    job = in_thread(disp.submit, tiny(**BATCH_JOB))
    wait_for(lambda: disp.fleet.summary()["running_class"] == BATCH,
             "the batch job never took the device")
    inter = finish(*in_thread(disp.submit, tiny(**INTERACTIVE_JOB)))
    got = finish(*job)

    assert disp.fleet.preemption_count() >= 1
    assert yields and all(n == "engine-yield" for n in yields)
    assert got.images == baseline.images
    assert got.seeds == baseline.seeds
    assert len(inter.images) == 1
    assert engine.preempt_hook is None
    for a, b in zip(got.images, jax_batch_job.images):
        pa = b64png_to_array(a).astype(np.int32)
        pb = b64png_to_array(b).astype(np.int32)
        assert np.abs(pa - pb).max() <= 1


def test_fleet_off_builds_nothing_and_installs_no_hook(engine, bucketer,
                                                       monkeypatch):
    disp = ServingDispatcher(engine, bucketer=bucketer, window=0.0)
    assert disp.fleet is None and disp.quotas is None
    assert disp.admission is None and disp.fleet_summary() is None
    seen = []
    run_solo = engine.generate_range

    def spy(*a, **k):
        seen.append(engine.preempt_hook)
        return run_solo(*a, **k)

    monkeypatch.setattr(engine, "generate_range", spy)
    r = disp.submit(tiny(batch_size=5, seed=42, priority_class=BATCH))
    assert len(r.images) == 5 and seen == [None]
    assert engine.preempt_hook is None


def test_fleet_on_submit_and_summary(engine, bucketer, monkeypatch):
    monkeypatch.setenv("SDTPU_FLEET", "1")
    obs_prom.clear_histograms()
    disp = ServingDispatcher(engine, bucketer=bucketer, window=0.0)
    r = disp.submit(tiny(seed=30))
    assert len(r.images) == 1
    s = disp.fleet_summary()
    assert s["queue_depth"] == 0 and s["running_class"] is None
    assert s["quotas"]["enabled"] is False
    assert s["admission"]["calibrated"] is False
    # the dispatched request's wait went to its class's histogram
    assert obs_prom._FLEET_QUEUE_WAIT[INTERACTIVE].snapshot()[2] == 1


def test_quota_throttle_raises_429_material(engine, bucketer, monkeypatch):
    monkeypatch.setenv("SDTPU_FLEET", "1")
    # refills a token in 100 s: the first request's run cannot refill it
    monkeypatch.setenv("SDTPU_QUOTA_IPM", "0.6")
    monkeypatch.setenv("SDTPU_QUOTA_BURST", "1")
    disp = ServingDispatcher(engine, bucketer=bucketer, window=0.0)
    assert disp.submit(tiny(seed=31)).images
    METRICS.clear()
    with pytest.raises(FleetRejected) as exc:
        disp.submit(tiny(seed=32))
    assert exc.value.reason == "quota"
    assert exc.value.retry_after >= 1.0
    assert disp.fleet_summary()["quotas"]["throttled"] == 1
    assert METRICS.summary()["requests"] == 0


def test_slo_degrade_marks_result(engine, bucketer, monkeypatch):
    monkeypatch.setenv("SDTPU_FLEET", "1")
    METRICS.clear()  # no wait history: the wait floor is window / 2 = 0
    disp = ServingDispatcher(engine, bucketer=bucketer, window=0.0)
    disp.set_calibration(EtaCalibration(avg_ipm=6.0,
                                        eta_percent_error=[0.0]))
    # 20 steps at 32x32 predicts 10 * (32*32)/(512*512) = 0.0390625 s; an
    # SLO of 0.03 s fits at cadence 2 (x0.725 = 0.0283 s)
    r = disp.submit(tiny(steps=20, seed=33, slo_s=0.03))
    ov = r.parameters["override_settings"]
    assert ov["deepcache"] == 2
    assert "cadence 2" in ov["fleet_degraded"]
    assert len(r.images) == 1
    plain = ServingDispatcher(engine, bucketer=bucketer, window=0.0)
    assert r.images == plain.submit(tiny(
        steps=20, seed=33, override_settings={"deepcache": 2})).images


def test_slo_reject_feeds_no_metrics_and_refunds_quota(engine, bucketer,
                                                       monkeypatch):
    monkeypatch.setenv("SDTPU_FLEET", "1")
    monkeypatch.setenv("SDTPU_QUOTA_IPM", "60")
    monkeypatch.setenv("SDTPU_QUOTA_BURST", "1")
    METRICS.clear()
    obs_prom.clear_histograms()
    disp = ServingDispatcher(engine, bucketer=bucketer, window=0.0)
    disp.set_calibration(EtaCalibration(avg_ipm=6.0,
                                        eta_percent_error=[0.0]))
    with pytest.raises(FleetRejected) as exc:
        disp.submit(tiny(steps=20, seed=34, slo_s=0.001))
    assert exc.value.reason == "slo"
    s = METRICS.summary()
    assert s["requests"] == 0 and s["dispatches"] == 0
    assert METRICS.avg_queue_wait() == 0.0
    assert obs_prom.fleet_queue_wait_p95() == 0.0
    # the one-token bucket got its token back
    assert disp.submit(tiny(seed=37)).images


def test_cancelled_ticket_records_no_queue_wait(engine, bucketer,
                                                monkeypatch):
    monkeypatch.setenv("SDTPU_FLEET", "1")
    disp = ServingDispatcher(engine, bucketer=bucketer, window=0.0)
    METRICS.clear()
    obs_prom.clear_histograms()
    holder = disp.fleet.policy.resolve(INTERACTIVE)
    from stable_diffusion_webui_distributed_tpu_torch.fleet.policy import (
        GateEntry,
    )

    entry = GateEntry(holder)
    disp.fleet.acquire(entry)  # hold the device while the ticket queues
    rid = "cancel-me"
    job = in_thread(disp.submit, tiny(batch_size=5, seed=35,
                                      request_id=rid))
    try:
        wait_for(lambda: disp.cancel(rid), "the ticket never queued")
    finally:
        disp.fleet.release(entry)
    r = finish(*job)
    assert r.images == [] and r.parameters.get("cancelled") is True
    s = METRICS.summary()
    assert s["requests"] == 1 and s["dispatches"] == 0
    assert METRICS.avg_queue_wait() == 0.0
    assert obs_prom.fleet_queue_wait_p95() == 0.0


# -- the server ---------------------------------------------------------------

def call(port, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=THREAD_LIMIT) as r:
        return json.loads(r.read())


def test_server_answers_429_with_retry_after(engine, monkeypatch):
    monkeypatch.setenv("SDTPU_FLEET", "1")
    monkeypatch.setenv("SDTPU_QUOTA_IPM", "0.6")
    monkeypatch.setenv("SDTPU_QUOTA_BURST", "1")
    monkeypatch.setenv("SDTPU_BUCKET_LADDER", "32x32")
    srv = ApiServer(engine, port=0).start()
    try:
        body = dict(prompt="a cow", steps=2, width=32, height=32, seed=3,
                    tenant="t-quota")
        assert len(call(srv.port, "/sdapi/v1/txt2img", body)["images"]) == 1
        METRICS.clear()
        with pytest.raises(urllib.error.HTTPError) as exc:
            call(srv.port, "/sdapi/v1/txt2img", {**body, "seed": 4})
        assert exc.value.code == 429
        assert int(exc.value.headers["Retry-After"]) >= 1
        assert "quota" in json.loads(exc.value.read())["detail"]
        assert METRICS.summary()["dispatches"] == 0
    finally:
        srv.stop()


def test_autoscale_route(engine):
    slices.set_autoscale(None)
    srv = ApiServer(engine, port=0).start()
    try:
        assert call(srv.port, "/internal/autoscale") == {"active": False}
        reg = slices.SliceRegistry()
        reg.register(slices.SliceInfo("sd15/bf16", group="sd15/bf16"))
        auto = slices.AutoscaleEngine(reg, quantile_source=lambda: 9.0,
                                      up_p95_s=5.0, down_p95_s=0.5,
                                      cooldown_s=0.0)
        assert [d.direction for d in auto.decide()] == ["up"]
        audit = call(srv.port, "/internal/autoscale")
        assert audit["active"] is True and audit["decisions_total"] == 1
        entry = audit["decisions"][0]
        assert entry["direction"] == "up" and entry["replicas"] == 2
        assert entry["execution"] == {"outcome": "no_executor"}
    finally:
        srv.stop()
        slices.set_autoscale(None)
