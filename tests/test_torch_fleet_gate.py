"""The port's fleet tier (``…_torch/fleet/``, ``obs/prometheus.py``, the
ETA's admission terms) against the JAX package's, on the CPU.

Each case gives the same inputs and the same fake clock
(``tests/test_fleet.py``'s ``FakeClock`` pattern) to the JAX module and
the port's, and compares what they decide exactly (predicted seconds to
1e-9): the weighted-fair queue's selection order under weights, fair
share, aging and a preempted runner's kept tag; the gate's yield verdicts
under the quantum; token buckets and the quota ledger; admission over
accept, each degrade rung, reject, an int8 request and learned factors;
``predict_eta`` and ``admission_eta`` with the queue wait, the padding
overhead and the MPE gauge's fallback; the autoscaler over one quantile
sequence with health and alert feeds, its cooldown and audit; the warm
pool's routing, kill, heal and retire with a stub factory.

Then the port's own: the engine's device runner (``runtime/runner.py``)
and the preempt hook's owner filter, which replaces the JAX hook's thread
filter (``test_fleet.py::TestGate::test_hook_is_thread_filtered``: work
that runs during a yield must not be answered; in the port it runs on the
owner's thread).
"""

import contextlib
import dataclasses
import threading
import time
from types import SimpleNamespace

import pytest

from stable_diffusion_webui_distributed_tpu.fleet import (
    admission as j_admission,
)
from stable_diffusion_webui_distributed_tpu.fleet import policy as j_policy
from stable_diffusion_webui_distributed_tpu.fleet import pool as j_pool
from stable_diffusion_webui_distributed_tpu.fleet import quotas as j_quotas
from stable_diffusion_webui_distributed_tpu.fleet import slices as j_slices
from stable_diffusion_webui_distributed_tpu.obs import prometheus as j_prom
from stable_diffusion_webui_distributed_tpu.pipeline.payload import (
    GenerationPayload as JaxPayload,
)
from stable_diffusion_webui_distributed_tpu.scheduler import eta as j_eta
from stable_diffusion_webui_distributed_tpu_torch import fleet as t_fleet
from stable_diffusion_webui_distributed_tpu_torch.fleet import (
    admission as t_admission,
)
from stable_diffusion_webui_distributed_tpu_torch.fleet import (
    policy as t_policy,
)
from stable_diffusion_webui_distributed_tpu_torch.fleet import pool as t_pool
from stable_diffusion_webui_distributed_tpu_torch.fleet import (
    quotas as t_quotas,
)
from stable_diffusion_webui_distributed_tpu_torch.fleet import (
    slices as t_slices,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    prometheus as t_prom,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.runner import (
    DeviceRunner,
)
from stable_diffusion_webui_distributed_tpu_torch.scheduler import (
    eta as t_eta,
)

PKGS = {
    "jax": SimpleNamespace(policy=j_policy, quotas=j_quotas,
                           admission=j_admission, slices=j_slices,
                           pool=j_pool, eta=j_eta, prom=j_prom,
                           Payload=JaxPayload),
    "torch": SimpleNamespace(policy=t_policy, quotas=t_quotas,
                             admission=t_admission, slices=t_slices,
                             pool=t_pool, eta=t_eta, prom=t_prom,
                             Payload=GenerationPayload),
}


class FakeClock:
    def __init__(self, now=0.0):
        self.now = now

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += dt


def both(fn):
    """``fn(pkg)`` for the JAX package and the port: (jax, torch)."""
    return fn(PKGS["jax"]), fn(PKGS["torch"])


def close(a, b, tol=1e-9):
    """Equal structures, floats within ``tol``."""
    if isinstance(a, float) or isinstance(b, float):
        return abs(float(a) - float(b)) <= tol
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(close(a[k], b[k], tol)
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(close(x, y, tol)
                                        for x, y in zip(a, b))
    return a == b


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for name in ("SDTPU_FLEET", "SDTPU_FLEET_CLASSES", "SDTPU_QUOTA_IPM",
                 "SDTPU_QUOTA_BURST", "SDTPU_SLO_INTERACTIVE_S",
                 "SDTPU_FLEET_FEWSTEP", "SDTPU_POOL", "SDTPU_POOL_SIZE",
                 "SDTPU_POOL_COOLDOWN_S", "SDTPU_ALERTS",
                 "SDTPU_FEDERATION", "SDTPU_AUTOSCALE_AUDIT"):
        monkeypatch.delenv(name, raising=False)
    for pkg in PKGS.values():
        pkg.prom.ETA_GAUGE.clear()
        pkg.prom.clear_histograms()
    yield
    for pkg in PKGS.values():
        pkg.prom.ETA_GAUGE.clear()
        pkg.prom.clear_histograms()


def test_exports_match_jax():
    from stable_diffusion_webui_distributed_tpu import fleet as j_fleet

    assert t_fleet.__all__ == j_fleet.__all__
    for name in ("REUSE_STEP_COST", "CADENCE_RUNGS", "DEFAULT_FEWSTEP"):
        assert getattr(t_admission, name) == getattr(j_admission, name)
    assert t_eta.PRECISION_PRIOR == j_eta.PRECISION_PRIOR
    assert t_prom.BUCKETS == j_prom.BUCKETS


# -- policy and the weighted-fair queue ---------------------------------------

@pytest.mark.parametrize("env", [
    {},
    {"SDTPU_FLEET_CLASSES": "interactive:16,batch:4,research:3",
     "SDTPU_SLO_INTERACTIVE_S": "12"},
    {"SDTPU_FLEET_CLASSES": "interactive:zero",
     "SDTPU_SLO_INTERACTIVE_S": "0", "SDTPU_FLEET_AGING_S": "3",
     "SDTPU_FLEET_QUANTUM_S": "0"},
])
def test_policy_from_env_matches_jax(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)

    def table(P):
        with pytest.warns(UserWarning) if "zero" in str(env) else \
                contextlib.nullcontext():
            pol = P.policy.FleetPolicy.from_env()
        return ({n: dataclasses.asdict(c) for n, c in pol.classes.items()},
                pol.aging_s, pol.quantum_s,
                [pol.resolve(x).name for x in ("", None, "batch",
                                               "no-such", "research")])

    a, b = both(table)
    assert a == b


@pytest.mark.parametrize("env,cfg", [
    (None, None), (None, True), ("0", True), ("1", None), ("1", False),
])
def test_fleet_enabled_matches_jax(monkeypatch, env, cfg):
    if env is not None:
        monkeypatch.setenv("SDTPU_FLEET", env)
    config = None if cfg is None else SimpleNamespace(fleet_enabled=cfg)
    a, b = both(lambda P: P.policy.fleet_enabled(config))
    assert a == b


# each step: ("push", label, class, tenant, cost) | ("advance", dt) |
# ("pop",) select+remove | ("repush", label) recost=False | ("peek",)
WFQ_SCENARIOS = {
    "weights": [("push", "best", "best_effort", "t", 1),
                ("push", "batch", "batch", "t", 1),
                ("push", "inter", "interactive", "t", 1),
                ("pop",), ("pop",), ("pop",), ("peek",)],
    "fair share": [("push", "a1", "batch", "a", 1),
                   ("push", "a2", "batch", "a", 1),
                   ("push", "b1", "batch", "b", 1),
                   ("push", "c1", "batch", "c", 3),
                   ("pop",), ("pop",), ("pop",), ("pop",)],
    "aging": [("push", "old", "best_effort", "t", 1), ("advance", 11.0),
              ("push", "new", "interactive", "t", 1), ("pop",),
              ("push", "b", "batch", "t", 2), ("advance", 4.0),
              ("pop",), ("pop",)],
    "preempted runner keeps its tag": [
        ("push", "run", "batch", "t", 4), ("pop",),
        ("push", "later", "batch", "other", 4),
        ("push", "inter", "interactive", "u", 1),
        ("repush", "run"), ("peek",), ("pop",), ("pop",), ("pop",)],
    "custom class": [("push", "r", "research", "t", 1),
                     ("push", "x", "unknown", "t", 1),
                     ("push", "b", "batch", "t", 1),
                     ("pop",), ("pop",), ("pop",)],
}


@pytest.mark.parametrize("name", sorted(WFQ_SCENARIOS))
def test_wfq_selection_order_matches_jax(name):
    def drive(P):
        clk = FakeClock()
        pol = P.policy.FleetPolicy(weights={"research": 4.0}, aging_s=10.0)
        q = P.policy.WeightedFairQueue(aging_s=10.0, clock=clk)
        entries, out = {}, []
        for step in WFQ_SCENARIOS[name]:
            if step[0] == "push":
                _, label, cls, tenant, cost = step
                entries[label] = P.policy.GateEntry(
                    pol.resolve(cls), tenant=tenant, cost=cost)
                q.push(entries[label])
            elif step[0] == "advance":
                clk.advance(step[1])
            elif step[0] == "repush":
                q.push(entries[step[1]], recost=False)
            else:
                e = q.select()
                label = next((k for k, v in entries.items() if v is e), None)
                out.append((label, None if e is None else e.tag,
                            q.depth_by_class()))
                if step[0] == "pop" and e is not None:
                    q.remove(e)
        return out

    a, b = both(drive)
    assert close(a, b)


def test_gate_yield_verdicts_match_jax():
    def drive(P):
        clk = FakeClock()
        pol = P.policy.FleetPolicy(aging_s=1e9, quantum_s=5.0)
        gate = P.policy.FleetGate(pol, clock=clk)
        batch = P.policy.GateEntry(pol.resolve("batch"), cost=1)
        gate.acquire(batch)
        out = [gate.should_yield(batch)]
        gate.queue.push(P.policy.GateEntry(pol.resolve("batch"), cost=1))
        out.append(gate.should_yield(batch))
        gate.queue.push(P.policy.GateEntry(pol.resolve("interactive")))
        out.append(gate.should_yield(batch))  # inside the quantum
        clk.advance(6.0)
        out.append(gate.should_yield(batch))
        summary = gate.summary()
        gate.release(batch)
        return out, summary

    a, b = both(drive)
    assert a == b
    assert a[0] == [False, False, False, True]


def test_gate_yield_runs_the_interloper_then_resumes():
    pol = t_policy.FleetPolicy(aging_s=1e9, quantum_s=0.0)
    gate = t_policy.FleetGate(pol)
    batch = t_policy.GateEntry(pol.resolve("batch"), cost=4)
    gate.acquire(batch)
    log = []

    def interactive():
        e = t_policy.GateEntry(pol.resolve("interactive"), cost=1)
        gate.acquire(e)
        log.append("interactive-ran")
        gate.release(e)

    t = threading.Thread(target=interactive, daemon=True)
    t.start()
    deadline = time.monotonic() + 30
    while not gate.should_yield(batch):
        assert time.monotonic() < deadline
        time.sleep(0.005)
    gate.yield_device(batch)  # returns once the interactive one released
    log.append("batch-resumed")
    t.join(timeout=30)
    assert not t.is_alive()
    gate.release(batch)
    assert log == ["interactive-ran", "batch-resumed"]
    assert gate.preemption_count() == 1


# -- quotas ---------------------------------------------------------------------

def test_token_bucket_matches_jax():
    def drive(P):
        clk = FakeClock()
        b = P.quotas.TokenBucket(rate=1.0, burst=2.0, clock=clk)
        out = [b.try_take(2), b.try_take(1), b.retry_after(1)]
        clk.advance(1.5)
        out += [b.try_take(1), b.available(), b.retry_after(3)]
        b.refund(5)
        out += [b.available()]
        z = P.quotas.TokenBucket(rate=0.0, burst=0.2, clock=clk)
        out += [z.burst, z.try_take(1), z.try_take(1), z.retry_after(1)]
        return out

    a, b = both(drive)
    assert close(a, b)


def test_quota_ledger_matches_jax():
    def drive(P):
        clk = FakeClock()
        led = P.quotas.QuotaLedger(images_per_minute=6.0, burst=2.0,
                                   clock=clk)
        out = [led.enabled, led.admit("a", 1), led.admit("a", 1),
               led.admit("a", 1), led.admit("b", 2)]
        clk.advance(4.0)
        out.append(led.admit("a", 1))
        led.refund("a", 1)
        out.append(led.admit("a", 1))
        led.refund("b", 100)
        out.append(led.summary())
        off = P.quotas.QuotaLedger(images_per_minute=0.0, clock=clk)
        off.refund("x", 5)
        out += [off.enabled, off.admit("x", 100), off.summary()]
        return out

    a, b = both(drive)
    assert close(a, b)


def test_quota_ledger_from_env_matches_jax(monkeypatch):
    monkeypatch.setenv("SDTPU_QUOTA_IPM", "120")
    monkeypatch.setenv("SDTPU_QUOTA_BURST", "3")
    a, b = both(lambda P: (P.quotas.QuotaLedger.from_env().rate,
                           P.quotas.QuotaLedger.from_env().burst))
    assert a == b == (2.0, 3.0)


# -- ETA and admission ---------------------------------------------------------

def payload(P, **kw):
    defaults = dict(prompt="a cow", steps=20, width=512, height=512, seed=7,
                    sampler_name="Euler a")
    defaults.update(kw)
    return P.Payload(**defaults)


ETA_CASES = {
    "plain": ({}, {}),
    "wait and padding": ({}, {"queue_wait": 2.5, "padding_overhead": 1.5}),
    "padding below 1": ({}, {"padding_overhead": 0.5, "queue_wait": -1.0}),
    "int8": ({}, {"precision": "int8", "queue_wait": 0.7}),
    "hires sampler batch": ({"enable_hr": True, "hr_scale": 1.5,
                             "sampler_name": "Heun", "batch_size": 3},
                            {"queue_wait": 0.3, "padding_overhead": 1.2}),
    "steps": ({"width": 640, "height": 384}, {"steps": 12}),
}


@pytest.mark.parametrize("name", sorted(ETA_CASES))
@pytest.mark.parametrize("history", [[], [12.0, -4.0]])
@pytest.mark.parametrize("gauge", [[], [(12.0, 10.0), (8.0, 10.0),
                                        (30.0, 10.0)]])
def test_eta_terms_match_jax(name, history, gauge):
    body, kw = ETA_CASES[name]

    def drive(P):
        for predicted, actual in gauge:
            P.prom.ETA_GAUGE.record(predicted, actual)
        cal = P.eta.EtaCalibration(avg_ipm=6.0,
                                   eta_percent_error=list(history))
        p = payload(P, **body)
        pred = P.eta.predict_eta(cal, p, **kw)
        adm = P.eta.admission_eta(cal, p, **{k: v for k, v in kw.items()})
        return pred, adm, P.prom.ETA_GAUGE.summary()

    a, b = both(drive)
    assert close(a, b)


def test_record_eta_error_feeds_the_gauge_like_jax():
    def drive(P):
        cal = P.eta.EtaCalibration(avg_ipm=6.0)
        P.eta.record_eta_error(cal, 12.0, 10.0)
        P.eta.record_eta_error(cal, 4.0, 2.0, precision="int8")
        P.eta.record_eta_error(cal, 100.0, 10.0)  # rejected, 900%
        return (cal.eta_percent_error, cal.precision_scale,
                P.prom.ETA_GAUGE.summary())

    a, b = both(drive)
    assert close(a, b)
    assert a[2]["samples"] == 1


ADMISSION_CASES = {
    # (slo, payload fields, overhead, learned int8 factor, MPE history)
    "accept": (15.0, {}, None, None, [0.0]),
    "cadence 2": (8.0, {}, None, None, [0.0]),
    "cadence 3 past an asked cadence 2": (
        7.0, {"override_settings": {"deepcache": 2}}, None, None, [0.0]),
    "few-step": (6.0, {}, None, None, [0.0]),
    "int8": (3.0, {}, None, None, [0.0]),
    "reject": (2.0, {}, None, None, [0.0]),
    "int8 request": (2.0, {"precision": "int8"}, None, None, [0.0]),
    "learned int8 below 1": (3.0, {}, None, 0.8, [0.0]),
    "learned int8 at 1": (3.0, {}, None, 1.0, [0.0]),
    "learned int8 above 1": (3.0, {}, None, 1.3, [0.0]),
    "queue wait": (12.0, {}, {"queue_wait": 5.0}, None, [0.0]),
    "padding": (9.0, {"width": 480}, {"queue_wait": 0.2,
                                      "padding_overhead": 1.4}, None,
                [10.0]),
    "few steps already": (4.0, {"steps": 10}, None, None, [0.0]),
    "no SLO": (None, {}, None, None, [0.0]),
    "gauge fallback": (8.0, {}, None, None, []),
}


@pytest.mark.parametrize("name", sorted(ADMISSION_CASES))
def test_admission_decide_matches_jax(name):
    slo, body, overhead, int8, history = ADMISSION_CASES[name]

    def drive(P):
        P.prom.ETA_GAUGE.record(11.0, 10.0)
        cal = P.eta.EtaCalibration(avg_ipm=6.0,
                                   eta_percent_error=list(history))
        if int8 is not None:
            cal.precision_scale["int8"] = int8
        ctl = P.admission.AdmissionController(calibration=cal, fewstep=12)
        pol = P.policy.FleetPolicy(slo_interactive_s=slo or 0.0)
        d = ctl.decide(payload(P, **body), pol.resolve("interactive"),
                       overhead)
        return dataclasses.asdict(d)

    a, b = both(drive)
    assert close(a, b)


def test_admission_without_calibration_or_slo_matches_jax(monkeypatch):
    monkeypatch.setenv("SDTPU_FLEET_FEWSTEP", "8")

    def drive(P):
        pol = P.policy.FleetPolicy(slo_interactive_s=1.0)
        out = [P.admission.AdmissionController().fewstep]
        for cal in (None, P.eta.EtaCalibration()):
            d = P.admission.AdmissionController(calibration=cal).decide(
                payload(P), pol.resolve("interactive"))
            out.append(dataclasses.asdict(d))
        d = P.admission.AdmissionController(
            calibration=P.eta.EtaCalibration(avg_ipm=6.0)).decide(
                payload(P), pol.resolve("batch"))
        out.append(dataclasses.asdict(d))
        e = P.admission.FleetRejected("slo", "x", retry_after=0.01)
        out.append((e.reason, e.detail, e.retry_after))
        out.append([P.admission.cadence_speedup(c) for c in (0, 1, 2, 3, 6)])
        return out

    a, b = both(drive)
    assert close(a, b)


# -- the autoscaler ------------------------------------------------------------

AUTOSCALE_STEPS = [
    # (advance s, p95, unhealthy worker?, firing alerts)
    (0.0, 10.0, False, []), (1.0, 10.0, False, []),
    (61.0, 10.0, False, []), (61.0, 0.1, True, []),
    (61.0, 0.1, False, []), (61.0, 2.0, False, ["slo_burn"]),
    (1.0, 0.1, False, []), (61.0, 0.1, False, []),
    (61.0, 0.1, False, []),
]


def test_autoscale_decisions_and_audit_match_jax(monkeypatch):
    monkeypatch.setenv("SDTPU_AUTOSCALE_AUDIT", "4")

    def drive(P):
        clk = FakeClock()
        reg = P.slices.SliceRegistry()
        reg.register(P.slices.SliceInfo("s0", group="sd15/bf16",
                                        max_replicas=3))
        reg.register(P.slices.SliceInfo("s1", group="sdxl/bf16",
                                        replicas=2, min_replicas=1,
                                        max_replicas=2))
        state = {}
        health = {"w": {"consecutive_failures": 0}}
        eng = P.slices.AutoscaleEngine(
            reg, quantile_source=lambda: state["p95"], up_p95_s=5.0,
            down_p95_s=0.5, cooldown_s=60.0, clock=clk,
            health_source=lambda: health,
            alert_source=lambda: state["alerts"])
        seen = []
        eng.add_hook(seen.append)
        out = []
        for dt, p95, sick, alerts in AUTOSCALE_STEPS:
            clk.advance(dt)
            state.update(p95=p95, alerts=alerts)
            health["w"]["consecutive_failures"] = 3 if sick else 0
            out.append([dataclasses.asdict(d) for d in eng.decide()])
            out.append(eng.unhealthy_workers())
        eng.record_execution(seen[-1], "executed", "spawned resident-9")
        audit = eng.audit()
        for entry in audit["decisions"]:
            entry.pop("decided_at")
            entry["execution"].pop("executed_at", None)
        return out, audit, eng.summary(), reg.for_group("sd15/bf16")

    a, b = both(drive)
    assert close(a[0], b[0]) and close(a[1], b[1]) and close(a[2], b[2])
    assert [dataclasses.asdict(s) for s in a[3]] == \
        [dataclasses.asdict(s) for s in b[3]]


def test_autoscale_default_feeds(monkeypatch):
    t_prom.fleet_observe_queue_wait("batch", 8.0)
    j_prom.fleet_observe_queue_wait("batch", 8.0)
    a, b = both(lambda P: (P.prom.fleet_queue_wait_p95(),
                           P.prom.fleet_queue_wait_p95("batch"),
                           P.prom.fleet_queue_wait_p95("none"),
                           P.slices._default_quantile_source(),
                           P.slices._default_alert_source()))
    assert a == b and a[0] == 10.0
    eng = t_slices.AutoscaleEngine(t_slices.SliceRegistry(), cooldown_s=0)
    assert eng.quantile_source() == 10.0 and eng.firing_alerts() == []
    assert t_slices.get_autoscale() is eng
    # with either telemetry gate on, the feeds read what the JAX
    # package's read (no federated p95 recorded, no alert firing)
    for gate in ("SDTPU_ALERTS", "SDTPU_FEDERATION"):
        monkeypatch.setenv(gate, "1")
        a, b = both(lambda P: (P.slices._default_quantile_source(),
                               P.slices._default_alert_source()))
        assert a == b == (10.0, [])
        eng = t_slices.AutoscaleEngine(t_slices.SliceRegistry(),
                                       cooldown_s=0)
        assert eng.quantile_source() == 10.0 and eng.firing_alerts() == []
        monkeypatch.delenv(gate)
    t_slices.set_autoscale(None)
    j_slices.set_autoscale(None)


# -- the warm pool -------------------------------------------------------------

class StubEngine:
    def __init__(self, name, log):
        self.name = name
        self.log = log

    def close(self):
        self.log.append(("closed", self.name))


def test_pool_routing_kill_heal_retire_match_jax(monkeypatch):
    monkeypatch.setenv("SDTPU_POOL", "1")
    monkeypatch.setenv("SDTPU_POOL_COOLDOWN_S", "30")

    def drive(P):
        clk = FakeClock()
        log = []

        def factory(name):
            clk.advance(1.5)
            log.append(("built", name))
            return StubEngine(name, log)

        pool = P.pool.WarmPool(factory, size=2,
                               warm=lambda e: log.append(("warmed", e.name)),
                               clock=clk)
        out = [P.pool.enabled(), pool.size, pool.cooldown_s]
        out.append(pool.acquire().name)  # empty pool: spawns one
        r2 = pool.spawn()
        held = [pool.acquire(), pool.acquire(), pool.acquire()]
        out.append([r.name for r in held])
        pool.release(held[0])
        out.append(pool.acquire().name)
        out += [pool.kill("resident-1"), pool.kill("resident-1"),
                pool.kill("nope")]
        out.append(pool.heal())
        out.append(pool.retire_one())
        out.append(pool.retire_one())
        for r in held[1:]:
            pool.release(r)
        out.append(pool.summary())
        out.append(pool.retire_one())
        out.append(pool.summary())
        out.append(r2.name)
        return out, [e for e in log if e[0] != "closed"]

    a, b = both(drive)
    # spawned_at is wall-clock: everything else must agree
    assert close(a, b)


def test_pool_autoscale_executor_matches_jax(monkeypatch):
    monkeypatch.setenv("SDTPU_POOL_COOLDOWN_S", "30")

    def drive(P):
        clk = FakeClock()
        pool = P.pool.WarmPool(lambda n: StubEngine(n, []), size=1,
                               clock=clk)
        reg = P.slices.SliceRegistry()
        reg.register(P.slices.SliceInfo("s0", max_replicas=4))
        p95 = [9.0]
        eng = P.slices.AutoscaleEngine(
            reg, quantile_source=lambda: p95[0], up_p95_s=5.0,
            down_p95_s=0.5, cooldown_s=0.0, clock=clk,
            alert_source=lambda: [])
        pool.attach_autoscale(eng)
        out = []
        for dt, p in ((0.0, 9.0), (31.0, 9.0), (1.0, 0.1), (31.0, 0.1),
                      (31.0, 0.1), (31.0, 0.1)):
            clk.advance(dt)
            p95[0] = p
            eng.decide()
            out.append(pool.summary()["ready"])
        audit = eng.audit()["decisions"]
        return out, [(e["direction"], e["execution"]["outcome"],
                      e["execution"].get("detail")) for e in audit]

    a, b = both(drive)
    assert a == b
    assert ("down", "executed", "retired resident-1") in a[1]


def test_retired_resident_is_closed_once_drained():
    log = []
    pool = t_pool.WarmPool(lambda n: StubEngine(n, log), size=2)
    pool.heal()
    r1 = pool.acquire()  # resident-1, the least loaded
    assert pool.retire_one() == "resident-2"  # idle: closed at once
    assert log == [("closed", "resident-2")]
    pool.spawn()
    r3 = pool.acquire()  # resident-3
    assert pool.retire_one() == "resident-1"  # busy: drains first
    assert log == [("closed", "resident-2")] and r1.engine is not None
    pool.release(r1)
    assert log[-1] == ("closed", "resident-1") and r1.engine is None
    assert pool.retire_one() is None  # the last ready one stays
    pool.release(r3)
    assert [r["name"] for r in pool.summary()["residents"]] == ["resident-3"]


# -- the engine's device runner and the hook's owner -------------------------

def test_runner_runs_inline_on_its_thread_and_numbers_executions():
    runner = DeviceRunner("test-runner")
    seen = []

    def inner():
        seen.append(("inner", runner.current(),
                     threading.current_thread().name))

    def outer():
        seen.append(("outer", runner.current(),
                     threading.current_thread().name))
        runner.run(inner)  # would deadlock if it queued
        seen.append(("outer again", runner.current(), None))
        return "done"

    assert runner.run(outer) == "done"
    assert runner.current() is None  # off the thread
    assert seen == [("outer", 1, "test-runner"), ("inner", 2, "test-runner"),
                    ("outer again", 1, None)]
    with pytest.raises(ZeroDivisionError):
        runner.run(lambda: 1 / 0)
    runner.close()
    with pytest.raises(RuntimeError):
        runner.run(lambda: None)


def test_runner_serves_queued_work_while_a_yield_waits():
    runner = DeviceRunner("test-runner")
    release = threading.Event()
    log = []

    def other_thread():
        log.append(runner.run(lambda: ("nested", runner.current(),
                                       runner.yielding)))
        release.set()

    def job():
        threading.Thread(target=other_thread, daemon=True).start()
        got = runner.serve_while(lambda: release.wait(30) and "back")
        log.append((got, runner.current(), runner.yielding))
        return "finished"

    box = {}
    t = threading.Thread(target=lambda: box.update(r=runner.run(job)),
                         daemon=True)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive(), "the yield never ended: deadlock"
    assert box["r"] == "finished"
    assert log == [("nested", 2, 1), ("back", 1, 0)]
    runner.close()


def test_hook_answers_only_its_owning_execution():
    # the intent of test_fleet.py::TestGate::test_hook_is_thread_filtered:
    # work running during a yield sees the same engine attribute and must
    # not be answered. In the port that work runs on the owner's thread,
    # so the hook filters by execution, not by thread.
    pol = t_policy.FleetPolicy(aging_s=1e9, quantum_s=0.0)
    gate = t_policy.FleetGate(pol)
    batch = t_policy.GateEntry(pol.resolve("batch"), cost=1)
    gate.acquire(batch)
    gate.queue.push(t_policy.GateEntry(pol.resolve("interactive"), cost=1))
    runner = DeviceRunner("test-runner")
    hook = t_policy.EnginePreemptHook(gate, batch, runner)
    seen = {}

    def nested():
        seen["nested"] = hook.should_yield()
        hook.yield_device()  # a no-op for a non-owner

    def owner():
        seen["owner"] = hook.should_yield()
        runner.run(nested)
        seen["owner again"] = hook.should_yield()
        runner.yielding += 1  # as while a yield is served below
        seen["owner above a yield"] = hook.should_yield()
        runner.yielding -= 1

    runner.run(owner)
    seen["off the thread"] = hook.should_yield()
    assert seen == {"owner": True, "nested": False, "owner again": True,
                    "owner above a yield": False, "off the thread": False}
    assert gate.preemption_count() == 0
    gate.release(batch)
    runner.close()


def test_preempted_job_on_a_runner_resumes_after_the_interloper():
    # the whole protocol on host callables: the owner's loop yields at a
    # boundary, an interactive caller's task runs nested on the same
    # thread while the gate is held by it, and the owner resumes
    pol = t_policy.FleetPolicy(aging_s=1e9, quantum_s=0.0)
    gate = t_policy.FleetGate(pol)
    runner = DeviceRunner("test-runner")
    batch = t_policy.GateEntry(pol.resolve("batch"), cost=4)
    gate.acquire(batch)
    hook = t_policy.EnginePreemptHook(gate, batch, runner)
    log = []

    def interactive():
        e = t_policy.GateEntry(pol.resolve("interactive"), cost=1)
        gate.acquire(e)
        try:
            runner.run(lambda: log.append(("interloper", runner.current())))
        finally:
            gate.release(e)

    def loop():
        for step in range(200):
            if hook.should_yield():
                hook.yield_device()
                log.append(("resumed", runner.current(), step))
                return
            if step == 0:
                threading.Thread(target=interactive, daemon=True).start()
            time.sleep(0.01)

    t = threading.Thread(target=lambda: runner.run(loop), daemon=True)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive(), "the preemption never ended: deadlock"
    gate.release(batch)
    assert [e[0] for e in log] == ["interloper", "resumed"]
    assert log[0][1] == 2 and log[1][1] == 1
    assert gate.preemption_count() == 1
    runner.close()


def test_runner_thread_is_a_stoppable_daemon_that_close_ends():
    # the device thread loops on runtime/daemon.py (the lint's TH001): a
    # close ends it once the queued tasks have run
    runner = DeviceRunner("test-runner")
    seen = []
    runner.run(lambda: seen.append(runner.on_thread()))
    assert seen == [True] and not runner.on_thread()
    assert runner._daemon.alive()
    runner.close()
    deadline = time.monotonic() + 5.0
    while runner._daemon.alive() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not runner._daemon.alive()
    with pytest.raises(RuntimeError, match="closed"):
        runner.run(lambda: None)

