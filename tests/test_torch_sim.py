"""The port's scenario engine (``sim/workload``, ``score``, ``sweep``,
``scenarios``) and the ``sdtpu_sim_slo_burn`` gauge against the JAX
package's, on the CPU.

- plans: the same mix and ``WorkloadSpec`` (count, rate, diurnal, burst,
  shapes, precisions, tenants, classes) give the JAX plan: arrivals within
  1e-9, the same request ids, equal payload dumps and fingerprints;
- loading: ``load_events`` and ``base_mix`` over the same events from a
  dict, a list, a snapshot JSON file and a JSONL sink;
- open loop: ``emit_open_loop`` over a stub ``submit`` gives the JAX
  records for each status, ``FleetRejected.reason`` passed through;
- scoring: ``score_run``, ``alert_validation``, ``ledger_metrics``,
  ``rank`` and ``run_sweep`` on JAX ``tests/test_sim.py``'s inputs;
- exposition: the ``sdtpu_sim_slo_burn`` lines of both expositions, and
  ``clear_histograms()`` clears them;
- chaos kill: ``scenarios.chaos_kill`` on stub Worlds gives the scorecard
  of the JAX ``bench.py`` ``_scenario_chaos`` (latencies aside).

The dispatcher scenarios on a TINY engine are in
``tests/test_torch_scenarios.py``.
"""

import json
import os
import sys

import numpy as np
import pytest

from stable_diffusion_webui_distributed_tpu.fleet import (
    admission as jax_admission,
)
from stable_diffusion_webui_distributed_tpu.obs import journal as jax_journal
from stable_diffusion_webui_distributed_tpu.obs import (
    prometheus as jax_prom,
)
from stable_diffusion_webui_distributed_tpu.sim import score as jax_score
from stable_diffusion_webui_distributed_tpu.sim import sweep as jax_sweep
from stable_diffusion_webui_distributed_tpu.sim import (
    workload as jax_workload,
)
from stable_diffusion_webui_distributed_tpu_torch import sim
from stable_diffusion_webui_distributed_tpu_torch.fleet import admission
from stable_diffusion_webui_distributed_tpu_torch.obs import journal
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    prometheus as obs_prom,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
)
from stable_diffusion_webui_distributed_tpu_torch.sim import (
    scenarios,
    score,
    sweep,
    workload,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SPECS = {
    "plain": dict(seed=7, count=20, rate_scale=3.0),
    "diurnal_burst": dict(seed=7, count=20, rate_scale=3.0,
                          diurnal_amplitude=0.5, diurnal_period_s=5.0,
                          burst_size=5),
    "diversity": dict(seed=3, count=12, burst_size=4, burst_at=0.5,
                      shapes=[(64, 64), (64, 48)],
                      precisions=["bf16", "int8"],
                      tenants=["alice", "bob"],
                      classes=["interactive", "batch"]),
    "one_pass": dict(seed=1),
    "late_burst": dict(seed=9, count=6, rate_scale=0.5, burst_size=3,
                       burst_at=1.5),
}


def _plans(mix_port, mix_jax, kw):
    return (workload.generate_plan(mix_port, workload.WorkloadSpec(**kw)),
            jax_workload.generate_plan(mix_jax,
                                       jax_workload.WorkloadSpec(**kw)))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_plan_matches_jax(name):
    mix, jmix = workload.synthetic_mix(4), jax_workload.synthetic_mix(4)
    assert mix == jmix
    plan, jplan = _plans(mix, jmix, SPECS[name])
    assert len(plan) == len(jplan)
    assert [r.request_id for r in plan] == [r.request_id for r in jplan]
    assert [r.index for r in plan] == [r.index for r in jplan]
    np.testing.assert_allclose([r.arrival_s for r in plan],
                               [r.arrival_s for r in jplan],
                               rtol=0, atol=1e-9)
    for r, jr in zip(plan, jplan):
        dump, jdump = r.payload.model_dump(), jr.payload.model_dump()
        assert {k: dump[k] for k in jdump} == jdump
        assert r.dump() == jr.dump()
    assert workload.plan_fingerprint(plan) == \
        jax_workload.plan_fingerprint(jplan)


def test_plan_is_deterministic_and_seeded():
    mix = workload.synthetic_mix(4)
    kw = SPECS["diurnal_burst"]
    a, b = _plans(mix, mix, kw)[0], _plans(mix, mix, kw)[0]
    assert workload.plan_fingerprint(a) == workload.plan_fingerprint(b)
    other = workload.generate_plan(
        mix, workload.WorkloadSpec(**{**kw, "seed": 8}))
    assert workload.plan_fingerprint(a) != workload.plan_fingerprint(other)
    with pytest.raises(ValueError):
        workload.generate_plan([], workload.WorkloadSpec())


def _events():
    """A journal's events out of seq order: two requests with payloads
    (one on its ``planned`` event), one without, and an unrelated event."""
    dumps = [GenerationPayload(prompt=f"p{i}", seed=100 + i,
                               steps=4).model_dump() for i in range(3)]
    return [
        {"seq": 4, "t_mono": 12.5, "event": "completed", "request_id": "a",
         "attrs": {}},
        {"seq": 1, "t_mono": 10.0, "event": "received", "request_id": "a",
         "attrs": {"payload": dumps[0]}},
        {"seq": 2, "t_mono": 11.0, "event": "admitted", "request_id": "b",
         "attrs": {}},
        {"seq": 3, "t_mono": 11.5, "event": "planned", "request_id": "b",
         "attrs": {"payload": dumps[1]}},
        {"seq": 5, "t_mono": 13.0, "event": "received", "request_id": "c",
         "attrs": {"payload": "not a dict"}},
        {"seq": 6, "t_mono": 14.0, "event": "received", "request_id": "d",
         "attrs": {"payload": dumps[2]}},
    ]


@pytest.mark.parametrize("kind", ["dict", "list", "snapshot", "jsonl"])
def test_loading_matches_jax(kind, tmp_path):
    events = _events()
    if kind == "dict":
        source = {"events": events}
    elif kind == "list":
        source = events
    elif kind == "snapshot":
        source = str(tmp_path / "snap.json")
        with open(source, "w") as fh:
            json.dump({"enabled": True, "events": events}, fh)
    else:
        source = str(tmp_path / "sink.jsonl")
        with open(source, "w") as fh:
            fh.write("\n".join(json.dumps(e) for e in events) + "\n\n")
    loaded = workload.load_events(source)
    assert loaded == jax_workload.load_events(source)
    assert [e["seq"] for e in loaded] == [1, 2, 3, 4, 5, 6]
    mix = workload.base_mix(loaded)
    assert mix == jax_workload.base_mix(loaded)
    assert [(p["seed"], t) for p, t in mix] == [(100, 0.0), (101, 1.0),
                                                (102, 4.0)]
    assert workload.base_mix([]) == jax_workload.base_mix([]) == []


def test_mix_from_a_live_journal(monkeypatch):
    monkeypatch.setenv("SDTPU_JOURNAL", "1")
    j = journal.EventJournal(capacity=8)
    jj = jax_journal.EventJournal(capacity=8)
    dump = GenerationPayload(prompt="p", seed=42).model_dump()
    for jrn in (j, jj):
        jrn.emit("received", "r-1", payload=dump,
                 fingerprint=journal.fingerprint(dump))
        jrn.emit("completed", "r-1", seeds=[42])
    mix = workload.base_mix(workload.load_events(j.snapshot()))
    jmix = jax_workload.base_mix(jax_workload.load_events(jj.snapshot()))
    assert mix == jmix
    assert mix[0][0]["seed"] == 42 and mix[0][1] == 0.0


class _Result:
    def __init__(self, n):
        self.images = ["x"] * n


def _stub_submit(rejected):
    def submit(p):
        tag = p.prompt
        if tag == "quota":
            raise rejected("quota", "over quota", retry_after=2.0)
        if tag == "slo":
            raise rejected("slo", "would miss its SLO")
        if tag == "boom":
            raise RuntimeError("device lost")
        if tag == "double":
            return _Result(p.total_images + 1)
        return _Result(p.total_images)
    return submit


def test_open_loop_statuses_match_jax():
    tags = ["ok", "quota", "slo", "boom", "double"]
    mix = [({"prompt": t, "seed": i, "steps": 4, "batch_size": 2,
             "priority_class": "batch" if t == "slo" else "",
             "tenant": "alice"}, 0.001 * i) for i, t in enumerate(tags)]
    jmix = [(dict(p), t) for p, t in mix]
    spec = dict(seed=5, count=len(mix))
    plan, jplan = _plans(mix, jmix, spec)
    recs = workload.emit_open_loop(plan, _stub_submit(
        admission.FleetRejected), time_scale=0.0)
    jrecs = jax_workload.emit_open_loop(jplan, _stub_submit(
        jax_admission.FleetRejected), time_scale=0.0)
    for r in recs + jrecs:
        assert r.pop("latency_s") >= 0.0
    assert recs == jrecs
    by_tag = {plan[i].payload.prompt: r for i, r in enumerate(recs)}
    assert by_tag["ok"]["status"] == "completed"
    assert by_tag["ok"]["images"] == by_tag["ok"]["expected"] == 2
    assert by_tag["quota"]["status"] == "quota"
    assert by_tag["slo"]["status"] == "slo"
    assert by_tag["slo"]["class"] == "batch"
    assert by_tag["boom"]["status"] == "failed"
    assert by_tag["boom"]["error"] == "device lost"
    assert by_tag["double"]["images"] == 3
    assert all(r["tenant"] == "alice" for r in recs)


# -- scorer, sweep and the gauge (JAX tests/test_sim.py TestScorer) ----------

RECORDS = [
    {"class": "interactive", "status": "completed",
     "latency_s": 1.0, "expected": 1, "images": 1},
    {"class": "interactive", "status": "completed",
     "latency_s": 3.0, "expected": 1, "images": 1},
    {"class": "interactive", "status": "quota",
     "latency_s": 0.0, "expected": 1, "images": 0},
    {"class": "batch", "status": "completed",
     "latency_s": 5.0, "expected": 4, "images": 5},
    {"class": "batch", "status": "failed",
     "latency_s": 9.0, "expected": 4, "images": 0},
]
EVENTS = [
    {"event": "fault_injected", "attrs": {"kind": "kill"}},
    {"event": "fault_injected", "attrs": {"kind": "stall"}},
    {"event": "fault_cleared", "attrs": {"kind": "kill"}},
    {"event": "requeued", "attrs": {"worker": "survivor"}},
    {"event": "job_failed", "attrs": {}},
]
LEDGER = {
    "slo": [{"tenant": "alice", "class": "interactive",
             "slo_s": 10.0, "total": 4, "met": 3,
             "attainment": 0.75, "burn_rate": 5.0},
            {"tenant": "bob", "class": "batch",
             "slo_s": 40.0, "total": 2, "met": 2,
             "attainment": 1.0, "burn_rate": 0.0}],
    "compiles": {"chunk": {"count": 2}, "decode": {"count": 1}},
    "groups": [{"dispatches": 3, "padding_ratio": 1.0},
               {"dispatches": 1, "padding_ratio": 2.0}],
}
SCORE_CASES = {
    "full": dict(records=RECORDS, events=EVENTS, ledger=LEDGER,
                 slo_s_by_class={"interactive": 2.0}),
    "records_only": dict(records=RECORDS),
    "clean": dict(records=[{"class": "interactive", "status": "completed",
                            "latency_s": 0.5, "expected": 2,
                            "images": 2}]),
    "empty": dict(records=[]),
    "ledger_no_groups": dict(records=RECORDS[:2],
                             ledger={"slo": [], "compiles": {}},
                             slo_s_by_class={"interactive": 5.0}),
}


@pytest.fixture()
def gauges():
    obs_prom.clear_histograms()
    jax_prom.clear_histograms()
    yield
    obs_prom.clear_histograms()
    jax_prom.clear_histograms()


@pytest.mark.parametrize("case", sorted(SCORE_CASES))
def test_score_run_matches_jax(case, gauges):
    kw = SCORE_CASES[case]
    card = score.score_run(**kw)
    assert card == jax_score.score_run(**kw)
    assert score.ledger_metrics(card) == jax_score.ledger_metrics(card)
    assert obs_prom.sim_slo_burn() == jax_prom.sim_slo_burn()


def test_scorecard_math(gauges):
    card = score.score_run(**SCORE_CASES["full"])
    inter = card["classes"]["interactive"]
    assert inter["p50_s"] == 1.0 and inter["p95_s"] == 3.0
    assert inter["slo_attainment"] == 0.5
    assert card["classes"]["batch"]["slo_attainment"] is None
    assert card["faults"] == {"kill": 1, "stall": 1}
    assert card["expected_images"] == 11
    assert card["delivered_images"] == 6
    assert card["double_merged_images"] == 1
    assert card["worst_slo_burn"] == 5.0
    assert card["compiles"] == 3 and card["avg_padding_ratio"] == 1.25
    assert obs_prom.sim_slo_burn() == 5.0
    m = score.ledger_metrics(card)
    assert m["scenario_p95_s"] == 5.0 and m["slo_attainment"] == 0.5


def test_alert_validation_matches_jax():
    phases = [{"name": "steady", "expected": [], "fired": ["a", "a", "b"]},
              {"name": "kill", "expected": ["worker_down"],
               "fired": ["worker_down", "b"]},
              {"name": "stall", "expected": ["stall"], "fired": []},
              {"name": "quiet"}]
    out = score.alert_validation(phases)
    assert out == jax_score.alert_validation(phases)
    assert out["alert_false_positives"] == 2 and out["alert_recall"] == 0.5
    assert score.alert_validation([]) == jax_score.alert_validation([])


def _fake(att, p95, compiles):
    return {"classes": {"interactive": {"slo_attainment": att,
                                        "p50_s": p95, "p95_s": p95}},
            "compiles": compiles}


def test_rank_and_sweep_match_jax():
    rows = [{"name": "slow_but_meets", "score": _fake(1.0, 4.0, 9)},
            {"name": "fast_but_misses", "score": _fake(0.5, 1.0, 1)},
            {"name": "meets_faster", "score": _fake(1.0, 2.0, 5)},
            {"name": "no_target", "score": _fake(None, None, 0)}]
    out = sweep.rank(rows)
    assert out == jax_sweep.rank(rows)
    assert [r["name"] for r in out["ranked"]] == [
        "meets_faster", "slow_but_meets", "no_target", "fast_but_misses"]
    tied = [{"name": "many", "score": _fake(1.0, 2.0, 7)},
            {"name": "few", "score": _fake(1.0, 2.0, 2)}]
    assert sweep.rank(tied)["recommendation"] == "few"
    assert sweep.rank([]) == jax_sweep.rank([])
    configs = {"b": {"window": 0.1}, "a": {"window": 0.0}}
    scores = {"a": _fake(1.0, 3.0, 1), "b": _fake(1.0, 2.0, 1)}
    calls = []

    def runner(name, cfg):
        calls.append(name)
        return scores[name]

    out = sweep.run_sweep(configs, runner)
    assert out == jax_sweep.run_sweep(configs, lambda n, c: scores[n])
    assert calls == ["a", "b"] and out["recommendation"] == "b"


def _burn_lines(text):
    return [ln for ln in text.splitlines() if "sdtpu_sim_slo_burn" in ln]


def test_exposition_burn_matches_jax(gauges):
    assert _burn_lines(obs_prom.render()) == []
    for value in (5.0, 0.25):
        obs_prom.set_sim_slo_burn(value)
        jax_prom.set_sim_slo_burn(value)
        lines = _burn_lines(obs_prom.render())
        assert lines == _burn_lines(jax_prom.render())
        assert float(lines[-1].split()[1]) == value
    obs_prom.clear_histograms()
    assert obs_prom.sim_slo_burn() is None
    assert _burn_lines(obs_prom.render()) == []


# -- the scenarios -------------------------------------------------------------


@pytest.fixture()
def sim_env(monkeypatch):
    for k in ("SDTPU_SIM", "SDTPU_JOURNAL", "SDTPU_PERF"):
        monkeypatch.setenv(k, "1")
    journal.JOURNAL.clear()
    jax_journal.JOURNAL.clear()
    yield
    journal.JOURNAL.clear()
    jax_journal.JOURNAL.clear()
    sim.clear_last_run()


def _strip_latency(card):
    card = json.loads(json.dumps(card))
    for row in card["classes"].values():
        for key in ("p50_s", "p95_s"):
            assert row[key] is None or row[key] >= 0.0
            row[key] = None
    return card


def test_chaos_kill_scorecard_matches_jax(sim_env):
    sys.path.insert(0, ROOT)
    import bench

    card = scenarios.chaos_kill(0)
    jcard = bench._scenario_chaos(0)
    assert _strip_latency(card) == _strip_latency(jcard)
    assert card["requeue_recovery_rate"] == 1.0
    assert card["faults"] == {"kill": 1} and card["requeues"] >= 1
    assert card["double_merged_images"] == 0
    assert card["chaos_plan"]["faults"][0]["injected"] == 1
    assert sim.last_run()["name"] == "chaos_kill"
    assert sim.last_run()["score"]["requeues"] == card["requeues"]
