"""The scenario matrix: steady, flash burst, chaos kill and a capacity
sweep, each replaying one recorded mix and scored.

Port of the JAX package's ``bench.py --scenarios`` runners
(``_scenario_mix``, ``_scenario_steady``, ``_scenario_burst``,
``_scenario_chaos``, ``_scenario_sweep``). Each runner takes the engine it
is given and never builds one: on the card the caller hands it the
serving engine, on the CPU a test's small one.

- :func:`record_mix`: ``n`` distinct requests through a dispatcher with
  the journal on; the journaled (payload, arrival) mix every scenario
  replays scaled.
- :func:`steady`: the mix resampled to 3x its size at 4x its rate through
  a fresh dispatcher.
- :func:`flash_burst`: twice the mix at 2x the rate, a burst of 4
  simultaneous arrivals at mid-run, two tenants and two classes, under
  the fleet gate (quantum 0, a 240 images/min quota with a burst of 8, an
  interactive SLO); per-(tenant, class) SLO attainment and burn come from
  the perf ledger.
- :func:`chaos_kill`: a two-worker World whose victim, a stub worker, is
  killed at request 1 by a chaos plan; the dead range requeues onto the
  survivor (a stub worker, or the caller's backend) and the scorer audits
  full recovery with no double-merged image.
- :func:`sweep`: one plan under the :data:`SWEEP_CONFIGS` candidates
  (coalesce window x batch ladder), ranked by :mod:`.sweep`.

Every dispatcher runner scores from the open-loop records, the journal
and ``obs.perf.LEDGER.summary()``; steady, flash burst and chaos kill
record their scorecards as the last run ``GET /internal/sim`` serves
(``sim.record_last_run``, as ``bench.py`` records them), the sweep's
candidates do not. The runners want ``SDTPU_JOURNAL=1`` and
``SDTPU_PERF=1`` (and ``SDTPU_SIM=1`` for the chaos plan); the caller sets
them, as ``bench.py --scenarios`` does. A runner given a ``capture`` dict
fills it with what the scorecard does not keep: each request's result by
request id (``results``), the open-loop ``records``, the journal
``events`` of its run and, for the dispatcher runners, the perf
``ledger`` it was scored from and the open loop's ``wall_s``.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from stable_diffusion_webui_distributed_tpu_torch import sim
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    journal as obs_journal,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    perf as obs_perf,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    ConfigModel,
    env_patch,
)
from stable_diffusion_webui_distributed_tpu_torch.scheduler import (
    worker as worker_mod,
)
from stable_diffusion_webui_distributed_tpu_torch.scheduler.world import (
    World,
)
from stable_diffusion_webui_distributed_tpu_torch.serving.bucketer import (
    ShapeBucketer,
)
from stable_diffusion_webui_distributed_tpu_torch.serving.dispatcher import (
    ServingDispatcher,
)
from stable_diffusion_webui_distributed_tpu_torch.sim import (
    chaos as sim_chaos,
)
from stable_diffusion_webui_distributed_tpu_torch.sim import (
    score as sim_score,
)
from stable_diffusion_webui_distributed_tpu_torch.sim import (
    sweep as sim_sweep,
)
from stable_diffusion_webui_distributed_tpu_torch.sim import (
    workload as sim_workload,
)

Mix = List[Tuple[Dict[str, Any], float]]

#: the capacity sweep's candidates: coalesce window x batch ladder
SWEEP_CONFIGS: Dict[str, Dict[str, Any]] = {
    "solo_b1": {"window": 0.0, "batches": [1]},
    "coalesce_b2": {"window": 0.02, "batches": [2]},
    "coalesce_b4": {"window": 0.05, "batches": [4]},
}


def _submitter(dispatcher, capture: Optional[Dict[str, Any]]
               ) -> Callable[[GenerationPayload], Any]:
    if capture is None:
        return dispatcher.submit
    results = capture.setdefault("results", {})

    def submit(payload: GenerationPayload):
        result = dispatcher.submit(payload)
        results[payload.request_id] = result
        return result

    return submit


def record_mix(dispatcher, size: int, steps: int, n: int = 4,
               capture: Optional[Dict[str, Any]] = None) -> Mix:
    """Record the scenario base mix: ``n`` distinct requests through
    ``dispatcher`` with the journal on. Returns the journaled (payload,
    arrival) mix every scenario replays scaled; it also warms the
    engine's graphs, so scenario latencies exclude capture time."""
    obs_journal.JOURNAL.clear()
    submit = _submitter(dispatcher, capture)
    for i in range(n):
        submit(GenerationPayload(
            prompt=f"scenario base mix {i}",
            negative_prompt="blurry, low quality",
            steps=steps, width=size, height=size, seed=400 + i,
            sampler_name="Euler a", request_id=f"record-{i:03d}"))
    snapshot = obs_journal.JOURNAL.snapshot()
    mix = sim_workload.base_mix(snapshot["events"])
    obs_journal.JOURNAL.clear()
    return mix


def _replay(engine, bucketer, window: float, plan,
            capture: Optional[Dict[str, Any]]) -> List[Dict[str, Any]]:
    dispatcher = ServingDispatcher(engine, bucketer=bucketer, window=window)
    t0 = time.perf_counter()
    records = sim_workload.emit_open_loop(plan,
                                          _submitter(dispatcher, capture))
    if capture is not None:
        capture["wall_s"] = time.perf_counter() - t0
    return records


def _scored(name: str, records, plan, slo_s_by_class,
            capture: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    events = obs_journal.JOURNAL.snapshot()["events"]
    ledger = obs_perf.LEDGER.summary()
    if capture is not None:
        capture.update(records=records, events=events, ledger=ledger)
    score = sim_score.score_run(
        records, events=events, ledger=ledger,
        slo_s_by_class=slo_s_by_class)
    score["plan_fingerprint"] = sim_workload.plan_fingerprint(plan)
    obs_journal.JOURNAL.clear()
    sim.record_last_run(name, score)
    return score


def steady(engine, bucketer, mix: Mix, seed: int, slo_s: float,
           capture: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Steady state: the recorded mix resampled to 3x its size at a
    steady 4x rate through a fresh dispatcher (window 0.02 s)."""
    spec = sim_workload.WorkloadSpec(seed=seed, count=3 * len(mix),
                                     rate_scale=4.0)
    plan = sim_workload.generate_plan(mix, spec)
    obs_perf.LEDGER.clear()
    records = _replay(engine, bucketer, 0.02, plan, capture)
    return _scored("steady", records, plan, {"interactive": slo_s},
                   capture)


def flash_burst(engine, bucketer, mix: Mix, seed: int, slo_s: float,
                capture: Optional[Dict[str, Any]] = None
                ) -> Dict[str, Any]:
    """Flash burst under the fleet gate: diverse tenants and classes with
    a simultaneous-arrival burst at mid-run."""
    spec = sim_workload.WorkloadSpec(
        seed=seed + 1, count=2 * len(mix), rate_scale=2.0,
        burst_size=4, burst_at=0.5,
        tenants=["alice", "batch-corp"],
        classes=["interactive", "batch"])
    plan = sim_workload.generate_plan(mix, spec)
    obs_perf.LEDGER.clear()
    with env_patch(SDTPU_FLEET="1", SDTPU_FLEET_QUANTUM_S="0",
                   SDTPU_QUOTA_IPM="240", SDTPU_QUOTA_BURST="8",
                   SDTPU_SLO_INTERACTIVE_S=str(slo_s)):
        records = _replay(engine, bucketer, 0.02, plan, capture)
    return _scored("flash_burst", records, plan,
                   {"interactive": slo_s, "batch": 4 * slo_s}, capture)


def _stub():
    return worker_mod.StubBackend(
        worker_mod.StubBehavior(seconds_per_image=0.001))


def chaos_kill(seed: int, survivor=None, size: int = 512, steps: int = 8,
               capture: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Chaos kill: a two-worker World, a scripted kill on the victim (a
    stub worker) at request 1. The kill lands in the failure path, the
    World requeues the dead range onto the survivor (``survivor``: its
    backend, a stub worker by default), and the scorer audits full
    recovery with no double-merged image from the journal and the
    delivered result. Needs ``SDTPU_SIM=1``."""
    obs_journal.JOURNAL.clear()
    w = World(ConfigModel())
    w.add_worker(worker_mod.WorkerNode(
        "survivor", survivor or _stub(), avg_ipm=2400.0))
    w.add_worker(worker_mod.WorkerNode("victim", _stub(), avg_ipm=2400.0))
    plan = sim_chaos.ChaosPlan(
        [sim_chaos.Fault(kind="kill", worker="victim", at_request=1)],
        seed=seed)
    sim_chaos.arm(plan)
    try:
        p = GenerationPayload(prompt="chaos kill", steps=steps, width=size,
                              height=size, batch_size=4, seed=77,
                              request_id="chaos-kill-000")
        t0 = time.perf_counter()
        result = w.execute(p)
        latency = time.perf_counter() - t0
    finally:
        sim_chaos.disarm()
    records = [{"request_id": "chaos-kill-000", "class": "interactive",
                "tenant": "default", "status": "completed",
                "expected": p.total_images,
                "images": len(result.images), "latency_s": latency}]
    events = obs_journal.JOURNAL.snapshot()["events"]
    if capture is not None:
        capture.setdefault("results", {})[p.request_id] = result
        capture.update(records=records, events=events)
    score = sim_score.score_run(records, events=events)
    score["chaos_plan"] = plan.status()
    obs_journal.JOURNAL.clear()
    sim.record_last_run("chaos_kill", score)
    return score


def sweep(engine, mix: Mix, seed: int, size: int, slo_s: float,
          capture: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Capacity sweep: one plan (twice the mix at 4x its rate) under each
    of :data:`SWEEP_CONFIGS`; ranked by worst-class SLO attainment, then
    p95, then compiles. ``capture`` gets one capture dict per candidate."""
    spec = sim_workload.WorkloadSpec(seed=seed + 2, count=2 * len(mix),
                                     rate_scale=4.0)
    plan = sim_workload.generate_plan(mix, spec)

    def runner(name: str, cfg: Dict[str, Any]) -> Dict[str, Any]:
        obs_perf.LEDGER.clear()
        bucketer = ShapeBucketer(shapes=[(size, size)],
                                 batches=list(cfg["batches"]))
        run_capture = None if capture is None else capture.setdefault(
            name, {})
        seq0 = max((e.get("seq", 0) for e in
                    obs_journal.JOURNAL.snapshot()["events"]), default=0)
        records = _replay(engine, bucketer, float(cfg["window"]), plan,
                          run_capture)
        ledger = obs_perf.LEDGER.summary()
        if run_capture is not None:
            run_capture.update(records=records, ledger=ledger, events=[
                e for e in obs_journal.JOURNAL.snapshot()["events"]
                if e.get("seq", 0) > seq0])
        return sim_score.score_run(
            records, ledger=ledger, slo_s_by_class={"interactive": slo_s})

    out = sim_sweep.run_sweep(SWEEP_CONFIGS, runner)
    out["plan_fingerprint"] = sim_workload.plan_fingerprint(plan)
    return out


def coalesced(events: List[Dict[str, Any]]) -> Dict[str, int]:
    """Request id -> the size of the group it was dispatched in, for every
    request that shared its dispatch (from the journal's ``dispatched``
    events)."""
    out: Dict[str, int] = {}
    for ev in events:
        if ev.get("event") == "dispatched":
            group = int((ev.get("attrs") or {}).get("group", 1))
            if group > 1:
                out[ev.get("request_id", "")] = group
    return out
