"""SLO scorer: one scenario run → one structured scorecard.

Port of the JAX package's ``sim/score.py``. Inputs are the three
artifacts a run leaves behind:

- **records**: per-request open-loop records from
  :func:`.workload.emit_open_loop` (class, tenant, status, latency,
  expected vs delivered image counts);
- **events**: the journal slice for the run (fault census, requeue and
  job-failure counts from the closed event vocabulary);
- **ledger**: ``obs.perf.LEDGER.summary()`` (per-tenant/class SLO
  attainment and burn, compile census, padding ratios) when the run was
  recorded under ``SDTPU_PERF=1``.

The scorecard is pure arithmetic over those inputs (unit-testable against
hand-built journals); :func:`ledger_metrics` flattens the gated subset into
one flat metrics dict, and the worst observed SLO burn is pushed to the
``sdtpu_sim_slo_burn`` gauge.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from stable_diffusion_webui_distributed_tpu_torch.obs import (
    prometheus as obs_prom,
)


def _percentile(samples: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile."""
    if not samples:
        return None
    xs = sorted(samples)
    idx = max(0, min(len(xs) - 1, int(round(q * (len(xs) - 1)))))
    return xs[idx]


def score_run(records: List[Dict[str, Any]],
              events: Optional[List[Dict[str, Any]]] = None,
              ledger: Optional[Dict[str, Any]] = None,
              slo_s_by_class: Optional[Dict[str, float]] = None,
              ) -> Dict[str, Any]:
    """Build the scorecard; every key is always present (None/empty when
    its input artifact is missing) so downstream schemas stay stable."""
    events = events or []
    slo_s_by_class = slo_s_by_class or {}

    classes: Dict[str, Dict[str, Any]] = {}
    expected_images = 0
    delivered_images = 0
    double_merged = 0
    for rec in records:
        cls = str(rec.get("class") or "interactive")
        row = classes.setdefault(cls, {
            "requests": 0, "completed": 0, "failed": 0, "throttled": 0,
            "latencies": [],
        })
        row["requests"] += 1
        status = rec.get("status", "")
        if status == "completed":
            row["completed"] += 1
            row["latencies"].append(float(rec.get("latency_s", 0.0)))
        elif status == "failed":
            row["failed"] += 1
        else:
            row["throttled"] += 1
        exp = int(rec.get("expected", 0))
        got = int(rec.get("images", 0))
        expected_images += exp
        delivered_images += min(got, exp)
        double_merged += max(0, got - exp)

    class_rows: Dict[str, Dict[str, Any]] = {}
    for cls, row in sorted(classes.items()):
        lats = row.pop("latencies")
        out = dict(row)
        out["p50_s"] = _percentile(lats, 0.50)
        out["p95_s"] = _percentile(lats, 0.95)
        slo = slo_s_by_class.get(cls)
        if slo is not None and lats:
            out["slo_attainment"] = (
                sum(1 for x in lats if x <= slo) / len(lats))
        else:
            out["slo_attainment"] = None
        class_rows[cls] = out

    faults: Dict[str, int] = {}
    requeues = 0
    job_failures = 0
    for ev in events:
        name = ev.get("event", "")
        if name == "fault_injected":
            kind = str((ev.get("attrs") or {}).get("kind", ""))
            faults[kind] = faults.get(kind, 0) + 1
        elif name == "requeued":
            requeues += 1
        elif name == "job_failed":
            job_failures += 1

    recovery = (delivered_images / expected_images
                if expected_images else 1.0)

    slo_rows: List[Dict[str, Any]] = []
    worst_burn: Optional[float] = None
    compiles = 0
    padding: Optional[float] = None
    if ledger:
        for row in ledger.get("slo", []):
            slo_rows.append({k: row.get(k) for k in
                             ("tenant", "class", "slo_s", "total", "met",
                              "attainment", "burn_rate")})
            burn = row.get("burn_rate")
            if burn is not None and (worst_burn is None
                                     or burn > worst_burn):
                worst_burn = float(burn)
        compiles = sum(int(c.get("count", 0))
                       for c in ledger.get("compiles", {}).values())
        groups = ledger.get("groups", [])
        disp = sum(int(g.get("dispatches", 0)) for g in groups)
        if disp:
            padding = sum(float(g.get("padding_ratio", 1.0))
                          * int(g.get("dispatches", 0))
                          for g in groups) / disp
    if worst_burn is not None:
        obs_prom.set_sim_slo_burn(worst_burn)

    return {
        "requests": len(records),
        "classes": class_rows,
        "faults": faults,
        "requeues": requeues,
        "job_failures": job_failures,
        "expected_images": expected_images,
        "delivered_images": delivered_images,
        "double_merged_images": double_merged,
        "requeue_recovery_rate": round(recovery, 6),
        "slo": slo_rows,
        "worst_slo_burn": worst_burn,
        "compiles": compiles,
        "avg_padding_ratio": padding,
    }


def alert_validation(phases: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Score detector behavior against labeled ground truth (the
    alert gate). Each phase is
    ``{"name", "expected": [rule, ...], "fired": [rule, ...]}``: a phase
    with no expected rules is steady traffic — every firing there is a
    false positive — and a phase with expected rules is an injected
    fault window, detected when any expected rule fired. Pure
    arithmetic, unit-testable against hand-built phase lists."""
    false_positives = 0
    fp_rules: List[str] = []
    fault_count = 0
    detected = 0
    rows: List[Dict[str, Any]] = []
    for ph in phases:
        fired = sorted(set(ph.get("fired") or []))
        expected = sorted(set(ph.get("expected") or []))
        row: Dict[str, Any] = {"name": str(ph.get("name", "")),
                               "expected": expected, "fired": fired}
        if not expected:
            row["false_positives"] = len(fired)
            false_positives += len(fired)
            fp_rules.extend(fired)
        else:
            fault_count += 1
            hit = bool(set(fired) & set(expected))
            row["detected"] = hit
            detected += 1 if hit else 0
        rows.append(row)
    return {
        "phases": rows,
        "alert_false_positives": false_positives,
        "false_positive_rules": sorted(set(fp_rules)),
        "faults": fault_count,
        "detected": detected,
        "alert_recall": (detected / fault_count) if fault_count else None,
    }


def ledger_metrics(score: Dict[str, Any]) -> Dict[str, Any]:
    """The flat, gated view of a scorecard."""
    p95s = [row["p95_s"] for row in score["classes"].values()
            if row.get("p95_s") is not None]
    attain = [row["slo_attainment"] for row in score["classes"].values()
              if row.get("slo_attainment") is not None]
    metrics: Dict[str, Any] = {
        "requests": score["requests"],
        "requeue_recovery_rate": score["requeue_recovery_rate"],
        "double_merged_images": score["double_merged_images"],
        "faults_injected": sum(score["faults"].values()),
        "requeues": score["requeues"],
    }
    if p95s:
        metrics["scenario_p95_s"] = max(p95s)
    if attain:
        metrics["slo_attainment"] = min(attain)
    if score.get("worst_slo_burn") is not None:
        metrics["slo_burn"] = score["worst_slo_burn"]
    if score.get("avg_padding_ratio") is not None:
        metrics["avg_padding_ratio"] = score["avg_padding_ratio"]
    if score.get("compiles"):
        metrics["compiles"] = score["compiles"]
    return metrics
