"""Capacity sweeper: one replayed mix, N configs, one ranked answer.

Port of the JAX package's ``sim/sweep.py``. Capacity choices are only
defensible when swept against a *fixed* workload. :func:`run_sweep`
drives the caller's runner (which applies one config: bucket ladder,
cadence policy, coalesce window, worker count; replays the same plan;
and returns a :mod:`.score` scorecard) once per candidate, then
:func:`rank` orders the results:

1. highest worst-class SLO attainment (requests meeting their deadline
   dominate everything else),
2. lowest worst-class p95 latency,
3. fewest compiles (executable-budget pressure as the tiebreak).

The ranked table plus the winner is what the caller reports.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List


def _rank_key(score: Dict[str, Any]):
    attain = [row["slo_attainment"] for row in score["classes"].values()
              if row.get("slo_attainment") is not None]
    p95s = [row["p95_s"] for row in score["classes"].values()
            if row.get("p95_s") is not None]
    worst_attain = min(attain) if attain else 1.0
    worst_p95 = max(p95s) if p95s else float("inf")
    return (-worst_attain, worst_p95, score.get("compiles", 0))


def rank(scored: List[Dict[str, Any]]) -> Dict[str, Any]:
    """``scored``: [{"name": ..., "config": ..., "score": ...}] → ranked
    table + recommendation. Pure; unit-testable."""
    ordered = sorted(scored, key=lambda row: _rank_key(row["score"]))
    table = []
    for pos, row in enumerate(ordered):
        key = _rank_key(row["score"])
        table.append({
            "rank": pos + 1,
            "name": row["name"],
            "config": row.get("config", {}),
            "worst_slo_attainment": -key[0],
            "worst_p95_s": None if key[1] == float("inf") else key[1],
            "compiles": key[2],
        })
    return {
        "ranked": table,
        "recommendation": table[0]["name"] if table else None,
    }


def run_sweep(configs: Dict[str, Dict[str, Any]],
              runner: Callable[[str, Dict[str, Any]], Dict[str, Any]],
              ) -> Dict[str, Any]:
    """Run ``runner(name, config) -> scorecard`` per candidate and rank.
    Configs are knob dicts the runner applies; candidates run
    sequentially so they never contend for the device."""
    scored = []
    for name in sorted(configs):
        score = runner(name, configs[name])
        scored.append({"name": name, "config": configs[name],
                       "score": score})
    out = rank(scored)
    out["runs"] = {row["name"]: row["score"] for row in scored}
    return out
