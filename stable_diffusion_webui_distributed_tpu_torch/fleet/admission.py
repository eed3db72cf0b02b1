"""ETA-SLO admission control: accept, degrade, or reject at the door.

Before a request is ever bucketed or queued, its completion time is
predicted with the benchmark-calibrated ETA model (scheduler/eta.py) plus
the serving layer's observed queue wait and padding overhead
(``ServingDispatcher.eta_overhead``), corrected by the live process-wide
MPE gauge (``sdtpu_eta_mpe_percent``). A prediction inside the class SLO
is admitted untouched. One that misses is *degraded* first — the
step-cache cadence ladder and a few-step budget are auto-applied, the
same knobs a user could set by hand (pipeline/stepcache.py) — and only
rejected with 429 when no degrade rung fits either.

Degrade cost model: a cached (reuse) step prices at ~45% of a full UNet
eval on the JAX package's XLA cost-analysis grid, so cadence ``c`` scales
the compute part of the ETA by ``1/c + (1 - 1/c) * 0.45``. Queue wait is
latency, not compute — it is never rescaled.

Port of the JAX package's ``fleet/admission.py``. The constants
(:data:`REUSE_STEP_COST`, :data:`CADENCE_RUNGS`, :data:`DEFAULT_FEWSTEP`)
and the int8 rung's prior (``scheduler/eta.py`` ``PRECISION_PRIOR``) are
the JAX package's, kept so that both packages decide alike on the same
calibration. They are not the card's ratios: PERF.md records those beside
them. On the card int8 is slower than bf16, so its learned factor
(``EtaCalibration.precision_scale``) climbs to 1 or more after a sample
or two, and from then on the int8 rung is not offered.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from stable_diffusion_webui_distributed_tpu_torch.fleet.policy import (
    ClassPolicy,
)

#: relative cost of a deep-feature-reuse step vs a full eval: the JAX
#: package's rows-proportional pricing (see the module's docstring)
REUSE_STEP_COST = 0.45
#: degrade rungs tried in order: step-cache cadence, then cadence + the
#: few-step budget (SDTPU_FLEET_FEWSTEP)
CADENCE_RUNGS = (2, 3)
DEFAULT_FEWSTEP = 12


class FleetRejected(Exception):
    """Raised by the dispatcher when admission control refuses a request;
    the API layer maps it to HTTP 429 + Retry-After."""

    def __init__(self, reason: str, detail: str,
                 retry_after: float = 1.0) -> None:
        super().__init__(detail)
        self.reason = reason        # "slo" | "quota"
        self.detail = detail
        self.retry_after = max(1.0, float(retry_after))


@dataclasses.dataclass
class AdmissionDecision:
    action: str                      # "accept" | "degrade" | "reject"
    predicted_s: Optional[float] = None
    slo_s: Optional[float] = None
    #: payload mutations applied on degrade (override_settings additions
    #: and/or a reduced step count)
    overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)
    steps: Optional[int] = None
    detail: str = ""


def cadence_speedup(cadence: int) -> float:
    """Compute-time multiplier for step-cache cadence ``c`` (< 1)."""
    c = max(1, int(cadence))
    return 1.0 / c + (1.0 - 1.0 / c) * REUSE_STEP_COST


class AdmissionController:
    """Per-dispatcher admission policy. Stateless between calls except for
    the calibration handle — safe to share across handler threads."""

    def __init__(self, calibration=None, benchmark=None,
                 fewstep: Optional[int] = None) -> None:
        from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
            env_int,
        )

        self.calibration = calibration  # scheduler.eta.EtaCalibration
        self.benchmark = benchmark
        self.fewstep = env_int("SDTPU_FLEET_FEWSTEP", DEFAULT_FEWSTEP) \
            if fewstep is None else fewstep

    def decide(self, payload, policy: ClassPolicy,
               overhead: Optional[Dict[str, float]] = None,
               int8: bool = True) -> AdmissionDecision:
        """Admission verdict for ``payload`` under ``policy``'s SLO. The
        caller applies ``overrides``/``steps`` on degrade and raises
        :class:`FleetRejected` on reject. ``int8``: whether the engine
        runs the payload at int8 (an engine on a ``tp > 1`` mesh does
        not); without it the int8 rung is never offered."""
        from stable_diffusion_webui_distributed_tpu_torch.scheduler import eta

        slo = policy.slo_s
        cal = self.calibration
        if slo is None or cal is None or not cal.benchmarked:
            # no SLO, or no calibration evidence yet: admission cannot
            # reason about time — let the request through untouched
            return AdmissionDecision("accept", slo_s=slo)

        overhead = overhead or {}
        wait = float(overhead.get("queue_wait", 0.0))
        pad = float(overhead.get("padding_overhead", 1.0))

        # a request that already asks for a reduced precision is predicted
        # at that precision's speed (payload channel; pipeline/precision.py)
        from stable_diffusion_webui_distributed_tpu_torch.pipeline import (
            precision as precision_mod,
        )

        requested_prec = precision_mod.resolve(payload).name

        def predict(steps: Optional[int] = None) -> float:
            return eta.admission_eta(
                cal, payload, benchmark=self.benchmark, steps=steps,
                queue_wait=wait, padding_overhead=pad,
                precision=requested_prec)

        predicted = predict()
        if predicted <= slo:
            return AdmissionDecision("accept", predicted, slo)

        # degrade ladder: compute part scales, queue wait does not
        compute = max(0.0, predicted - wait)
        existing_cadence = int(
            (payload.override_settings or {}).get("deepcache", 1) or 1)
        for cadence in CADENCE_RUNGS:
            if cadence <= existing_cadence:
                continue
            scaled = compute * cadence_speedup(cadence) + wait
            if scaled <= slo:
                return AdmissionDecision(
                    "degrade", scaled, slo,
                    overrides={"deepcache": cadence},
                    detail=f"step-cache cadence {cadence} applied to meet "
                           f"{slo:.1f}s SLO")
        # next rung: deepest cadence + the few-step budget
        cadence = CADENCE_RUNGS[-1]
        few = self.fewstep
        if few and 0 < few < payload.steps:
            scaled = max(0.0, predict(steps=few) - wait) \
                * cadence_speedup(cadence) + wait
            if scaled <= slo:
                return AdmissionDecision(
                    "degrade", scaled, slo,
                    overrides={"deepcache": cadence}, steps=few,
                    detail=f"few-step budget {few} + cadence {cadence} "
                           f"applied to meet {slo:.1f}s SLO")

        # final rung before reject: the int8 serving precision stacked on
        # cadence + few-step (pipeline/precision.py). The compute part
        # scales by the calibration's per-precision factor (learned from
        # int8's OWN samples, prior ~0.55); a request already asking for
        # a non-bf16 precision has nothing left to give here. Quality
        # stays inside the tier-1 PSNR/SSIM floors (test_quality_int8).
        int8_factor = cal.precision_factor("int8")
        if int8 and requested_prec == "bf16" and int8_factor < 1.0:
            steps_arg = few if few and 0 < few < payload.steps else None
            scaled = max(0.0, predict(steps=steps_arg) - wait) \
                * cadence_speedup(cadence) * int8_factor + wait
            if scaled <= slo:
                overrides = {"deepcache": cadence, "precision": "int8"}
                return AdmissionDecision(
                    "degrade", scaled, slo,
                    overrides=overrides, steps=steps_arg,
                    detail=f"int8 precision + cadence {cadence}"
                           + (f" + few-step budget {steps_arg}"
                              if steps_arg else "")
                           + f" applied to meet {slo:.1f}s SLO")

        return AdmissionDecision(
            "reject", predicted, slo,
            detail=f"predicted {predicted:.1f}s exceeds the "
                   f"{policy.name} SLO of {slo:.1f}s at every degrade rung")
