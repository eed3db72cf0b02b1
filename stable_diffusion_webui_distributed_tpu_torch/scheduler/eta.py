"""ETA prediction: benchmark-calibrated completion-time estimates.

A copy of the JAX package's ``scheduler/eta.py``: pure functions over a
small calibration record, the reference's formula (its ``Worker`` class)::

    eta = (n / ipm) * 60                      # base from benchmark ipm
        * (steps / benchmark_steps)           # step scaling
        * (pixels / benchmark_pixels)         # resolution scaling
        +- sampler_speed_percent              # sampler table below
        + hires pseudo-pass eta               # two-pass estimate
        - eta * mpe/100                       # mean-percent-error feedback

The MPE window keeps the last 5 measurements and rejects samples with
|error| >= 500%, so one network hiccup cannot poison the calibration.

A request's serving precision (``pipeline/precision.py``) scales the
compute part by a per-precision factor: the learned one when that
precision has samples, else :data:`PRECISION_PRIOR`. An int8 sample
refines only its own factor and never enters the bf16 MPE window.

Left out of the port, each with the part of the system it belongs to:

- ``admission_eta`` and the dispatcher's ``queue_wait`` and
  ``padding_overhead`` terms: they serve the fleet tier's SLO admission
  (``fleet/admission.py``), which is not ported;
- the process-wide MPE gauge a sample is mirrored into (observability,
  ROADMAP item 20).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    BenchmarkPayload,
)

#: Relative speed of each sampler vs "Euler a", in percent; positive =
#: faster. The reference's measured table; it feeds scheduling only.
SAMPLER_SPEED_VS_EULER_A = {
    "DPM++ 2S a Karras": -45.87,
    "Euler": 4.92,
    "LMS": 12.66,
    "Heun": -40.24,
    "DPM2": -42.50,
    "DPM2 a": -46.60,
    "DPM++ 2S a": -37.10,
    "DPM++ 2M": 7.46,
    "DPM++ SDE": -39.45,
    "DPM fast": 15.54,
    "DPM adaptive": -61.40,
    "LMS Karras": 5,
    "DPM2 Karras": -41,
    "DPM2 a Karras": -38.81,
    "DPM++ 2M Karras": 16.20,
    "DPM++ SDE Karras": -39.71,
    "DDIM": 0,
    "PLMS": 9.31,
}

#: MPE feedback: window length and the rejection threshold.
MPE_WINDOW = 5
MPE_REJECT_ABS_PERCENT = 500.0

#: Compute-time priors per serving precision, relative to the bf16
#: baseline the benchmark measured: the JAX package's constants, kept so
#: both packages give the same predictions. They state no speed of this
#: port; PERF.md records the card's own int8/bf16 ratio beside them, and
#: live samples refine the factor per backend (:func:`record_eta_error`).
PRECISION_PRIOR: Dict[str, float] = {
    "bf16": 1.0,
    "int8": 0.55,
    "int8+conv": 0.5,
}
#: EWMA blend and clamp of the learned per-precision factor: one wild
#: sample cannot collapse it.
PRECISION_EWMA_ALPHA = 0.3
PRECISION_FACTOR_MIN = 0.1
PRECISION_FACTOR_MAX = 1.5


@dataclasses.dataclass
class EtaCalibration:
    """Per-backend speed calibration (persisted in ``WorkerModel``)."""

    avg_ipm: Optional[float] = None
    eta_percent_error: List[float] = dataclasses.field(default_factory=list)
    #: learned compute-time factor per non-bf16 precision (an EWMA of
    #: actual/predicted over that precision's own samples)
    precision_scale: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    @property
    def benchmarked(self) -> bool:
        return self.avg_ipm is not None and self.avg_ipm > 0

    def mpe(self) -> float:
        if not self.eta_percent_error:
            return 0.0
        return sum(self.eta_percent_error) / len(self.eta_percent_error)

    def precision_factor(self, precision: str) -> float:
        """The compute-time multiplier of a resolved precision name: the
        learned factor when it has samples, else the prior; bf16 or ""
        is 1."""
        if not precision or precision == "bf16":
            return 1.0
        learned = self.precision_scale.get(precision)
        if learned is not None:
            return learned
        return PRECISION_PRIOR.get(precision, 1.0)


def predict_eta(cal: EtaCalibration, payload,
                benchmark: Optional[BenchmarkPayload] = None,
                batch_size: Optional[int] = None,
                steps: Optional[int] = None,
                _include_hr: bool = True, precision: str = "") -> float:
    """Seconds to complete ``payload`` on a backend calibrated as ``cal``.

    ``payload`` needs steps, batch_size, width, height, sampler_name and
    enable_hr (with hr_scale and hr_second_pass_steps when enabled): a
    ``GenerationPayload`` or anything duck-typed like one. ``precision``:
    the resolved serving precision, whose factor scales the estimate."""
    if not cal.benchmarked:
        raise ValueError("backend not benchmarked; run the benchmark first")
    bench = benchmark or BenchmarkPayload()

    n = payload.batch_size if batch_size is None else batch_size
    s = payload.steps if steps is None else steps

    eta = (n / cal.avg_ipm) * 60.0
    eta *= s / bench.steps

    if _include_hr and getattr(payload, "enable_hr", False):
        eta += _eta_hires(cal, payload, bench, batch_size=n)

    eta *= (payload.width * payload.height) / (bench.width * bench.height)

    sampler = getattr(payload, "sampler_name", "Euler a")
    delta = SAMPLER_SPEED_VS_EULER_A.get(sampler)
    if sampler != "Euler a" and delta is not None:
        # positive table entry = faster than Euler a -> smaller eta
        eta -= eta * (delta / 100.0) if delta > 0 else -eta * abs(delta) / 100.0

    eta *= cal.precision_factor(precision)

    if cal.eta_percent_error:
        eta -= eta * (cal.mpe() / 100.0)
    return eta


def _eta_hires(cal, payload, bench, batch_size) -> float:
    """The second pass priced as a pseudo-payload at the upscaled size."""
    steps2 = getattr(payload, "hr_second_pass_steps", 0) or payload.steps
    scale = getattr(payload, "hr_scale", 2.0)
    pseudo = dataclasses.make_dataclass(
        "PseudoPayload",
        ["steps", "batch_size", "width", "height", "sampler_name",
         "enable_hr"],
    )(
        steps=steps2,
        batch_size=batch_size,
        width=math.floor(payload.width * scale),
        height=math.floor(payload.height * scale),
        sampler_name=getattr(payload, "sampler_name", "Euler a"),
        enable_hr=False,
    )
    return predict_eta(cal, pseudo, bench, _include_hr=False)


def record_eta_error(cal: EtaCalibration, predicted: float,
                     actual: float, precision: str = "") -> None:
    """Feed one (prediction, reality) pair back into the calibration:
    percent error = (predicted - actual) / actual * 100; |e| >= 500% is
    rejected; the window keeps the last ``MPE_WINDOW`` samples. A sample
    of a non-bf16 ``precision`` updates only that precision's factor (a
    clamped EWMA of actual/predicted) and never the MPE window."""
    if actual <= 0 or predicted <= 0:
        return
    if precision and precision != "bf16":
        error = (predicted - actual) / actual * 100.0
        if abs(error) >= MPE_REJECT_ABS_PERCENT:
            return
        f_old = cal.precision_factor(precision)
        # the prediction already holds f_old: actual/predicted is the
        # multiplicative residual
        f_new = f_old * ((1.0 - PRECISION_EWMA_ALPHA)
                         + PRECISION_EWMA_ALPHA * (actual / predicted))
        cal.precision_scale[precision] = min(
            PRECISION_FACTOR_MAX, max(PRECISION_FACTOR_MIN, f_new))
        return
    error = (predicted - actual) / actual * 100.0
    if abs(error) >= MPE_REJECT_ABS_PERCENT:
        return
    cal.eta_percent_error.append(error)
    while len(cal.eta_percent_error) > MPE_WINDOW:
        cal.eta_percent_error.pop(0)
