"""Serving precision: W8A8 int8 as a per-request choice.

A copy of the JAX package's ``pipeline/precision.py`` (the port imports
nothing from that package). A request picks ``bf16``, ``int8`` or
``int8+conv`` in its ``precision`` field or in
``override_settings["precision"]``; ``SDTPU_UNET_INT8`` and
``SDTPU_UNET_INT8_CONV`` (``runtime/dtypes.py`` ``Policy``) only set the
default. The resolved name is an axis of the serving group key (int8 and
bf16 requests never share a batch) and of the CUDA-graph tag (an int8 and
a bf16 evaluation of the same shapes never share a graph). The
quantization itself happens at call time from the one set of weights
(``ops/quant.py``): every rung shares the engine's weights, and the
activation scales are computed on the device inside the evaluation.

Quality is held, not assumed: the port's CPU tests keep the JAX package's
floors (PSNR >= 20 dB, SSIM >= 0.6 against bf16; JAX
``tests/test_quality_int8.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

#: The ladder of precisions, cheapest compute last.
PRECISIONS = ("bf16", "int8", "int8+conv")

#: Aliases accepted from payloads and the environment for each name.
_ALIASES = {
    "": "",
    "bf16": "bf16",
    "bfloat16": "bf16",
    "default": "bf16",
    "int8": "int8",
    "w8a8": "int8",
    "int8+conv": "int8+conv",
    "int8-conv": "int8+conv",
    "int8_conv": "int8+conv",
}

#: Name -> (quant_linears, quant_convs).
_FLAGS = {
    "bf16": (False, False),
    "int8": (True, False),
    "int8+conv": (True, True),
}


def bucket_precision(value, default: str = "bf16") -> str:
    """A requested precision on the :data:`PRECISIONS` ladder. Unknown or
    empty values give ``default``: a mistyped precision serves the default
    rung rather than failing the request."""
    try:
        name = str(value or "").strip().lower()
    except Exception:
        return default
    return _ALIASES.get(name, default) or default


@dataclasses.dataclass(frozen=True)
class PrecisionSpec:
    """One request's resolved serving precision."""

    name: str = "bf16"           # ladder name (group-key and graph axis)
    quant_linears: bool = False  # W8A8 the transformer linears
    quant_convs: bool = False    # ...and the ResBlock, Down and Up convs

    @property
    def active(self) -> bool:
        return self.quant_linears or self.quant_convs

    @property
    def flags(self) -> Tuple[bool, bool]:
        return (self.quant_linears, self.quant_convs)


def policy_default(policy=None) -> PrecisionSpec:
    """The engine policy's default precision as a spec: the policy's exact
    flags (a policy with only ``unet_int8_conv`` keeps that combination),
    named by the nearest rung."""
    ql = bool(getattr(policy, "unet_int8", False))
    qc = bool(getattr(policy, "unet_int8_conv", False))
    name = "int8+conv" if qc else ("int8" if ql else "bf16")
    return PrecisionSpec(name=name, quant_linears=ql, quant_convs=qc)


def from_name(name: str) -> PrecisionSpec:
    """The spec of a ladder name (callers bucket first)."""
    canonical = bucket_precision(name)
    ql, qc = _FLAGS[canonical]
    return PrecisionSpec(name=canonical, quant_linears=ql, quant_convs=qc)


def resolve(payload=None, policy=None) -> PrecisionSpec:
    """One request's serving precision: the payload's ``precision`` field,
    else ``override_settings["precision"]``, else the policy's default. A
    request that names none gets exactly :func:`policy_default`."""
    requested: Optional[str] = None
    field = getattr(payload, "precision", "") or ""
    if str(field).strip():
        requested = str(field)
    else:
        ov = getattr(payload, "override_settings", None) or {}
        if str(ov.get("precision") or "").strip():
            requested = str(ov.get("precision"))
    if requested is None:
        return policy_default(policy)
    return from_name(bucket_precision(requested,
                                      policy_default(policy).name))
