"""Multi-tenant fleet tier above the serving dispatcher.

Port of the JAX package's ``fleet/`` package:

- :mod:`.policy` — priority classes, weighted-fair queueing with aging,
  the device gate, and the chunk-boundary preempt hook;
- :mod:`.quotas` — per-tenant token-bucket admission quotas;
- :mod:`.admission` — ETA-SLO accept / degrade / reject control;
- :mod:`.slices` — slice registry + queue-wait-driven autoscale signals;
- :mod:`.pool` — the warm engine pool that executes them.

Everything is host-side policy over the engine and the dispatcher;
``SDTPU_FLEET=0`` (the default) keeps the whole tier inert and the
serving path as it was.
"""

from stable_diffusion_webui_distributed_tpu_torch.fleet.admission import (
    AdmissionController,
    AdmissionDecision,
    FleetRejected,
)
from stable_diffusion_webui_distributed_tpu_torch.fleet.policy import (
    BATCH,
    BEST_EFFORT,
    INTERACTIVE,
    ClassPolicy,
    EnginePreemptHook,
    FleetGate,
    FleetPolicy,
    GateEntry,
    WeightedFairQueue,
    fleet_enabled,
)
from stable_diffusion_webui_distributed_tpu_torch.fleet.quotas import (
    QuotaLedger,
    TokenBucket,
)
from stable_diffusion_webui_distributed_tpu_torch.fleet.slices import (
    AutoscaleEngine,
    ScaleDecision,
    SliceInfo,
    SliceRegistry,
)

__all__ = [
    "AdmissionController", "AdmissionDecision", "FleetRejected",
    "BATCH", "BEST_EFFORT", "INTERACTIVE", "ClassPolicy",
    "EnginePreemptHook", "FleetGate", "FleetPolicy", "GateEntry",
    "WeightedFairQueue", "fleet_enabled",
    "QuotaLedger", "TokenBucket",
    "AutoscaleEngine", "ScaleDecision", "SliceInfo", "SliceRegistry",
]
