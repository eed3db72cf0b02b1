"""Environment knobs and the distributed config file.

A copy of the parts of the JAX package's ``runtime/config.py`` that the
port reads. The knobs keep their names and defaults:

- ``SDTPU_SERVING`` (flag, on): ``ApiServer`` puts a ``ServingDispatcher``
  in front of a bare engine.
- ``SDTPU_COALESCE_WINDOW`` (seconds, 0.05): how long a group's leader
  waits for compatible requests to join it.
- ``SDTPU_BUCKET_LADDER`` (``WxH`` comma list, ``512x512,640x640,768x768,
  1024x1024``) and ``SDTPU_BATCH_LADDER`` (int comma list, ``1,2,4,8``):
  the shapes and batch sizes requests are padded up to.
- ``SDTPU_RAGGED`` (flag, off): ragged dispatch; ``SDTPU_RAGGED_LADDER``
  (``WxH`` comma list) optionally replaces the shape ladder for it.
- ``SDTPU_CONFIG`` (path, ``distributed-config.json``): the fleet's
  config file when ``--distributed-config`` names none.
- ``SDTPU_HEARTBEAT_S`` (seconds, 0 = off): the World's ping sweep.

Warmup knobs (``serving/warmup.py``; README "Warmup and CUDA graphs"):

- ``SDTPU_WARMUP`` (flag, off): ``cli serve`` sweeps the local engine's
  bucket ladder before it takes traffic, capturing the CUDA graph of every
  UNet evaluation the ladder's requests make; ``0`` makes
  ``warmup_engine`` skip (it runs when called otherwise).
- ``SDTPU_WARMUP_STEPS`` (int, 20) and ``SDTPU_WARMUP_SAMPLER`` (``Euler
  a``): the request each ladder point runs. A graph's signature does not
  hold the step count; a sampler or size outside the sweep captures at
  its first request instead.
- ``SDTPU_WARMUP_LORA`` (comma ``rXsY`` list, default "" = none): the
  traced-LoRA ladder cells the sweep also captures, with all-zero
  stand-in sets (under ``SDTPU_LORA_TRACED``): every adapter bucketed into
  a warmed cell replays its graphs.
- ``SDTPU_WARMUP_PRECISIONS`` (comma list, default "" = the policy's
  default only): the serving precisions the sweep also captures at every
  point (``bf16,int8`` warms the int8 graphs too); a precision is an axis
  of the graph tag.

Cost levers (``pipeline/precision.py``, ``pipeline/stepcache.py``; README
"Per-request cost levers"), each the default a request's own setting
overrides:

- ``SDTPU_UNET_INT8`` / ``SDTPU_UNET_INT8_CONV`` (flags, off): the card
  policy's default serving precision, ``int8`` / ``int8+conv``
  (``runtime/dtypes.py``); per request: ``precision`` or
  ``override_settings.precision``.
- ``SDTPU_DEEPCACHE`` (int, 1 = off): the deep-feature refresh cadence,
  rounded down onto ``stepcache.CADENCE_LADDER`` (1/2/3/4/6/8); per
  request: ``override_settings.deepcache``.
- ``SDTPU_CFG_CUTOFF`` (float sigma, 0 = off): from the first step whose
  sigma lies below it the unconditional half is dropped; per request:
  ``override_settings.cfg_cutoff``.

Fleet-tier knobs (``fleet/``; README "Fleet gate"):

- ``SDTPU_FLEET`` (flag, off): the multi-tenant tier: weighted-fair
  device gate, per-tenant quotas, ETA-SLO admission and chunk-boundary
  preemption. Off keeps the dispatcher's plain execution lock as it was.
  The config field ``fleet_enabled`` sets the same switch; the env var
  wins.
- ``SDTPU_FLEET_CLASSES`` (``name:weight`` list, ``interactive:8,batch:2,
  best_effort:1``): the fair-queue weight per priority class; unknown
  names define extra classes scheduled like ``batch``.
- ``SDTPU_SLO_INTERACTIVE_S`` (seconds, 30): the completion SLO admission
  enforces for ``interactive`` requests; 0 disables it. A request's
  ``slo_s`` overrides it.
- ``SDTPU_QUOTA_IPM`` (images per minute, 0 = unlimited): each tenant's
  token-bucket refill rate; ``SDTPU_QUOTA_BURST`` (8) its depth. An
  exhausted tenant gets 429 with ``Retry-After``.
- ``SDTPU_FLEET_AGING_S`` (seconds, 10): waiters older than this are
  served oldest first whatever their tags (the starvation bound).
- ``SDTPU_FLEET_QUANTUM_S`` (seconds, 0.25): the least device tenure
  before a preemptible job may be asked to yield.
- ``SDTPU_FLEET_FEWSTEP`` (int, 12): the step budget of admission's
  few-step degrade rung; 0 disables the rung.
- ``SDTPU_AUTOSCALE_UP_S`` / ``SDTPU_AUTOSCALE_DOWN_S`` /
  ``SDTPU_AUTOSCALE_COOLDOWN_S`` (seconds, 5 / 0.5 / 60): scale a slice
  up when the worst per-class queue-wait p95 reaches UP_S, down when it
  falls to DOWN_S, at most once per slice per cooldown;
  ``SDTPU_AUTOSCALE_AUDIT`` (int, 256): the decision audit ring behind
  ``GET /internal/autoscale``.
- ``SDTPU_POOL`` (flag, off): the warm engine pool (``fleet/pool.py``):
  a dispatcher made with ``pool=`` checks each execution out to the
  least-loaded ready resident, and autoscale decisions attached with
  ``WarmPool.attach_autoscale`` spawn and retire residents.
  ``SDTPU_POOL_SIZE`` (int, 2): the target ready count ``heal()``
  restores; ``SDTPU_POOL_COOLDOWN_S`` (seconds, 0): the least time
  between autoscale-driven spawns and retirements.
- ``SDTPU_STAGE_GRAPH`` (flag, off, read per request): the stage-graph
  executor (``parallel/stage_graph.py``) for txt2img without a refiner,
  hires fix or adaptive sampler, and for the dispatcher's coalesced
  groups; ``SDTPU_STAGE_DEPTH`` (int, 1): the groups in flight before
  the oldest one's images are fetched; ``SDTPU_STAGE_CN_DEVICES`` (int,
  0): devices for the stage-ahead ControlNet tower, a ``dp`` mesh over
  the last free cards (``Engine._stage_cn_mesh``); none free, or the
  slice would take every card, and the tower shares the engine's.
- ``SDTPU_JOURNAL`` (flag, off, read per event): the request journal
  (``obs/journal.py``, ``GET /internal/journal``); ``SDTPU_JOURNAL_MAX``
  (int, 4096) its ring; ``SDTPU_JOURNAL_SINK`` (path, "" = none) the
  JSONL file ring-evicted events spill to, rotated once past
  ``SDTPU_JOURNAL_SINK_MAX_MB`` (float, 0 = unbounded).
- ``SDTPU_SIM`` (flag, off): the scenario engine (``sim/``); the chaos
  plan (``sim/chaos.py``) refuses to arm without it; ``GET
  /internal/sim``.

Artifact-store knobs (``serving/aot.py``; README "The kernel-library
artifact store"):

- ``SDTPU_AOT`` (flag, off, read per build): the kernel libraries go
  through the artifact store: a library is loaded from it when its cell
  (its sources, its toolchain) is there with this runtime's fingerprint
  (PyTorch, its CUDA, the toolchain, the card's name, compute capability
  and count) and its sha256 holds; otherwise nvcc builds it and the store
  is back-filled, a fingerprint mismatch or a damaged artifact journaled
  as ``aot_fallback``. Off, libraries are built into ``_build/`` as before
  and the store is not touched.
- ``SDTPU_AOT_DIR`` (path, ``~/.cache/sdtpu-aot``): the store's root, a
  ``manifest.json`` and content-named ``*.so`` files (rendered and
  verified by ``tools/torch_aot_report.py``); re-read per store access.

Malformed values warn and fall back to the default: a bad knob must not
take the server down.

The config file (:class:`ConfigModel`) has the JAX package's schema field
for field, so a file written by either package loads in the other: the
worker registry with each worker's calibration (images per minute, ETA
error history, pixel cap), the benchmark payload and the scheduler
settings. A missing file gives the defaults, a legacy list of workers is
migrated, and a corrupt or invalid file is renamed aside.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
import warnings
from typing import Dict, Iterator, List, Optional

from pydantic import BaseModel, Field, field_validator

log = logging.getLogger(__name__)


def env_str(name: str, default: str = "") -> str:
    return os.environ.get(name, default)


def env_flag(name: str, default: bool = False) -> bool:
    """'' -> default; '0'/'false'/'off'/'no' -> False; anything else ->
    True."""
    raw = os.environ.get(name, "").strip().lower()
    if raw == "":
        return default
    return raw not in ("0", "false", "off", "no")


def env_parsed(name: str, parse, default, what: str = "value"):
    """Unset -> default; unparseable (``parse`` raises ValueError or
    TypeError) -> a UserWarning and the default."""
    raw = os.environ.get(name, "")
    if raw.strip() == "":
        return default
    try:
        return parse(raw)
    except (ValueError, TypeError) as e:
        warnings.warn(f"{name}={raw!r} is not a valid {what} ({e}); "
                      f"using default {default!r}", stacklevel=3)
        return default


@contextlib.contextmanager
def env_patch(**values: str) -> Iterator[None]:
    """Set env knobs for the block and restore them exactly after it (a
    knob unset before is unset again)."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, old in saved.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old


def env_int(name: str, default: Optional[int] = None) -> Optional[int]:
    return env_parsed(name, lambda raw: int(raw.strip()), default, "int")


def env_float(name: str, default: Optional[float] = None) -> Optional[float]:
    return env_parsed(name, lambda raw: float(raw.strip()), default, "float")


#: The benchmark protocol: warm-up samples, then recorded samples.
WARMUP_SAMPLES = 2
RECORDED_SAMPLES = 3


class BenchmarkPayload(BaseModel):
    """The fixed calibration workload every worker's ipm is measured on."""

    prompt: str = "A herd of cows grazing at the bottom of a sunny valley"
    negative_prompt: str = ""
    steps: int = 20
    width: int = 512
    height: int = 512
    batch_size: int = 1
    sampler_name: str = "Euler a"


class WorkerModel(BaseModel):
    """One worker's persisted state: its endpoint and its calibration,
    which survive restarts so scheduling stays warm."""

    address: str = "localhost"
    port: int = 7860
    avg_ipm: Optional[float] = None  # images per minute; None = not benchmarked
    master: bool = False
    # ETA percent-error history, most recent last
    eta_percent_error: List[float] = Field(default_factory=list)
    user: Optional[str] = None
    password: Optional[str] = None
    tls: bool = False
    disabled: bool = False
    # the most width*height*batch this worker accepts; 0 = uncapped (the
    # reference's -1 "no limit" is normalised to 0 on load)
    pixel_cap: int = 0
    # checkpoint pin: model sync sends this name instead of the fleet's
    model_override: Optional[str] = None
    # local devices this backend drives (empty = all; remotes leave it
    # empty). Kept so that the JAX package's files load unchanged.
    device_ids: List[int] = Field(default_factory=list)

    @field_validator("pixel_cap")
    @classmethod
    def _normalize_pixel_cap(cls, v: int) -> int:
        return 0 if v <= 0 else v


class ConfigModel(BaseModel):
    """The root of the config file."""

    workers: List[Dict[str, WorkerModel]] = Field(default_factory=list)
    benchmark_payload: BenchmarkPayload = Field(default_factory=BenchmarkPayload)
    # seconds of predicted stall tolerated before a worker's images are
    # deferred to faster ones
    job_timeout: int = 3
    enabled: bool = True
    enabled_i2i: bool = True
    # deferred workers make "bonus" images in their slack time
    complement_production: bool = True
    # a complementary worker too slow for one image gets one at fewer steps
    step_scaling: bool = False
    # the master plans and merges but makes no images itself
    thin_client_mode: bool = False
    # read by the JAX package (checkpoint registry, mesh, serving ladders,
    # fleet tier); kept so that either package's file loads in the other
    model_dir: str = "models"
    default_model: str = ""
    mesh_axes: Dict[str, int] = Field(default_factory=dict)
    bucket_ladder: str = ""
    batch_ladder: str = ""
    coalesce_window: Optional[float] = None
    # the fleet tier (fleet/); None = off unless SDTPU_FLEET says
    # otherwise (the env var wins)
    fleet_enabled: Optional[bool] = None


def default_config_path() -> str:
    return env_str("SDTPU_CONFIG", "distributed-config.json")


def load_config(path: Optional[str] = None) -> ConfigModel:
    """Read and validate the config file. A missing file gives the
    defaults; a legacy list of worker dicts is migrated; a file that does
    not parse or validate is renamed aside and the defaults are used."""
    path = path or default_config_path()
    if not os.path.exists(path):
        log.debug("config %s not found, using defaults", path)
        return ConfigModel()
    try:
        with open(path, "r", encoding="utf-8") as f:
            raw = json.load(f)
    except (json.JSONDecodeError, OSError) as e:
        return _quarantine(path, "corrupt", e)
    try:
        if isinstance(raw, list):
            log.info("migrating legacy worker-list config %s", path)
            workers = []
            for entry in raw:
                label = entry.pop("label", entry.get("address", "worker"))
                workers.append({label: WorkerModel(**entry)})
            return ConfigModel(workers=workers)
        return ConfigModel(**raw)
    except Exception as e:  # noqa: BLE001 — any schema error quarantines
        return _quarantine(path, "invalid", e)


def _quarantine(path: str, kind: str, err: Exception) -> ConfigModel:
    quarantine = f"{path}.{kind}-{int(time.time())}"
    log.warning("config %s %s (%s); moving to %s", path, kind, err,
                quarantine)
    try:
        os.replace(path, quarantine)
    except OSError:
        pass
    return ConfigModel()


def save_config(cfg: ConfigModel, path: Optional[str] = None) -> None:
    """Write the config atomically (a temporary file, then a rename)."""
    path = path or default_config_path()
    tmp = f"{path}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(cfg.model_dump(), f, indent=2)
    os.replace(tmp, path)
    log.debug("config saved to %s", path)
