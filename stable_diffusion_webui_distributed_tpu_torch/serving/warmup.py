"""Warmup: capture the bucket ladder's UNet graphs at server start.

Port of the JAX package's ``serving/warmup.py``. With shape bucketing in
front, the shapes a server dispatches are known at startup: the bucket
ladder times the batch ladder, at the configured serving defaults. Where
the JAX package compiles one chunk executable per point, the port captures
one CUDA graph per UNet-evaluation signature (``runtime/graphs.py``): the
sweep runs one generation per point (``prompt=""``, seed 0), so the first
request of every bucket replays graphs instead of capturing them.

Knobs: ``SDTPU_WARMUP`` (``0`` skips; the CLI sweeps when it is set),
``SDTPU_WARMUP_STEPS`` / ``SDTPU_WARMUP_SAMPLER`` pick the ``(steps,
sampler)`` point (20, ``Euler a``); a graph's signature does not hold the
step count, but a sampler or a size outside the sweep meets new shapes.
``SDTPU_WARMUP_LORA`` (comma-separated ``rXsY`` cells, default none) adds
traced-LoRA ladder cells under ``SDTPU_LORA_TRACED``: an all-zero stand-in
set per cell captures the graphs every adapter bucketed into that cell
replays (its factors are per-run graph inputs).

``SDTPU_WARMUP_PRECISIONS`` (comma-separated, default "" = the policy's
default only) adds serving-precision rungs (``pipeline/precision.py``):
``bf16,int8`` also captures the int8 graphs of every point, which an int8
request of that shape replays (a precision is an axis of the graph tag).
The sweep captures no step-cache graph: a bucket's first request with a
cadence or a cutoff captures them, and they serve every cadence and cutoff
after it.

With ``SDTPU_AOT`` on, the report has the JAX package's ``aot`` block,
over what the port stores (``serving/aot.py``): ``enabled``, ``dir``, the
store's outcome tallies (``stats``), the kernel libraries loaded through
it with their outcomes (``libraries``), those the sweep loaded from it
(``hydrated``) and the share of the libraries that were hits
(``hit_rate``). The JAX report's ``xla_cache_dir`` has no counterpart:
there is no compilation cache to name. Graphs live in process memory, so
a restarted server sweeps again.
"""

from __future__ import annotations

import re
import time
from typing import Dict, List, Optional

from stable_diffusion_webui_distributed_tpu_torch.models import (
    lora as lora_mod,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline import (
    precision as precision_mod,
)
from stable_diffusion_webui_distributed_tpu_torch.ops import nvcc
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    env_int,
    env_str,
)
from stable_diffusion_webui_distributed_tpu_torch.serving import aot
from stable_diffusion_webui_distributed_tpu_torch.serving.bucketer import (
    ShapeBucketer,
)
from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
    METRICS,
)


def _warmup_precisions() -> List[str]:
    """Precision rungs to sweep, bucketed onto the ladder ("" = the
    engine policy's default): the one empty entry unless
    SDTPU_WARMUP_PRECISIONS names more."""
    raw = env_str("SDTPU_WARMUP_PRECISIONS", "")
    if not raw.strip():
        return [""]
    out: List[str] = []
    for part in raw.split(","):
        name = precision_mod.bucket_precision(part, "")
        entry = name if part.strip() else ""
        if entry not in out:
            out.append(entry)
    return out or [""]


def _warmup_lora_cells() -> List[Optional[tuple]]:
    """Traced-LoRA ladder cells to sweep, parsed from SDTPU_WARMUP_LORA
    ("r16s1,r32s2" -> [(16, 1), (32, 2)]); None is the adapterless point.
    Cells are bucketed onto the configured ladders, so "r10s3" warms the
    (16, 4) graphs a rank-10, 3-adapter request would replay. Adapterless
    only unless SDTPU_LORA_TRACED is on: the merged path shares the
    adapterless graphs."""
    raw = env_str("SDTPU_WARMUP_LORA", "")
    if not raw.strip() or not lora_mod.traced_enabled():
        return [None]
    out: List[Optional[tuple]] = [None]
    for part in raw.split(","):
        part = part.strip().lower()
        if not part:
            continue
        m = re.fullmatch(r"r(\d+)s(\d+)", part)
        if m is None:
            continue
        rb = lora_mod.bucket_rank(int(m.group(1)))
        sc = lora_mod.bucket_slots(int(m.group(2)))
        if rb is None or sc is None:
            continue
        cell = (rb, sc)
        if cell not in out:
            out.append(cell)
    return out


def warmup_engine(engine, bucketer: Optional[ShapeBucketer] = None,
                  steps: Optional[int] = None,
                  sampler: Optional[str] = None) -> Dict:
    """Run one generation per ``(shape, batch[, precision][, LoRA cell])``
    point of the ladder; returns the JAX package's report: the points, the
    steps and sampler, the precisions, the LoRA cells, the graphs the
    sweep captured by kind (``stage_builds``), its wall time and, with
    ``SDTPU_AOT`` on, the ``aot`` block."""
    if env_str("SDTPU_WARMUP") == "0":
        return {"skipped": True, "reason": "SDTPU_WARMUP=0"}
    bucketer = bucketer or ShapeBucketer()
    steps = steps if steps is not None else env_int("SDTPU_WARMUP_STEPS", 20)
    sampler = sampler or env_str("SDTPU_WARMUP_SAMPLER", "Euler a")

    precisions = _warmup_precisions()
    lora_cells = _warmup_lora_cells()
    summary0 = METRICS.summary()
    before = dict(summary0["compiles"])
    aot_before = dict(summary0["aot_loads"])
    t0 = time.monotonic()
    warmed = []
    try:
        for bw, bh in bucketer.shapes:
            for nb in bucketer.batches:
                for prec in precisions:
                    for cell in lora_cells:
                        engine._warmup_lora = cell
                        payload = GenerationPayload(
                            prompt="", steps=steps, width=bw, height=bh,
                            batch_size=nb, sampler_name=sampler, seed=0,
                            precision=prec)
                        engine.state.begin_request()
                        engine.generate_range(payload, 0, None, "warmup")
                        point = [bw, bh, nb]
                        if prec != "":
                            point.append(prec)
                        if cell is not None:
                            point.append("r%ds%d" % cell)
                        warmed.append(tuple(point))
    finally:
        engine._warmup_lora = None
        engine._traced_lora = None
    summary1 = METRICS.summary()
    after = summary1["compiles"]
    built = {k: after.get(k, 0) - before.get(k, 0)
             for k in after if after.get(k, 0) != before.get(k, 0)}
    report = {
        "skipped": False,
        "buckets": warmed,
        "steps": steps,
        "sampler": sampler,
        "precisions": precisions,
        "lora_cells": ["r%ds%d" % c for c in lora_cells if c is not None],
        "stage_builds": built,
        "wall_s": round(time.monotonic() - t0, 2),
    }
    if aot.enabled():
        aot_after = summary1["aot_loads"]
        libraries = nvcc.store_outcomes()
        hits = sum(1 for o in libraries.values() if o == "hit")
        report["aot"] = {
            "enabled": True,
            "dir": aot.default_dir(),
            "stats": aot.get_store().stats_snapshot(),
            "libraries": libraries,
            "hydrated": {k: aot_after.get(k, 0) - aot_before.get(k, 0)
                         for k in aot_after
                         if aot_after.get(k, 0) != aot_before.get(k, 0)},
            "hit_rate": hits / len(libraries) if libraries else None,
        }
    return report
