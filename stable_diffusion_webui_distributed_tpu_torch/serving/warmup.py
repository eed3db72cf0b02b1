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

Not ported yet: ``SDTPU_WARMUP_PRECISIONS`` and ``_warmup_precisions``
wait for the serving-precision ladder (int8), and a non-empty value raises
:class:`~..pipeline.payload.Unsupported` rather than being ignored; the
report's ``xla_cache_dir`` and ``aot`` block wait for the compiled-artifact
store. Graphs live in process memory, so a restarted server sweeps again.
"""

from __future__ import annotations

import re
import time
from typing import Dict, List, Optional

from stable_diffusion_webui_distributed_tpu_torch.models import (
    lora as lora_mod,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
    Unsupported,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    env_int,
    env_str,
)
from stable_diffusion_webui_distributed_tpu_torch.serving.bucketer import (
    ShapeBucketer,
)
from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
    METRICS,
)


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
    """Run one generation per ``(shape, batch[, LoRA cell])`` point of the
    ladder; returns the JAX package's report: the points, the steps and
    sampler, the LoRA cells, the graphs the sweep captured by kind
    (``stage_builds``) and its wall time."""
    if env_str("SDTPU_WARMUP") == "0":
        return {"skipped": True, "reason": "SDTPU_WARMUP=0"}
    rungs = env_str("SDTPU_WARMUP_PRECISIONS", "")
    if rungs.strip():
        raise Unsupported(f"SDTPU_WARMUP_PRECISIONS={rungs!r}: serving "
                          f"precision rungs are not ported to the PyTorch "
                          f"engine yet")
    bucketer = bucketer or ShapeBucketer()
    steps = steps if steps is not None else env_int("SDTPU_WARMUP_STEPS", 20)
    sampler = sampler or env_str("SDTPU_WARMUP_SAMPLER", "Euler a")

    lora_cells = _warmup_lora_cells()
    before = dict(METRICS.summary()["compiles"])
    t0 = time.monotonic()
    warmed = []
    try:
        for bw, bh in bucketer.shapes:
            for nb in bucketer.batches:
                for cell in lora_cells:
                    engine._warmup_lora = cell
                    payload = GenerationPayload(
                        prompt="", steps=steps, width=bw, height=bh,
                        batch_size=nb, sampler_name=sampler, seed=0)
                    engine.state.begin_request()
                    engine.generate_range(payload, 0, None, "warmup")
                    point = [bw, bh, nb]
                    if cell is not None:
                        point.append("r%ds%d" % cell)
                    warmed.append(tuple(point))
    finally:
        engine._warmup_lora = None
        engine._traced_lora = None
    after = METRICS.summary()["compiles"]
    built = {k: after.get(k, 0) - before.get(k, 0)
             for k in after if after.get(k, 0) != before.get(k, 0)}
    return {
        "skipped": False,
        "buckets": warmed,
        "steps": steps,
        "sampler": sampler,
        "precisions": [""],
        "lora_cells": ["r%ds%d" % c for c in lora_cells if c is not None],
        "stage_builds": built,
        "wall_s": round(time.monotonic() - t0, 2),
    }
