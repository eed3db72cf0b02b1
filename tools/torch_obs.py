#!/usr/bin/env python3
"""The request-observability plane alone on one NVIDIA GPU: the phases of
``chip_smoke.py`` that it needs.

    python3 tools/torch_obs.py

Builds the kernels, runs the main path (its checks hold K1 on the Hopper
path), then ``phase_obs``: 12 warm config #1 requests with spans and the
perf ledger on and off in turns (p50 of each, the same PNG bytes, 320 K1
launches each), ``GET /internal/perf``'s group row with its MFU against the
card's peak, one request under ``torch.profiler`` (the ledger's device
seconds against the profiler's), ``GET /internal/trace.json`` and ``GET
/internal/metrics``, ``POST /internal/profile`` (a Chrome trace holding
K1), and a World whose remote is slowed by a chaos fault past the hang
watchdog's deadline (the stall recorded, the range requeued with the
remote's bytes); each with the checks it has in ``chip_smoke.py``, a
failed check exits non-zero.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from stable_diffusion_webui_distributed_tpu_torch.ops import (
        flash_attention as fa,
    )
    from stable_diffusion_webui_distributed_tpu_torch.ops import (
        ragged_attention as ra,
    )

    if not torch.cuda.is_available():
        print("torch_obs: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card_line = cs.card()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{card_line}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    cs.phase_build(fa, ra)
    engine, _, _ = cs.phase_main_path(fa, ra, card_line)
    cs.phase_obs(engine, fa, ra, card_line)
    del engine
    print(f"torch_obs: every phase passed in "
          f"{time.perf_counter() - t0:.1f} s [{card_line}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
