#!/usr/bin/env python3
"""The port's scenario engine alone on one NVIDIA GPU: the phases of
``chip_smoke.py`` that it needs.

    python3 tools/torch_scenarios.py

Builds the kernels, runs the main path (its checks hold K1 on the Hopper
path) and ``phase_scenarios`` on its engine: config #1 at full width
(SD1.5, 512x512, 20 steps of Euler a, CFG 7) as a recorded four-request
mix, then the steady, flash-burst and chaos-kill scenarios and the
capacity sweep over it, each scored per class (p50, p95, SLO attainment
and burn) beside its K1 launches and the perf ledger's device ms and MFU
per dispatch; the seven schedule-explorer harnesses on this interpreter;
the native PNG encoder against PIL. It prints the scorecards and writes
no file. A failed check exits non-zero.
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
        print("torch_scenarios: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card_line = cs.card()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{card_line}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    cs.phase_build(fa, ra)
    engine, _, _ = cs.phase_main_path(fa, ra, card_line)
    cs.phase_scenarios(engine, fa, ra, card_line)
    print(f"torch_scenarios: every phase passed in "
          f"{time.perf_counter() - t0:.1f} s [{card_line}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
