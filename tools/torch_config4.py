#!/usr/bin/env python3
"""BASELINE config #4 alone on one NVIDIA GPU: the phases of
``chip_smoke.py`` that it needs, without the rest of the smoke run.

    python3 tools/torch_config4.py

Builds the kernels, checks and times K1 at config #4's two shapes, runs
config #2 (whose SDXL base engine config #4 reuses) and then config #4,
each phase with the checks it has in ``chip_smoke.py``; a failed check
exits non-zero. About a third of the whole smoke run's time.
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
        print("torch_config4: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card_line = cs.card()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{card_line}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    cs.phase_build(fa, ra)
    cs.phase_sdxl_kernels(fa, card_line, cs.CONFIG4_SHAPES)
    _, base = cs.phase_config2(fa, ra, card_line)
    cs.phase_config4(base, fa, ra, card_line)
    print(f"torch_config4: every check passed in "
          f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
