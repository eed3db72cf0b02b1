#!/usr/bin/env python3
"""The per-request cost ladder (int8 and the step cache) alone on one
NVIDIA GPU: the phases of ``chip_smoke.py`` that it needs.

    python3 tools/torch_cost_ladder.py

Builds the kernels, runs the main path (whose SD1.5 engine the ladder
uses) and ``phase_cost_ladder``, frees that engine, and runs
``phase_cost_ladder_sdxl`` on a seeded SDXL base engine; each phase with
the checks it has in ``chip_smoke.py``, a failed check exits non-zero.
"""

import gc
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from stable_diffusion_webui_distributed_tpu_torch.bridge import (
        init_seeded,
    )
    from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
        SDXL_BASE,
    )
    from stable_diffusion_webui_distributed_tpu_torch.ops import (
        flash_attention as fa,
    )
    from stable_diffusion_webui_distributed_tpu_torch.ops import (
        ragged_attention as ra,
    )
    from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import (
        Engine,
    )
    from stable_diffusion_webui_distributed_tpu_torch.runtime import dtypes

    if not torch.cuda.is_available():
        print("torch_cost_ladder: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card_line = cs.card()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{card_line}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    cs.phase_build(fa, ra)
    engine, _, _ = cs.phase_main_path(fa, ra, card_line)
    cs.phase_cost_ladder(engine, fa, ra, card_line)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    params = init_seeded(SDXL_BASE, seed=0, device="cuda",
                         dtype=torch.bfloat16)
    base = Engine(SDXL_BASE, params, policy=dtypes.CARD, device="cuda")
    del params
    cs.phase_cost_ladder_sdxl(base, fa, ra, card_line)
    print(f"torch_cost_ladder: every check passed in "
          f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
