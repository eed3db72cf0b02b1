#!/usr/bin/env python3
"""BASELINE config #5 alone on one NVIDIA GPU: the phases of
``chip_smoke.py`` that it needs, without the rest of the smoke run.

    python3 tools/torch_config5.py

Builds the kernels, checks and times K1 at config #5's four shapes (the
first pass at 1024x1024, the second at 2048x2048), builds the SDXL base
engine on config #2's seeded weights (without the refiner) and runs
config #5's phase: the latent and the image-space hires paths through the
port's server, each with the checks it has in ``chip_smoke.py``; a failed
check exits non-zero.
"""

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
        print("torch_config5: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card_line = cs.card()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{card_line}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    cs.phase_build(fa, ra)
    cs.phase_sdxl_kernels(fa, card_line, cs.CONFIG5_SHAPES)
    # config #2's base engine: the same seed, the card policy
    params = init_seeded(SDXL_BASE, seed=0, device="cuda",
                         dtype=torch.bfloat16)
    base = Engine(SDXL_BASE, params, policy=dtypes.CARD, device="cuda")
    del params
    cs.phase_config5(base, fa, ra, card_line)
    print(f"torch_config5: every check passed in "
          f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
