#!/usr/bin/env python3
"""The checkpoint registry's phase of ``chip_smoke.py`` alone, on one
NVIDIA GPU.

    python3 tools/torch_checkpoints.py

Builds the kernels and runs ``phase_checkpoints``: seeded SD1.5 and SDXL
base checkpoints, a VAE and a ControlNet written as f16 ldm files to a
temporary model directory (about 19 GB of free disk with the caches),
served through the port's World, registry and server, each with the checks
it has in ``chip_smoke.py``; a failed check exits non-zero.
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
        print("torch_checkpoints: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card_line = cs.card()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{card_line}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    cs.phase_build(fa, ra)
    cs.phase_checkpoints(fa, ra, card_line)
    print(f"torch_checkpoints: every check passed in "
          f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
