#!/usr/bin/env python3
"""The port's mesh paths alone on one NVIDIA GPU: the phases of
``chip_smoke.py`` that they need.

    python3 tools/torch_mesh.py

Builds the kernels, runs the main path (its checks hold K1 on the Hopper
path) and ``phase_mesh`` on its engine: config #1 at full width on
``dp=2`` (batch 2), ``tp=2`` and ``sp=2`` meshes (a virtual mesh over
cuda:0 on one card, distinct cards where there are two) against the
meshless engine, ``ring_attention`` against K1 at the level-0 shape, and
the stage-ahead ControlNet tower on a mesh of its own; then, with the SD1.5
engine freed, config #2's SDXL base and refiner through
``pipelined_txt2img`` against the sequential request. Each phase with the
checks it has in ``chip_smoke.py``; a failed check exits non-zero.
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
    from stable_diffusion_webui_distributed_tpu_torch.ops import (
        flash_attention as fa,
    )
    from stable_diffusion_webui_distributed_tpu_torch.ops import (
        ragged_attention as ra,
    )

    if not torch.cuda.is_available():
        print("torch_mesh: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card_line = cs.card()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{card_line}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    cs.phase_build(fa, ra)
    engine, _, _ = cs.phase_main_path(fa, ra, card_line)
    cs.phase_mesh(engine, fa, card_line)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    base, refiner = cs.config2_engines()
    cs.config2_pipeline(base, refiner, fa, card_line)
    del base, refiner
    print(f"torch_mesh: every phase passed in "
          f"{time.perf_counter() - t0:.1f} s [{card_line}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
