#!/usr/bin/env python3
"""The stage-graph executor, cancel and chaos alone on one NVIDIA GPU: the
phases of ``chip_smoke.py`` that they need.

    python3 tools/torch_stage_graph.py

Builds the kernels, runs the main path (its checks hold K1 on the Hopper
path) and the ragged serving phase (whose graphs the ragged staged group
replays), then ``phase_stage_graph``: config #1 with ``n_iter`` 4 serial
and staged at depths 1 and 2, the dispatcher's staged groups (dense and
ragged), the stage-ahead ControlNet, a cancel through ``POST
/internal/cancel`` and a chaos ``kill`` with the request journal; each
phase with the checks it has in ``chip_smoke.py``, a failed check exits
non-zero.
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
        print("torch_stage_graph: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card_line = cs.card()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{card_line}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    cs.phase_build(fa, ra)
    engine, _, _ = cs.phase_main_path(fa, ra, card_line)
    cs.phase_ragged_serving(engine, fa, ra, card_line)
    cs.phase_stage_graph(engine, fa, ra, card_line)
    del engine
    print(f"torch_stage_graph: every phase passed in "
          f"{time.perf_counter() - t0:.1f} s [{card_line}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
