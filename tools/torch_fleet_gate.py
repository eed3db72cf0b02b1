#!/usr/bin/env python3
"""The fleet gate alone on one NVIDIA GPU: the phases of ``chip_smoke.py``
that it needs.

    python3 tools/torch_fleet_gate.py

Builds the kernels, runs the main path (its checks hold K1 on the Hopper
path) and ``phase_fleet_gate``: preemption with the gate off and on,
quotas, ETA-SLO admission, the warm pool and the autoscaler, on config #1;
each phase with the checks it has in ``chip_smoke.py``, a failed check
exits non-zero.
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
        print("torch_fleet_gate: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card_line = cs.card()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{card_line}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    cs.phase_build(fa, ra)
    engine, _, _ = cs.phase_main_path(fa, ra, card_line)
    cs.phase_fleet_gate(fa, ra, card_line)
    del engine
    print(f"torch_fleet_gate: every phase passed in "
          f"{time.perf_counter() - t0:.1f} s [{card_line}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
