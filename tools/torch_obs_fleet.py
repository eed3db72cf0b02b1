#!/usr/bin/env python3
"""The fleet telemetry plane alone on one NVIDIA GPU: the phases of
``chip_smoke.py`` that it needs.

    python3 tools/torch_obs_fleet.py

Builds the kernels, runs the main path (its checks hold K1 on the Hopper
path), then ``phase_fleet_obs``: a World over the main path's engine and a
remote node in a child process (``tools/torch_obs_remote.py``), every gate
of the plane on (the TSDB and its sampler, alerts, notify to a local
webhook, federation, push, the journal): fleet config #1 requests with the
gates on and off in turns (the same PNG bytes, 320 K1 launches a node, the
p50 of each arm, the push plane's delivery lag), the subscriber without
loss or duplicate, the fleet timeline and the stitched trace of one
request, the executables census, the TSDB's device-memory series against
``torch.cuda.memory_stats()``, the federated view, the autoscaler's feeds,
a chaos stall that pages once and resolves once, and a restart of the
remote's server that the subscriber resumes across; each with the checks
it has in ``chip_smoke.py``, a failed check exits non-zero.
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
        print("torch_obs_fleet: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card_line = cs.card()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{card_line}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    cs.phase_build(fa, ra)
    engine, _, _ = cs.phase_main_path(fa, ra, card_line)
    cs.phase_fleet_obs(engine, fa, ra, card_line)
    del engine
    print(f"torch_obs_fleet: every phase passed in "
          f"{time.perf_counter() - t0:.1f} s [{card_line}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
