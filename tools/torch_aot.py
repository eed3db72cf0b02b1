#!/usr/bin/env python3
"""The kernel-library artifact store alone on one NVIDIA GPU: the ``aot``
phase of ``chip_smoke.py``.

    python3 tools/torch_aot.py

Each step runs in a process of its own over a temporary ``SDTPU_AOT_DIR``
(a library loads once per process): (a) cold, K1 and K2 a miss, built by
nvcc and saved; (b) a new process, both a hit, loaded without a compile;
(c) K2's artifact truncated and (d) K1's cell given another fingerprint:
both rebuilt, two ``aot_fallback`` events journaled; (e) ``verify()`` and
``tools/torch_aot_report.py`` find the store coherent. Each kernel's first
launch is held against its plain version on the Hopper path, with the
checks the phase has in ``chip_smoke.py``; a failed check exits non-zero.
"""

import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("torch_aot: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card_line = cs.card()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{card_line}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    store = tempfile.mkdtemp(prefix="aot-")
    cs.phase_aot(card_line, store, cs.start_aot_child("cold", store))
    print(f"torch_aot: every step passed in "
          f"{time.perf_counter() - t0:.1f} s [{card_line}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
