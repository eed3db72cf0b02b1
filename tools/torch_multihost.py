#!/usr/bin/env python3
"""The port's mesh across processes alone on one NVIDIA GPU: the phases of
``chip_smoke.py`` that it needs.

    python3 tools/torch_multihost.py

Builds the kernels, runs the main path (its checks hold K1 on the Hopper
path), starts the multihost phase's two rank processes (they get ready
and wait), makes the phase's reference on its engine (config #1 at batch 2 on
a ``dp=2`` mesh over cuda:0, the mesh phase's ``dp=2`` request) and runs
``phase_multihost``: the two rank processes run ``cli generate`` on
cuda:0 in one gloo group, each the replica of one ``dp`` index, held to
that reference byte for byte and to 320 K1 launches each on the Hopper
path. A failed check exits non-zero.
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
    from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
        GenerationPayload,
    )
    from stable_diffusion_webui_distributed_tpu_torch.runtime.mesh import (
        build_mesh,
    )

    if not torch.cuda.is_available():
        print("torch_multihost: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card_line = cs.card()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{card_line}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    cs.phase_build(fa, ra)
    engine, _, _ = cs.phase_main_path(fa, ra, card_line)
    ranks = cs.start_multihost_ranks()
    devices, _ = cs.mesh_devices()
    engine.set_mesh(build_mesh("dp=2", devices))
    reference = engine.txt2img(GenerationPayload(
        **{**cs.MESH_BODY, "batch_size": cs.MULTIHOST_RANKS}))
    engine.set_mesh(None)
    cs.phase_multihost(ranks, {"dp2_images": reference.images}, fa,
                       card_line)
    print(f"torch_multihost: every phase passed in "
          f"{time.perf_counter() - t0:.1f} s [{card_line}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
