#!/usr/bin/env python3
"""The port's mesh across processes alone on one NVIDIA GPU: the phases of
``chip_smoke.py`` that it needs.

    python3 tools/torch_multihost.py

Builds the kernels, runs the main path (its checks hold K1 on the Hopper
path), starts the multihost phase's rank pairs (``MULTIHOST_PAIRS``: they
get ready and wait), makes each pair's reference on its engine (config #1
at batch 2 on a ``dp=2`` mesh over cuda:0 and at batch 1 on ``tp=2``, the
mesh phase's requests; ``tp=2`` at ``MULTIHOST_TP_STEPS``, each timed
first and warm) and runs ``phase_multihost`` for each pair: the two rank
processes run ``cli generate`` on cuda:0 in one gloo group, on ``dp=2``
each the replica of one ``dp`` index, on ``tp=2`` each one head shard of
the one replica, held to the reference byte for byte and to 16 K1
launches an evaluation each on the Hopper path, a ``tp=2`` rank to less
memory than a ``dp=2`` one. A failed check exits non-zero.
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
    pairs = [cs.start_multihost_ranks(*pair) for pair in cs.MULTIHOST_PAIRS]
    devices, _ = cs.mesh_devices()
    references = {}
    for spec, batch, steps in cs.MULTIHOST_PAIRS:
        engine.set_mesh(build_mesh(spec, devices))
        # the prompt encoded under this placement, as the ranks encode it
        # (the conditioning cache outlives set_mesh: ROADMAP 3d)
        engine._cond_cache.clear()
        body = {**cs.MESH_BODY, "batch_size": batch, "steps": steps}
        for arm in ("first", "warm"):
            t = time.perf_counter()
            references[spec] = engine.txt2img(
                GenerationPayload(**body)).images
            torch.cuda.synchronize()
            print(f"torch_multihost: the one-process {spec} reference at "
                  f"batch {batch}, {steps} steps ({arm}) took "
                  f"{time.perf_counter() - t:.3f} s [{card_line}]")
        engine.set_mesh(None)
    cs.check_multihost_memory(
        [cs.phase_multihost(pair, references[pair["spec"]], fa, card_line)
         for pair in pairs])
    print(f"torch_multihost: every phase passed in "
          f"{time.perf_counter() - t0:.1f} s [{card_line}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
