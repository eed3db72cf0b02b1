#!/usr/bin/env python3
"""Which placed layers move a ``tp=2`` image away from meshless, on one
NVIDIA GPU.

    python3 tools/torch_tp_parts.py [--steps 10,30]

Builds the kernels and config #2's SDXL base engine on its seeded weights
(bf16 card policy, eager: no CUDA graph, so a variant never replays
another's capture) and runs ``chip_smoke.CONFIG2_MESH_BODY`` meshless, then
on ``tp=2`` over a virtual mesh on cuda:0 with every model placed, and
with one group of layers placed alone (the rest computing whole on the
home device): the text encoders and the VAE, the UNet, and of the UNet
its attention heads, its GEGLU halves, its convolutions, or its other
Dense layers. Beside them, the meshless request at batch 2, whose row 0
has the same seed: how far a batch size alone moves the image. Prints,
for each variant, its wall and the mean and max uint8 gap of its image
to the meshless one, at each of ``--steps`` (default 10 and the arm's
30).
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


#: each variant's placed layers: the UNet's by kind (``heads``,
#: ``halves``, ``conv``, ``dense``), and ``te_vae``: the text encoders'
#: and the VAE's
VARIANTS = {
    "every model": {"heads", "halves", "conv", "dense", "te_vae"},
    "the text encoders and the VAE alone": {"te_vae"},
    "the UNet alone": {"heads", "halves", "conv", "dense"},
    "the UNet's attention heads alone": {"heads"},
    "the UNet's GEGLU halves alone": {"halves"},
    "the UNet's convolutions alone": {"conv"},
    "the UNet's other Dense layers alone": {"dense"},
}


def keep_only(base, kinds) -> None:
    """Remove every placement of ``base``'s models but those of
    ``kinds``."""
    from stable_diffusion_webui_distributed_tpu_torch.models import (
        unet as unet_mod,
    )

    if "te_vae" not in kinds:
        for name in ("text_encoder", "text_encoder_2", "vae",
                     "vae_encoder"):
            if getattr(base, name) is not None:
                unet_mod.place_layers(getattr(base, name), None)
    for m in base.unet.modules():
        if isinstance(m, unet_mod.Attention) and "heads" not in kinds:
            m.tp = None
        elif isinstance(m, unet_mod.TransformerBlock) \
                and "halves" not in kinds:
            m.ffn_tp = None
        elif isinstance(m, unet_mod.Conv) and "conv" not in kinds:
            m.tp = None
        elif isinstance(m, unet_mod.Dense) and "dense" not in kinds:
            m.tp = None


def parts(base, body, devices) -> dict:
    """``{variant: (wall_s, mean_abs, max_abs)}`` on ``base``, each
    variant's image against the meshless one."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
        GenerationPayload,
    )
    from stable_diffusion_webui_distributed_tpu_torch.runtime.mesh import (
        build_mesh,
    )

    def request(**extra):
        torch.cuda.synchronize()
        t = time.perf_counter()
        result = base.txt2img(GenerationPayload(**{**body, **extra}))
        torch.cuda.synchronize()
        return time.perf_counter() - t, np.stack(
            [cs.png_pixels(b).astype(np.int32) for b in result.images])

    def gap(wall, got):
        diff = np.abs(got - plain)
        return round(wall, 4), round(float(diff.mean()), 4), int(diff.max())

    _, plain = request()
    wall, pair = request(batch_size=2)
    out = {"meshless at batch 2, row 0": gap(wall, pair[:1])}
    try:
        for variant, kinds in VARIANTS.items():
            base.set_mesh(build_mesh("tp=2", devices))
            keep_only(base, kinds)
            out[variant] = gap(*request())
    finally:
        base.set_mesh(None)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", default="10,30",
                        help="comma-separated step counts")
    args = parser.parse_args()
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
    from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
        BenchmarkPayload,
    )

    if not torch.cuda.is_available():
        print("torch_tp_parts: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card_line = cs.card()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{card_line}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    cs.phase_build(fa, ra)
    # config #2's base engine: the same seed, the card policy, eager
    params = init_seeded(SDXL_BASE, seed=0, device="cuda",
                         dtype=torch.bfloat16)
    base = Engine(SDXL_BASE, params, policy=dtypes.CARD, device="cuda",
                  cuda_graphs=False)
    del params
    bp = BenchmarkPayload()
    devices, kind = cs.mesh_devices()
    for steps in args.steps.split(","):
        body = {"prompt": bp.prompt, "negative_prompt": bp.negative_prompt,
                **cs.CONFIG2_MESH_BODY, "steps": int(steps)}
        for variant, (wall, mean, top) in parts(base, body,
                                                devices).items():
            what = variant if variant.startswith("meshless") else \
                f"tp=2 ({kind}) with {variant} placed"
            print(f"tp parts at {steps} steps: {what}: {wall} s, mean "
                  f"|diff| {mean} levels, max {top} against meshless "
                  f"[{card_line}]")
    print(f"torch_tp_parts: done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
