#!/usr/bin/env python3
"""FLOPs of the port's models, counted on meta tensors (no device needed).

    python3 tools/torch_flops.py [FAMILY [LATENT]]

Prints the TFLOP of one UNet row (one image, one CFG half), one ControlNet
row, one VAE decode and one VAE encode of FAMILY (default ``sd15``) at
LATENT x LATENT latents (default: 512 px over the family's VAE factor), as
``torch.utils.flop_counter`` counts matrix products and convolutions. The
counting is ``chip_smoke.py``'s ``model_tflop``, which the chip run reports
beside its timings; its UNet rows are the package's FLOP pricer
(``pipeline/stepcache.py`` ``unet_eval_flops``), the one the perf ledger's
MFU (``GET /internal/perf``) counts with.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    sys.path.insert(0, ROOT)
    from chip_smoke import model_tflop
    from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
        FAMILIES,
    )

    family = FAMILIES[argv[0] if argv else "sd15"]
    lat = int(argv[1]) if len(argv) > 1 else 512 // family.vae_scale_factor
    tflop = model_tflop(family, lat)
    print(json.dumps({"family": family.name, "latent": lat,
                      "tflop": {k: round(v, 4) for k, v in tflop.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
