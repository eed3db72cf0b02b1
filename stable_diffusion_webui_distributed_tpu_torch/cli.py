"""Command line: serve the sdapi-v1 node on the port's engine.

    python -m stable_diffusion_webui_distributed_tpu_torch.cli serve \\
        --family sd15 --port 7860

Weights are seeded random weights (``bridge.init_seeded``) until a
checkpoint loader is ported; the fallback tokenizer stands in for CLIP's
vocabulary. Runs on ``cuda`` with the card policy (bf16) unless
``--device cpu`` is given (f32 there).
"""

from __future__ import annotations

import argparse
import logging
from typing import Optional

from stable_diffusion_webui_distributed_tpu_torch import bridge
from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
    FAMILIES,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import (
    Engine,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import dtypes
from stable_diffusion_webui_distributed_tpu_torch.server.api import ApiServer


def cmd_serve(args) -> int:
    device = dtypes.resolve_device(args.device)
    policy = dtypes.CARD if device.type == "cuda" else dtypes.F32
    family = FAMILIES[args.family]
    params = bridge.init_seeded(family, args.seed, device,
                                policy.param_dtype)
    engine = Engine(family, params, policy=policy, device=device)
    ApiServer(engine, host=args.listen, port=args.port).serve_forever()
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="stable_diffusion_webui_distributed_tpu_torch.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("serve", help="run the sdapi-v1 node server")
    s.add_argument("--family", default="sd15", choices=sorted(FAMILIES))
    s.add_argument("--listen", default="127.0.0.1")
    s.add_argument("--port", type=int, default=7860)
    s.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights")
    s.add_argument("--device", default=None,
                   help="torch device (default: cuda; raises without one)")
    s.set_defaults(fn=cmd_serve)
    return ap


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
