#!/usr/bin/env python3
"""Time the PyTorch port's config #1 in one checkout, for A/B runs on a GPU.

    python3 tools/torch_ab.py CHECKOUT [--requests 5] [--unet-calls 20]

Loads ``stable_diffusion_webui_distributed_tpu_torch`` from CHECKOUT (a
directory holding the port's package, e.g. a ``git archive`` of a parent
commit), builds SD1.5 on seeded weights with the bf16 card policy, and
prints one line ``AB {...}`` with the wall time of each warm request
(512x512, 20 steps Euler a, CFG 7, batch 1), the median and quartiles of a
warm UNet call (batch 2 = CFG, 64x64 latents), the number of aten ops one
UNet call dispatches, a hash of the request's first PNG, and a digest of
each stage (the weights, the text context, one UNet call, one decode),
which shows where two processes that should agree part ways. Two checkouts
are compared inside one call on one card, in turns (A, B, B, A): the host
clock varies from machine to machine.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkout")
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--unet-calls", type=int, default=20)
    args = ap.parse_args()
    root = os.path.abspath(args.checkout)
    sys.path.insert(0, root)

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    import stable_diffusion_webui_distributed_tpu_torch as port
    from stable_diffusion_webui_distributed_tpu_torch.bridge import init_seeded
    from stable_diffusion_webui_distributed_tpu_torch.models.configs import SD15
    from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import (
        Engine,
    )
    from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
        GenerationPayload,
    )
    from stable_diffusion_webui_distributed_tpu_torch.runtime import dtypes

    if not port.__file__.startswith(root + os.sep):
        raise SystemExit(f"loaded the port from {port.__file__}, not {root}")

    class CountOps(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[func.overloadpacket.__name__] += 1
            return func(*args, **(kwargs or {}))

    engine = Engine(SD15, init_seeded(SD15, 0, "cuda", torch.bfloat16),
                    policy=dtypes.CARD, device="cuda")
    payload = GenerationPayload(
        prompt="a photograph of an astronaut riding a horse",
        negative_prompt="blurry", steps=20, width=512, height=512,
        cfg_scale=7, sampler_name="Euler a", seed=1234)
    def digest(*tensors) -> str:
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().float().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    def weights_digest(module) -> str:
        return digest(*(v for _, v in sorted(module.state_dict().items())))

    first = engine.generate_range(payload)  # warm-up
    request_s = []
    for _ in range(args.requests):
        t0 = time.perf_counter()
        result = engine.generate_range(payload)
        torch.cuda.synchronize()
        request_s.append(time.perf_counter() - t0)

    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((2, 64, 64, 4), device="cuda", generator=gen)
    t = torch.full((2,), 500.0, device="cuda")
    ctx = torch.randn((2, 77, 768), device="cuda", generator=gen)
    torch.backends.cudnn.deterministic = True  # as the engine runs
    with torch.inference_mode():
        for _ in range(3):
            engine.unet(x, t, ctx)
        torch.cuda.synchronize()
        walls = []
        for _ in range(args.unet_calls):
            t0 = time.perf_counter()
            engine.unet(x, t, ctx)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        with CountOps() as count:
            unet_out = engine.unet(x, t, ctx)
        # where two processes part ways: one digest per stage of a request
        stages = {
            "weights": [weights_digest(m) for m in
                        (engine.text_encoder, engine.unet, engine.vae)],
            "context": digest(*engine.encode_prompts(payload)[0]),
            "unet_call": digest(unet_out),
            "decode": digest(engine.vae(x[:1])),
        }
    walls.sort()
    n = len(walls)
    print("AB " + json.dumps({
        "checkout": root,
        "request_s": request_s,
        "unet_ms_median": walls[n // 2],
        "unet_ms_quartiles": [walls[n // 4], walls[(3 * n) // 4]],
        "unet_aten_ops": sum(count.ops.values()),
        "unet_to_ops": count.ops["to"],
        "image_sha256": hashlib.sha256(
            result.images[0].encode()).hexdigest()[:16],
        "repeat_identical": result.images == first.images,
        "stage_sha256": stages,
        "card": torch.cuda.get_device_name(0),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
