#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (no phase is caught and passed over):

1. device: the card's name and power limit (``nvidia-smi``);
2. build: kernel K1 compiled with ``nvcc`` from the repository's source;
3. kernels: K1 held against its plain PyTorch version on the card at every
   shape and layout SD1.5 512x512 gives it, in f32 (TF32 off for matmul and
   cuDNN) and in bf16, and timed beside its plain version, PyTorch's
   ``scaled_dot_product_attention`` (a yardstick only; the port never calls
   it) and its bound;
4. main path: the port's ``ApiServer`` over SD1.5 at full width on seeded
   random weights (bf16 card policy) answers three ``POST
   /sdapi/v1/txt2img`` requests (512x512, 20 steps, Euler a, CFG 7); K1 must
   be launched 320 times per image group, repeats must be byte-identical and
   a batch's image 1 must carry image 0 of the next seed's init noise;
5. reference: one full-width UNet call on the bf16 card policy against the
   same weights on the f32 policy;
6. profile: where a warm request's time goes (device time by kernel group
   and the device's busy share, from ``torch.profiler``), and the same for
   one UNet call.

The last line of standard output is ``{"ok": true, "device": {...}}``; it is
printed only when every phase passed. Without a CUDA device, or without the
rest of the repository beside this file, the script exits non-zero.
"""

from __future__ import annotations

import base64
import io
import json
import os
import subprocess
import sys
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense): bf16 tensor cores,
# f32 outside the tensor cores, HBM3 bandwidth. The exp rate is the MUFU
# throughput of compute capability 9.0 (16 results per clock per SM, CUDA
# C++ Programming Guide, arithmetic instruction throughput) x 132 SMs x the
# 1.98 GHz boost clock.
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
PEAK_BYTES = 3.35e12
PEAK_EXP = 16 * 132 * 1.98e9

# (B, T, H, D) of K1 at SD1.5 512x512 with CFG, and launches per UNet call
MAIN_SHAPES = [((2, 4096, 8, 40), 5), ((2, 1024, 8, 80), 5),
               ((2, 256, 8, 160), 5), ((2, 64, 8, 160), 1)]
EXTRA_SHAPES = [(1, 1000, 8, 64)]  # ragged edges, head dim 64
TOLERANCE = {"f32": 2e-5, "bf16": 1e-2}  # max abs error vs the plain version

LAUNCHES_PER_GROUP = 16 * 20  # 16 per UNet call x 20 steps


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(shape, dtype_name: str):
    """The least time for one call: q, k, v read once and o written once
    over the memory rate, or the two products' FLOPs over the peak rate of
    their type, whichever is larger. Also returns the time of the softmax's
    exps on the MUFUs, which the published-peak bound leaves out."""
    b, t, h, d = shape
    elem = 2 if dtype_name == "bf16" else 4
    t_bytes = 4 * b * t * h * d * elem / PEAK_BYTES
    t_flops = 4 * b * h * t * t * d / PEAK_FLOPS[dtype_name]
    t_exp = b * h * t * t / PEAK_EXP
    by = "bytes" if t_bytes >= t_flops else "operations"
    return 1e3 * max(t_bytes, t_flops), by, 1e3 * t_exp


def phase_kernels(fa):
    import torch
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
              "exp_ms": 0.0}
    max_err = 0.0
    bound_by = set()
    for shape, calls in MAIN_SHAPES + [(s, 0) for s in EXTRA_SHAPES]:
        b, t, h, d = shape
        for name, dtype in dtypes.items():
            # column slices of one fused QKV projection, as the UNet
            # hands them to K1
            qkv = torch.randn((b, t, 3 * h * d), device="cuda",
                              generator=gen).to(dtype)
            q, k, v = (x.unflatten(-1, (h, d))
                       for x in qkv.split(h * d, dim=-1))
            out = fa.flash_attention(q, k, v)
            torch.cuda.synchronize()
            ref = fa.flash_attention_reference(q, k, v)
            err = (out.float() - ref.float()).abs().max().item()
            print(f"kernel flash_attention {shape} {name}: max_abs_err "
                  f"{err:.3g} (tolerance {TOLERANCE[name]:g})")
            check(err <= TOLERANCE[name],
                  f"flash_attention {shape} {name} disagrees with the plain "
                  f"version: {err}")
            if name != "bf16" or calls == 0:
                continue
            max_err = max(max_err, err)
            iters = 20
            ms = cuda_ms(lambda: fa.flash_attention(q, k, v), iters)
            plain = cuda_ms(lambda: fa.flash_attention_reference(q, k, v),
                            iters)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                          iters)
            bms, by, exp_ms = bound_ms(shape, name)
            bound_by.add(by)
            print(f"kernel flash_attention {shape} bf16 per call: ms {ms:.4f}"
                  f" plain_ms {plain:.4f} library_ms {lib:.4f} bound_ms "
                  f"{bms:.4f} ({by}) exp_ms {exp_ms:.4f} x{calls} per UNet "
                  f"call")
            totals["ms"] += calls * ms
            totals["plain_ms"] += calls * plain
            totals["library_ms"] += calls * lib
            totals["bound_ms"] += calls * bms
            totals["exp_ms"] += calls * exp_ms
    return totals, max_err, ("operations" if "operations" in bound_by
                             else "bytes")


def post(port: int, body: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/sdapi/v1/txt2img",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        check(resp.status == 200, f"txt2img answered {resp.status}")
        return json.loads(resp.read())


def png_pixels(b64: str):
    import numpy as np
    from PIL import Image

    img = Image.open(io.BytesIO(base64.b64decode(b64)))
    return np.asarray(img.convert("RGB"))


def phase_main_path(fa, card_line: str):
    import numpy as np
    import torch

    from stable_diffusion_webui_distributed_tpu_torch.bridge import (
        init_seeded,
    )
    from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
        SD15,
    )
    from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import (
        Engine,
    )
    from stable_diffusion_webui_distributed_tpu_torch.runtime import (
        dtypes,
        rng,
    )
    from stable_diffusion_webui_distributed_tpu_torch.server.api import (
        ApiServer,
    )

    t0 = time.perf_counter()
    params = init_seeded(SD15, seed=0, device="cuda", dtype=torch.bfloat16)
    engine = Engine(SD15, params, policy=dtypes.CARD, device="cuda")
    del params
    print(f"main path: SD1.5 engine on seeded weights in "
          f"{time.perf_counter() - t0:.2f} s")
    base = {"prompt": "a photograph of an astronaut riding a horse",
            "negative_prompt": "blurry", "steps": 20, "width": 512,
            "height": 512, "cfg_scale": 7, "sampler_name": "Euler a"}
    server = ApiServer(engine, port=0).start()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.flash_attention.launches = 0
        runs = {}
        for tag, extra in (("a", {"seed": 1234, "batch_size": 1}),
                           ("b", {"seed": 1234, "batch_size": 1}),
                           ("c", {"seed": 1233, "batch_size": 2})):
            before = fa.flash_attention.launches
            t = time.perf_counter()
            resp = post(server.port, {**base, **extra})
            runs[tag] = (time.perf_counter() - t, resp,
                         fa.flash_attention.launches - before)
        peak = torch.cuda.max_memory_allocated()
        total_launches = fa.flash_attention.launches
    finally:
        server.stop()

    for tag, (lat, resp, launches) in runs.items():
        print(f"main path request ({tag}): latency {lat:.3f} s, "
              f"{len(resp['images'])} image(s), K1 launches {launches} "
              f"[{card_line}]")
        check(launches == LAUNCHES_PER_GROUP,
              f"request ({tag}) launched K1 {launches} times, want "
              f"{LAUNCHES_PER_GROUP}")
    a, b, c = (runs[t][1] for t in "abc")
    check(len(a["images"]) == 1 and len(c["images"]) == 2,
          "wrong image counts")
    check(json.loads(c["info"])["all_seeds"] == [1233, 1234],
          "batch seeds are not [1233, 1234]")
    check(a["images"][0] == b["images"][0],
          "a repeated request gave other image bytes")
    px_a, px_c1 = png_pixels(a["images"][0]), png_pixels(c["images"][1])
    for px in (px_a, png_pixels(c["images"][0]), px_c1):
        check(px.shape == (512, 512, 3), f"image shape {px.shape}")
        check(float(px.std()) > 1.0, "an image is (near) constant")
    noise_c = rng.batch_noise(1233, 0, 0.0, 0, 2, (64, 64, 4), device="cuda")
    noise_a = rng.batch_noise(1234, 0, 0.0, 0, 1, (64, 64, 4), device="cuda")
    check(torch.equal(noise_c[1], noise_a[0]),
          "image 1 of seed 1233 does not carry seed 1234's init noise")
    diff = np.abs(px_a.astype(np.int32) - px_c1.astype(np.int32))
    print(f"main path: batch-2 image 1 vs batch-1 image: mean abs "
          f"{diff.mean():.4f}, max {diff.max()} (uint8 levels)")
    check(diff.mean() <= 2.0,
          "batch-2 image 1 drifted from the batch-1 image of its seed")
    lat_warm = runs["b"][0]
    metrics = {"latency_s": {t: round(runs[t][0], 4) for t in "abc"},
               "images_per_minute_batch1": round(60.0 / lat_warm, 3),
               "peak_memory_gib": round(peak / 2**30, 3),
               "k1_launches": total_launches, "card": card_line}
    print("main path metrics: " + json.dumps(metrics))
    return engine, total_launches


def phase_reference(engine) -> None:
    """One full-width UNet call, bf16 card policy vs the f32 policy on the
    same weights (the UNet's f32 path runs K1 in f32)."""
    import torch

    from stable_diffusion_webui_distributed_tpu_torch.models.unet import UNet

    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((2, 32, 32, 4), device="cuda", generator=gen)
    t = torch.tensor([999.0, 500.0], device="cuda")
    ctx = torch.randn((2, 77, 768), device="cuda", generator=gen)
    with torch.device("meta"):
        f32 = UNet(engine.family.unet)
    f32 = f32.to_empty(device="cuda")
    f32.load_state_dict(engine.unet.state_dict())
    with torch.inference_mode():
        out16 = engine.unet(x, t, ctx)
        out32 = f32.float()(x, t, ctx)
    check(tuple(out16.shape) == (2, 32, 32, 4), f"UNet shape {out16.shape}")
    check(bool(torch.isfinite(out16).all()), "UNet output is not finite")
    rel = ((out16 - out32).norm() / out32.norm()).item()
    print(f"reference: full-width UNet bf16 vs f32 relative error {rel:.4g}"
          f" (tolerance 5e-2)")
    check(rel <= 5e-2, "the bf16 UNet disagrees with the f32 UNet")


# kernel-name fragments -> group, first match wins (cuDNN's convolutions are
# xmma kernels too, so they are matched before the GEMMs)
KERNEL_GROUPS = (
    ("K1 flash_attention", ("attn_fwd",)),
    ("SDPA (cross-attention)", ("sdpa", "flash_fwd", "fmha", "attention")),
    ("convolution", ("fprop", "conv", "implicit")),
    ("GEMM", ("gemm", "nvjet", "xmma", "cutlass")),
    ("norm", ("norm", "welford")),
)


def device_groups(prof, runs: int) -> dict:
    """Device time (ms per run) by kernel group from a profiler trace."""
    groups: dict = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if not us:
            continue
        name = ev.key.lower()
        group = next((g for g, frags in KERNEL_GROUPS
                      if any(f in name for f in frags)),
                     "elementwise and other")
        groups[group] = groups.get(group, 0.0) + us / runs / 1e3
    return groups


def print_groups(what: str, wall_ms: float, groups: dict,
                 card_line: str) -> None:
    busy = sum(groups.values())
    print(f"profile: {what} {wall_ms:.3f} ms, device busy {busy:.3f} ms "
          f"({busy / wall_ms:.1%}) [{card_line}]")
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"profile:   {group}: {ms:.3f} ms ({ms / wall_ms:.1%})")


def phase_profile(engine, card_line: str) -> None:
    """Where a request's time goes. One warm request (config #1, batch 1)
    on the host clock, traced with ``torch.profiler``: device time by
    kernel group and the share of the request the device was busy. Then one
    warm UNet call (batch 2 = CFG at 512x512) the same way, timed with CUDA
    events, and the text encoder and the VAE decode timed alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
        GenerationPayload,
    )

    payload = GenerationPayload(
        prompt="a photograph of an astronaut riding a horse",
        negative_prompt="blurry", steps=20, width=512, height=512,
        cfg_scale=7, sampler_name="Euler a", seed=1234)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.generate_range(payload)
        torch.cuda.synchronize()
        request_ms = 1e3 * (time.perf_counter() - t0)
    print_groups("request (config #1, batch 1, 20 steps)", request_ms,
                 device_groups(prof, 1), card_line)

    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((2, 64, 64, 4), device="cuda", generator=gen)
    t = torch.full((2,), 500.0, device="cuda")
    ctx = torch.randn((2, 77, 768), device="cuda", generator=gen)
    lat = torch.randn((1, 64, 64, 4), device="cuda", generator=gen)
    ids = torch.randint(0, 49408, (1, 77), device="cuda", generator=gen)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # as the engine runs
    with torch.inference_mode():
        unet_ms = cuda_ms(lambda: engine.unet(x, t, ctx), 5)
        text_ms = cuda_ms(lambda: engine.text_encoder(ids), 5)
        decode_ms = cuda_ms(lambda: engine.vae(lat / 0.18215), 3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                engine.unet(x, t, ctx)
            torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = prev
    print_groups("UNet call (batch 2 = CFG, 64x64 latents)", unet_ms,
                 device_groups(prof, 3), card_line)
    print(f"profile: text encoder (1 x 77 tokens) {text_ms:.3f} ms, VAE "
          f"decode (1 x 512x512, f32) {decode_ms:.3f} ms [{card_line}]")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from stable_diffusion_webui_distributed_tpu_torch.ops import (
        flash_attention as fa,
    )

    kind = torch.cuda.get_device_name(0)
    card_line = card()
    print(f"device: {kind}; nvidia-smi: {card_line}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _, log = fa.build()
    regs = [int(w) for line in log.splitlines() if "registers" in line
            for w in [line.split("Used ")[1].split(" ")[0]]]
    spills = sum("0 bytes spill stores" not in line
                 for line in log.splitlines() if "spill stores" in line)
    print(f"build: flash_attention in {time.perf_counter() - t0:.2f} s, "
          f"{len(regs)} kernels, max {max(regs, default=0)} registers, "
          f"{spills} with spills")

    totals, max_err, bound_by = phase_kernels(fa)
    engine, launches = phase_main_path(fa, card_line)
    phase_reference(engine)
    phase_profile(engine, card_line)

    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "stable_diffusion_webui_distributed_tpu_torch/csrc/"
                  "flash_attention.cu",
        "replaces": "stable_diffusion_webui_distributed_tpu/ops/"
                    "flash_attention.py:30",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": round(totals["ms"], 4),
        "plain_ms": round(totals["plain_ms"], 4),
        "bound_ms": round(totals["bound_ms"], 4),
        "bound_by": bound_by,
        "library_ms": round(totals["library_ms"], 4),
        "exp_ms": round(totals["exp_ms"], 4),
        "per": "one UNet call of SD1.5 512x512 with CFG (16 launches), bf16",
    }]
    print(json.dumps({"kernels": kernels}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
