#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (no phase is caught and passed over):

1. device: the card's name and power limit (``nvidia-smi``);
2. build: kernels K1 and K2 compiled with ``nvcc`` from the repository's
   sources, one compiler per source, started together; registers, spills
   and any serialised ``wgmma`` of the Hopper instantiations reported (from
   ``ptxas -v``), and the shared memory each takes at its launch (from the
   profiler's trace of one launch of each);
3. kernels: K1 held against its plain PyTorch version on the card at every
   shape and layout SD1.5 512x512 gives it, in f32 (TF32 off for matmul and
   cuDNN) and in bf16, and timed beside its plain version, PyTorch's
   ``scaled_dot_product_attention`` (a yardstick only; the port never calls
   it) and its bound: back-to-back eager launches (``ms``) and the device
   time of a replayed CUDA graph of them (``device_ms``), the fraction of
   the bound each reaches, the exps' share and the wrapper's host time per
   launch; every bf16 launch must report the Hopper path (TMA + wgmma);
4. ragged kernels: K2 the same way at every shape and length the ragged
   serving phase gives it (self-attention and cross-attention), timed
   beside its plain version and SDPA with a boolean key mask (a yardstick
   that leaves the padded query rows un-zeroed), its bound counted on the
   valid work only;
5. main path: the port's ``ApiServer`` over SD1.5 at full width on seeded
   random weights (bf16 card policy) answers three ``POST
   /sdapi/v1/txt2img`` requests (512x512, 20 steps, Euler a, CFG 7) through
   its serving dispatcher (512x512 is an exact bucket hit); K1 must be
   launched 320 times per image group and K2 never, repeats must be
   byte-identical and a batch's image 1 must carry image 0 of the next
   seed's init noise; every K1 launch must take the Hopper path;
6. ragged serving: the same server with ``SDTPU_RAGGED=1`` on a 512x768
   bucket gets three concurrent requests of 512x512, 512x640 and 512x768;
   they must run as ONE dispatch, launch K2 640 times (32 per UNet call x
   20 steps, all on the Hopper path) and K1 never, come back at their
   sizes, and agree with each request sent alone within a mean of 2 uint8
   levels;
7. reference: one full-width UNet call on the bf16 card policy against the
   same weights on the f32 policy;
8. profile: where a warm request's time goes (device time by kernel group
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
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

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

# The ragged serving phase: three requests on one 512x768 bucket, the group
# padded to batch 4 (the last row repeated), CFG doubling it to 8 rows.
# Latent rows per level (ceil-halved) of 512x512, 512x640 and 512x768.
RAGGED_SIZES = [(512, 512), (512, 640), (512, 768)]
RAGGED_ROWS = [64, 80, 96, 96]
# the first request's prompt runs past 75 tokens: 2 chunks, 154 context
# tokens in the group; the others and every negative prompt take 77
RAGGED_CTX = [77, 77, 77, 77, 154, 77, 77, 77]  # [uncond rows; cond rows]
K2_LAUNCHES = 32 * 20  # 16 self + 16 cross per UNet call x 20 steps
RAGGED_MEAN_TOLERANCE = 2.0  # uint8 levels, coalesced vs solo


def ragged_shapes():
    """(shape (B,T,H,D), S, lengths, mask_queries, calls per UNet call) of
    every K2 launch of one ragged UNet call: levels 0-2 five each, the mid
    block one, self-attention then cross-attention."""
    out = []
    for level, (d, calls) in enumerate([(40, 5), (80, 5), (160, 5),
                                        (160, 1)]):
        rows = list(RAGGED_ROWS)
        for _ in range(level):
            rows = [(r + 1) // 2 for r in rows]
        width = 64 >> level
        t = 96 * 64 >> (2 * level)
        out.append(((8, t, 8, d), t, [r * width for r in rows] * 2, True,
                    calls))
        out.append(((8, t, 8, d), 154, RAGGED_CTX, False, calls))
    return out


# the bf16 design of both kernels, as the kernels line names it
DESIGN = ("csrc/attention_sm90.cuh: TMA (5-D maps, no swizzle) into a "
          "4-5 stage mbarrier ring from one producer warp; 2 consumer "
          "warpgroups (1 where T <= 256) on wgmma m64nNk16 for QK^T "
          "(smem x smem) and PV (P in registers, V MN-major); QK^T(j) and "
          "PV(j-1) issued before the softmax of tile j; ping-pong of the "
          "consumers at D >= 64; softmax max on raw scores, scale folded "
          "into one FFMA per ex2.approx.ftz; row sums from a ones column "
          "in V at D % 16 == 8; setmaxnreg 40/232")


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


def graph_ms(fn, iters: int) -> float:
    """Device time per call with the host's launch overhead taken out:
    ``iters`` calls captured in one CUDA graph, replayed three times
    between CUDA events. (Back-to-back eager launches, ``cuda_ms``, time
    the host instead wherever it takes longer than the kernel.)"""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (3 * iters)


def host_us(fn, iters: int = 50, windows: int = 5) -> float:
    """The wrapper's host time per launch: the median over ``windows``
    windows of ``iters`` launches enqueued back to back on the host clock
    (the device is not waited for inside a window; it is synchronised
    before each). The median damps the noise of a host shared with other
    machines' work."""
    import statistics

    import torch

    fn()
    per = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        per.append((time.perf_counter() - t0) / iters)
    torch.cuda.synchronize()
    return 1e6 * statistics.median(per)


def shape_line(ms: float, device_ms: float, bms: float, exp_ms: float,
               us: float) -> str:
    return (f"fraction of bound {bms / ms:.3f} (device {bms / device_ms:.3f})"
            f", exps share {exp_ms / device_ms:.3f} of device time, host "
            f"{us:.1f} us per launch")


def launched_path(wrapper, call):
    """Runs ``call`` once; returns its output and the path on which
    ``wrapper`` counted its one launch (the path its C entry point
    reported)."""
    before = dict(wrapper.path_launches)
    out = call()
    grown = [p for p, n in wrapper.path_launches.items() if n != before[p]]
    check(len(grown) == 1 and wrapper.path_launches[grown[0]]
          == before[grown[0]] + 1,
          f"{wrapper.__name__}: one call counted launches on {grown}")
    return out, grown[0]


# totals of one kernel per UNet call: eager and device ms of the kernel and
# of SDPA, the plain version's ms, the bound and the exps' time
TOTALS = ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
          "bound_ms", "exp_ms")


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


def ragged_bound_ms(shape, s_len: int, lens, mask_q: bool,
                    dtype_name: str):
    """``bound_ms`` on the valid work: the valid q, k and v rows read once
    and the whole o written once, and sum over rows of valid queries x
    valid keys for the FLOPs and the exps."""
    b, t, h, d = shape
    elem = 2 if dtype_name == "bf16" else 4
    kv = [min(n, s_len) for n in lens]
    qv = [min(n, t) if mask_q else t for n in lens]
    pairs = sum(q * k for q, k in zip(qv, kv))
    t_bytes = elem * h * d * (sum(qv) + 2 * sum(kv) + b * t) / PEAK_BYTES
    t_flops = 4 * h * d * pairs / PEAK_FLOPS[dtype_name]
    t_exp = h * pairs / PEAK_EXP
    by = "bytes" if t_bytes >= t_flops else "operations"
    return 1e3 * max(t_bytes, t_flops), by, 1e3 * t_exp


def phase_ragged_kernels(ra):
    """K2 against its plain version in f32 and bf16 at every launch of one
    ragged UNet call, then timed (bf16) beside its plain version and SDPA
    with a boolean key mask."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(3)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    totals = dict.fromkeys(TOTALS, 0.0)
    max_err = {"f32": 0.0, "bf16": 0.0}
    bound_by = set()
    host = []
    for shape, s_len, lens, mask_q, calls in ragged_shapes():
        b, t, h, d = shape
        kind = "self" if mask_q else "cross"
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q_true = lengths if mask_q else None
        for name, dtype in dtypes.items():
            # as the UNet hands them to K2: self-attention reads column
            # slices of the fused QKV projection, cross-attention a q
            # projection and slices of the fused KV projection
            if mask_q:
                qkv = torch.randn((b, t, 3 * h * d), device="cuda",
                                  generator=gen).to(dtype)
                q, k, v = (x.unflatten(-1, (h, d))
                           for x in qkv.split(h * d, dim=-1))
            else:
                q = torch.randn((b, t, h, d), device="cuda",
                                generator=gen).to(dtype)
                kv = torch.randn((b, s_len, 2 * h * d), device="cuda",
                                 generator=gen).to(dtype)
                k, v = (x.unflatten(-1, (h, d))
                        for x in kv.split(h * d, dim=-1))
            out, path = launched_path(ra.ragged_attention, lambda: (
                ra.ragged_attention(q, k, v, lengths, mask_queries=mask_q)))
            torch.cuda.synchronize()
            want = "hopper" if name == "bf16" else "f32"
            check(path == want, f"ragged_attention {shape} {kind} {name} "
                  f"took the {path} path, want {want}")
            ref = ra.ragged_attention_reference(q, k, v, lengths,
                                                q_true_len=q_true)
            err = (out.float() - ref.float()).abs().max().item()
            print(f"kernel ragged_attention {shape} S={s_len} {kind} "
                  f"{name}: max_abs_err {err:.3g} (tolerance "
                  f"{TOLERANCE[name]:g})")
            check(err <= TOLERANCE[name],
                  f"ragged_attention {shape} {kind} {name} disagrees with "
                  f"the plain version: {err}")
            max_err[name] = max(max_err[name], err)
            del ref
            if name != "bf16":
                continue

            def call():
                return ra.ragged_attention(q, k, v, lengths,
                                           mask_queries=mask_q)

            ms = cuda_ms(call, 20)
            dev = graph_ms(call, 20)
            us = host_us(call)
            host.append(us)
            plain = cuda_ms(lambda: ra.ragged_attention_reference(
                q, k, v, lengths, q_true_len=q_true), 5)
            mask = (torch.arange(s_len, device="cuda")[None, :]
                    < lengths[:, None])[:, None, None, :]
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=mask)

            lib = cuda_ms(sdpa, 20)
            lib_dev = graph_ms(sdpa, 20)
            bms, by, exp_ms = ragged_bound_ms(shape, s_len, lens, mask_q,
                                              name)
            bound_by.add(by)
            print(f"kernel ragged_attention {shape} S={s_len} {kind} bf16 "
                  f"per call: ms {ms:.4f} (device {dev:.4f}) plain_ms "
                  f"{plain:.4f} library_ms {lib:.4f} (device "
                  f"{lib_dev:.4f}) bound_ms {bms:.4f} ({by}) exp_ms "
                  f"{exp_ms:.4f} x{calls} per ragged UNet call; "
                  f"{shape_line(ms, dev, bms, exp_ms, us)}")
            for key, val in zip(TOTALS, (ms, dev, plain, lib, lib_dev, bms,
                                         exp_ms)):
                totals[key] += calls * val
    totals["host_us"] = sum(host) / len(host)
    return totals, max_err, ("operations" if "operations" in bound_by
                             else "bytes")


def phase_kernels(fa):
    import torch
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    totals = dict.fromkeys(TOTALS, 0.0)
    max_err = 0.0
    bound_by = set()
    host = []
    for shape, calls in MAIN_SHAPES + [(s, 0) for s in EXTRA_SHAPES]:
        b, t, h, d = shape
        for name, dtype in dtypes.items():
            # column slices of one fused QKV projection, as the UNet
            # hands them to K1
            qkv = torch.randn((b, t, 3 * h * d), device="cuda",
                              generator=gen).to(dtype)
            q, k, v = (x.unflatten(-1, (h, d))
                       for x in qkv.split(h * d, dim=-1))
            out, path = launched_path(fa.flash_attention,
                                      lambda: fa.flash_attention(q, k, v))
            torch.cuda.synchronize()
            want = "hopper" if name == "bf16" else "f32"
            check(path == want, f"flash_attention {shape} {name} took the "
                  f"{path} path, want {want}")
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
            dev = graph_ms(lambda: fa.flash_attention(q, k, v), iters)
            us = host_us(lambda: fa.flash_attention(q, k, v))
            host.append(us)
            plain = cuda_ms(lambda: fa.flash_attention_reference(q, k, v),
                            iters)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            lib = cuda_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt), iters)
            lib_dev = graph_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt), iters)
            bms, by, exp_ms = bound_ms(shape, name)
            bound_by.add(by)
            print(f"kernel flash_attention {shape} bf16 per call: ms {ms:.4f}"
                  f" (device {dev:.4f}) plain_ms {plain:.4f} library_ms "
                  f"{lib:.4f} (device {lib_dev:.4f}) bound_ms "
                  f"{bms:.4f} ({by}) exp_ms {exp_ms:.4f} x{calls} per UNet "
                  f"call; {shape_line(ms, dev, bms, exp_ms, us)}")
            for key, val in zip(TOTALS, (ms, dev, plain, lib, lib_dev, bms,
                                         exp_ms)):
                totals[key] += calls * val
    totals["host_us"] = sum(host) / len(host)
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


def phase_main_path(fa, ra, card_line: str):
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
    from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
        METRICS,
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
        check(server.dispatcher is not None, "the server has no dispatcher")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        METRICS.clear()
        fa.reset_launches(fa.flash_attention)
        fa.reset_launches(ra.ragged_attention)
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
        paths = dict(fa.flash_attention.path_launches)
        k2_launches = ra.ragged_attention.launches
    finally:
        server.stop()
    serving = METRICS.summary()
    print(f"main path dispatcher: {json.dumps(serving)}")
    check(serving["dispatches"] == 3 and serving["bucket_hits"] == 3,
          "the main path did not run as three exact-bucket dispatches")
    check(k2_launches == 0, f"the main path launched K2 {k2_launches} times")
    print(f"main path: K1 launches by path {json.dumps(paths)}")
    check(paths["hopper"] == total_launches,
          f"K1 launches off the Hopper path on the main path: {paths}")

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
               "k1_launches": total_launches, "k2_launches": k2_launches,
               "k1_path_launches": paths, "card": card_line}
    print("main path metrics: " + json.dumps(metrics))
    return engine, total_launches, paths


RAGGED_ENV = {"SDTPU_RAGGED": "1", "SDTPU_RAGGED_LADDER": "512x768",
              "SDTPU_BATCH_LADDER": "1,2,4,8",
              "SDTPU_COALESCE_WINDOW": "0.5"}


def phase_ragged_serving(engine, fa, ra, card_line: str) -> int:
    """Three concurrent requests of three heights on one ragged 512x768
    bucket through the port's server; returns K2's launches in them."""
    import numpy as np
    import torch

    from stable_diffusion_webui_distributed_tpu_torch.server.api import (
        ApiServer,
    )
    from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
        METRICS,
    )

    long_prompt = ", ".join(["a photograph of an astronaut riding a horse"]
                            * 10)
    bodies = [{"prompt": long_prompt if i == 0 else
               f"a photograph of an astronaut riding a horse, view {i}",
               "negative_prompt": "blurry", "steps": 20, "width": w,
               "height": h, "cfg_scale": 7, "sampler_name": "Euler a",
               "seed": 1234 + i} for i, (w, h) in enumerate(RAGGED_SIZES)]
    results, latency, errors = [None] * 3, [0.0] * 3, []

    def send(i):
        try:
            t = time.perf_counter()
            results[i] = post(server.port, bodies[i])
            latency[i] = time.perf_counter() - t
        except Exception as e:  # noqa: BLE001 — fails the phase below
            errors.append(e)

    # the ladders are read when the server is made, the ragged knobs on
    # every request: all of them stay set for the whole phase
    saved = {k: os.environ.get(k) for k in RAGGED_ENV}
    os.environ.update(RAGGED_ENV)
    server = None
    try:
        server = ApiServer(engine, port=0).start()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        METRICS.clear()
        fa.reset_launches(fa.flash_attention)
        fa.reset_launches(ra.ragged_attention)
        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(3)]
        for th in threads:  # in order, well inside the coalesce window
            th.start()
            time.sleep(0.05)
        for th in threads:
            th.join()
        k1, k2 = fa.flash_attention.launches, ra.ragged_attention.launches
        paths = dict(ra.ragged_attention.path_launches)
        peak = torch.cuda.max_memory_allocated()
        serving = METRICS.summary()
        check(not errors, f"a ragged request failed: {errors}")
        solo = []
        for body in bodies:
            t = time.perf_counter()
            solo.append((post(server.port, body), time.perf_counter() - t))
        solo_k2 = ra.ragged_attention.launches - k2
    finally:
        if server is not None:
            server.stop()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    print(f"ragged serving dispatcher: {json.dumps(serving)}")
    print(f"ragged serving: K2 launches {k2}, K1 launches {k1}; solo runs: "
          f"K2 launches {solo_k2} [{card_line}]")
    check(serving["dispatches"] == 1 and serving["coalesced_requests"] == 3,
          "the three ragged requests did not run as one dispatch")
    check(k2 == K2_LAUNCHES, f"K2 launched {k2} times, want {K2_LAUNCHES}")
    check(k1 == 0, f"K1 launched {k1} times in the ragged phase")
    print(f"ragged serving: K2 launches by path {json.dumps(paths)}")
    check(paths["hopper"] == k2,
          f"K2 launches off the Hopper path in the ragged phase: {paths}")
    check(solo_k2 == 3 * K2_LAUNCHES, f"solo runs launched K2 {solo_k2} "
          f"times, want {3 * K2_LAUNCHES}")
    diffs = []
    for i, (w, h) in enumerate(RAGGED_SIZES):
        resp, (solo_resp, solo_lat) = results[i], solo[i]
        info = json.loads(resp["info"])
        check(info["all_seeds"] == [1234 + i], f"request {i} seeds")
        check(f"Size: {w}x{h}" in info["infotexts"][0],
              f"request {i} infotext lacks Size: {w}x{h}")
        px, px_solo = (png_pixels(r["images"][0]) for r in (resp,
                                                           solo_resp))
        check(px.shape == px_solo.shape == (h, w, 3),
              f"request {i} image shape {px.shape}, solo {px_solo.shape}")
        check(float(px.std()) > 1.0, f"request {i} image is (near) constant")
        diff = np.abs(px.astype(np.int32) - px_solo.astype(np.int32))
        diffs.append(float(diff.mean()))
        print(f"ragged serving request {w}x{h}: coalesced latency "
              f"{latency[i]:.3f} s, solo latency {solo_lat:.3f} s; "
              f"coalesced vs solo mean abs {diff.mean():.4f}, max "
              f"{diff.max()} (uint8 levels) [{card_line}]")
        check(diff.mean() <= RAGGED_MEAN_TOLERANCE,
              f"request {i}: coalesced image drifted from its solo run")
    metrics = {"latency_s": [round(x, 4) for x in latency],
               "solo_latency_s": [round(x[1], 4) for x in solo],
               "coalesced_vs_solo_mean_abs": [round(x, 4) for x in diffs],
               "peak_memory_gib": round(peak / 2**30, 3),
               "k2_launches": k2, "k1_launches": k1,
               "k2_path_launches": paths, "card": card_line}
    print("ragged serving metrics: " + json.dumps(metrics))
    return k2, paths


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
    ("K2 ragged_attention", ("ragged_fwd",)),
    ("SDPA (cross-attention)", ("sdpa", "flash_fwd", "fmha", "attention")),
    ("convolution", ("fprop", "conv", "implicit")),
    ("GEMM", ("gemm", "nvjet", "xmma", "cutlass")),
    ("norm", ("norm", "welford")),
)


def kernel_group(name: str) -> str:
    """A kernel's group by its name. K1 and K2 share the Hopper mainloop
    ``attn_sm90<DP, NC, ragged>``: its last template argument tells them
    apart (``false``/``Lb0E`` is K1)."""
    name = name.lower()
    if "attn_sm90" in name:
        ragged = ", true>" in name or "lb1e" in name
        return "K2 ragged_attention" if ragged else "K1 flash_attention"
    return next((g for g, frags in KERNEL_GROUPS
                 if any(f in name for f in frags)), "elementwise and other")


def device_groups(prof, runs: int) -> dict:
    """Device time (ms per run) by kernel group from a profiler trace."""
    groups: dict = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if not us:
            continue
        group = kernel_group(ev.key)
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
    events, one warm ragged UNet call as the ragged serving phase makes it
    (batch 8 = 4 rows with CFG on the 512x768 bucket), and the text encoder
    and the VAE decode timed alone."""
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
    xr = torch.randn((8, 96, 64, 4), device="cuda", generator=gen)
    tr = torch.full((8,), 500.0, device="cuda")
    ctxr = torch.randn((8, 154, 768), device="cuda", generator=gen)
    ragged = {"true_rows": torch.tensor(RAGGED_ROWS * 2, device="cuda"),
              "ctx_true": torch.tensor(RAGGED_CTX, device="cuda")}
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # as the engine runs
    with torch.inference_mode():
        unet_ms = cuda_ms(lambda: engine.unet(x, t, ctx), 5)
        ragged_ms = cuda_ms(lambda: engine.unet(xr, tr, ctxr, **ragged), 5)
        text_ms = cuda_ms(lambda: engine.text_encoder(ids), 5)
        decode_ms = cuda_ms(lambda: engine.vae(lat / 0.18215), 3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                engine.unet(x, t, ctx)
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof_r:
            for _ in range(3):
                engine.unet(xr, tr, ctxr, **ragged)
            torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = prev
    print_groups("UNet call (batch 2 = CFG, 64x64 latents)", unet_ms,
                 device_groups(prof, 3), card_line)
    print_groups("ragged UNet call (batch 8 = 4 rows with CFG, 96x64 "
                 "latents)", ragged_ms, device_groups(prof_r, 3), card_line)
    print(f"profile: text encoder (1 x 77 tokens) {text_ms:.3f} ms, VAE "
          f"decode (1 x 512x512, f32) {decode_ms:.3f} ms [{card_line}]")


def ptxas_report(log: str) -> dict:
    """Per kernel of a ``-Xptxas -v`` log: registers, spill bytes, and
    whether ptxas serialised its wgmma (C7512 and kin)."""
    kernels: dict = {}
    kernel = ""
    for line in log.splitlines():
        if "Compiling entry function" in line and "'" in line:
            kernel = line.split("'")[1]
            kernels.setdefault(kernel, {"registers": 0, "spill_bytes": 0,
                                        "wgmma_serialized": False})
        elif "Function properties for" in line:
            kernel = line.rsplit(" ", 1)[-1]
            kernels.setdefault(kernel, {"registers": 0, "spill_bytes": 0,
                                        "wgmma_serialized": False})
        elif "spill stores" in line and kernel:
            words = line.replace(",", "").split()
            kernels[kernel]["spill_bytes"] = (
                int(words[words.index("spill") - 2])
                + int(words[words.index("loads") - 3]))
        elif "Used" in line and "registers" in line and kernel:
            kernels[kernel]["registers"] = int(
                line.split("Used ")[1].split(" ")[0])
        if "wgmma" in line and "serialized" in line and "'" in line:
            name = line.split("'")[1]
            kernels.setdefault(name, {"registers": 0, "spill_bytes": 0,
                                      "wgmma_serialized": False})
            kernels[name]["wgmma_serialized"] = True
    return kernels


def sm90_instance(name: str):
    """(padded head dim, consumer warpgroups, ragged) of a Hopper kernel's
    name, mangled (``ptxas``) or demangled (the profiler), or None."""
    import re

    m = (re.search(r"attn_sm90ILi(\d+)ELi(\d+)ELb([01])E", name)
         or re.search(r"attn_sm90<(\d+), (\d+), (true|false)>", name))
    return None if m is None else (int(m[1]), int(m[2]),
                                   m[3] in ("1", "true"))


# the head dim that reaches each padded Hopper head dim, and a query length
# per consumer warpgroup count (two where T > 256)
SM90_HEAD_DIMS = {48: 40, 64: 64, 80: 80, 160: 160}
SM90_QUERY_ROWS = {1: 128, 2: 512}


def phase_resources(fa, ra) -> dict:
    """The shared memory of each Hopper instantiation as launched: one
    small bf16 launch of each through each wrapper, traced with
    ``torch.profiler`` (CUPTI's kernel record: the static plus the dynamic
    shared memory of the launch). Returns {(dp, nc, ragged): bytes}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    calls = []
    for dp, d in SM90_HEAD_DIMS.items():
        for nc, t in SM90_QUERY_ROWS.items():
            q = torch.randn((1, t, 1, d), device="cuda").to(torch.bfloat16)
            lens = torch.tensor([t], dtype=torch.int32, device="cuda")
            calls.append((fa.flash_attention, lambda q=q: fa.flash_attention(
                q, q, q)))
            calls.append((ra.ragged_attention, lambda q=q, n=lens: (
                ra.ragged_attention(q, q, q, n))))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for wrapper, call in calls:
            _, path = launched_path(wrapper, call)
            check(path == "hopper", f"{wrapper.__name__}: a resources "
                  f"launch took the {path} path")
        torch.cuda.synchronize()
    trace = os.path.join(ROOT, "stable_diffusion_webui_distributed_tpu_torch",
                         "_build", f"resources-{os.getpid()}.json")
    prof.export_chrome_trace(trace)
    try:
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(trace)
    out = {}
    for ev in events:
        inst = sm90_instance(ev.get("name", ""))
        args = ev.get("args", {})
        if inst is None or ev.get("cat") != "kernel":
            continue
        check("shared memory" in args,
              f"the trace of {ev['name']} has no shared memory: {args}")
        out[inst] = int(args["shared memory"])
    want = {(dp, nc, r) for dp in SM90_HEAD_DIMS for nc in SM90_QUERY_ROWS
            for r in (False, True)}
    check(set(out) == want, f"traced instantiations {sorted(out)}, want "
          f"{sorted(want)}")
    return out


def phase_build(*modules) -> dict:
    """Every kernel built at once: one nvcc per source, started together.
    Returns the Hopper instantiations' registers, spills and wgmma
    serialisation per module (``ptxas -v``), and the build's seconds."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(modules)) as pool:
        logs = list(pool.map(lambda m: m.build()[1], modules))
    seconds = time.perf_counter() - t0
    out = {"seconds": round(seconds, 2)}
    for mod, log in zip(modules, logs):
        name = mod.__name__.rsplit(".", 1)[-1]
        report = ptxas_report(log)
        spills = [k for k, r in report.items() if r["spill_bytes"]]
        print(f"build: {name}: {len(report)} kernels, max "
              f"{max((r['registers'] for r in report.values()), default=0)}"
              f" registers, {len(spills)} with spills {spills}")
        hopper = []
        for kernel, r in sorted(report.items()):
            inst = sm90_instance(kernel)
            if inst is None:
                continue
            dp, nc, ragged = inst
            row = {"dp": dp, "consumer_warpgroups": nc, "ragged": ragged,
                   "registers": r["registers"],
                   "spill_bytes": r["spill_bytes"],
                   "wgmma_serialized": r["wgmma_serialized"]}
            hopper.append(row)
        if log:
            check(len(hopper) == 8, f"{name}: {len(hopper)} Hopper "
                  f"instantiations, want 8")
            check(not any(r["spill_bytes"] for r in hopper),
                  f"{name}: a Hopper instantiation spills")
            check(not any(r["wgmma_serialized"] for r in hopper),
                  f"{name}: ptxas serialised a Hopper instantiation's wgmma")
        out[name] = hopper
    print(f"build: all kernels in {seconds:.2f} s")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from stable_diffusion_webui_distributed_tpu_torch.ops import (
        flash_attention as fa,
    )
    from stable_diffusion_webui_distributed_tpu_torch.ops import (
        ragged_attention as ra,
    )

    kind = torch.cuda.get_device_name(0)
    card_line = card()
    print(f"device: {kind}; nvidia-smi: {card_line}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}")

    build = phase_build(fa, ra)
    resources = phase_resources(fa, ra)
    for name in ("flash_attention", "ragged_attention"):
        for row in build[name]:
            row["smem_bytes"] = resources[(row["dp"],
                                           row["consumer_warpgroups"],
                                           row["ragged"])]
            print(f"resources: {name} attn_sm90<{row['dp']}, "
                  f"{row['consumer_warpgroups']}, "
                  f"{str(row['ragged']).lower()}>: {json.dumps(row)}")
    totals, max_err, bound_by = phase_kernels(fa)
    r_totals, r_err, r_bound_by = phase_ragged_kernels(ra)
    engine, launches, paths = phase_main_path(fa, ra, card_line)
    k2_launches, r_paths = phase_ragged_serving(engine, fa, ra, card_line)
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
        "device_ms": round(totals["device_ms"], 4),
        "plain_ms": round(totals["plain_ms"], 4),
        "bound_ms": round(totals["bound_ms"], 4),
        "bound_by": bound_by,
        "library_ms": round(totals["library_ms"], 4),
        "library_device_ms": round(totals["library_device_ms"], 4),
        "exp_ms": round(totals["exp_ms"], 4),
        "fraction_of_bound": round(totals["bound_ms"] / totals["ms"], 4),
        "device_fraction_of_bound": round(
            totals["bound_ms"] / totals["device_ms"], 4),
        "host_us_per_launch": round(totals["host_us"], 2),
        "path": "hopper",
        "path_launches": paths,
        "design": DESIGN,
        "instantiations": build["flash_attention"],
        "build_s": build["seconds"],
        "per": "one UNet call of SD1.5 512x512 with CFG (16 launches), bf16",
    }, {
        "name": "ragged_attention",
        "route": "cuda",
        "source": "stable_diffusion_webui_distributed_tpu_torch/csrc/"
                  "ragged_attention.cu",
        "replaces": "stable_diffusion_webui_distributed_tpu/ops/"
                    "ragged_attention.py:76",
        "launches": k2_launches,
        "max_abs_err": r_err["bf16"],
        "max_abs_err_f32": r_err["f32"],
        "ms": round(r_totals["ms"], 4),
        "device_ms": round(r_totals["device_ms"], 4),
        "plain_ms": round(r_totals["plain_ms"], 4),
        "bound_ms": round(r_totals["bound_ms"], 4),
        "bound_by": r_bound_by,
        "library_ms": round(r_totals["library_ms"], 4),
        "library_device_ms": round(r_totals["library_device_ms"], 4),
        "exp_ms": round(r_totals["exp_ms"], 4),
        "fraction_of_bound": round(r_totals["bound_ms"] / r_totals["ms"], 4),
        "device_fraction_of_bound": round(
            r_totals["bound_ms"] / r_totals["device_ms"], 4),
        "host_us_per_launch": round(r_totals["host_us"], 2),
        "path": "hopper",
        "path_launches": r_paths,
        "design": DESIGN + "; ragged length policy (true_len per row, "
                  "V tail rows zeroed in shared memory)",
        "instantiations": build["ragged_attention"],
        "build_s": build["seconds"],
        "per": "one ragged UNet call of SD1.5 on a 512x768 bucket, batch 4 "
               "with CFG (32 launches: 16 self, 16 cross), bf16; bound on "
               "the valid work",
    }]
    print(json.dumps({"kernels": kernels}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
