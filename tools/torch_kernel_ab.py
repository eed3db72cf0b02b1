#!/usr/bin/env python3
"""Time the attention kernels K1 and K2 of one checkout, for A/B runs.

    python3 tools/torch_kernel_ab.py CHECKOUT

Loads ``stable_diffusion_webui_distributed_tpu_torch`` from CHECKOUT (a
directory holding the port's package, e.g. a ``git archive`` of a parent
commit), builds its kernels, and times them in bf16 at every shape SD1.5
gives them: K1 at the main path's shapes (512x512 with CFG) and K2 at the
ragged serving phase's (a 512x768 bucket, batch 4 with CFG), laid out as
the UNet hands them over (column slices of the fused projections). The
shapes, lengths and timers are this tree's ``chip_smoke.py``, loaded by its
path whichever checkout is timed. Per shape it prints the kernel's time
over back-to-back eager launches and its device time with the host taken
out (a CUDA graph of the launches, replayed), both between CUDA events,
the wrapper's host time per launch, and the same two times of PyTorch's
``scaled_dot_product_attention`` on the same inputs (a yardstick); then
one line ``KERNEL_AB {...}`` with the totals per UNet call and per ragged
UNet call. Compare two checkouts inside one call on one card, in turns
(A, B, B, A).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = ("ms", "device_ms", "sdpa_ms", "sdpa_device_ms")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkout")
    args = ap.parse_args()
    root = os.path.abspath(args.checkout)
    sys.path.insert(0, root)

    import torch
    import torch.nn.functional as F

    import stable_diffusion_webui_distributed_tpu_torch as port
    from stable_diffusion_webui_distributed_tpu_torch.ops import (
        flash_attention as fa,
    )
    from stable_diffusion_webui_distributed_tpu_torch.ops import (
        ragged_attention as ra,
    )

    spec = importlib.util.spec_from_file_location(
        "kernel_ab_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    if not port.__file__.startswith(root + os.sep):
        raise SystemExit(f"loaded the port from {port.__file__}, not {root}")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    fa.build()
    ra.build()

    gen = torch.Generator(device="cuda").manual_seed(0)
    totals = {f"{k}_{m}": 0.0 for k in ("k1", "k2") for m in METRICS}
    host = {"k1": [], "k2": []}
    rows = []

    def timed(kernel, fn, sdpa, calls, **row):
        r = {"kernel": kernel, **row, "calls": calls,
             "ms": smoke.cuda_ms(fn, 20), "device_ms": smoke.graph_ms(fn, 20),
             "host_us": smoke.host_us(fn), "sdpa_ms": smoke.cuda_ms(sdpa, 20),
             "sdpa_device_ms": smoke.graph_ms(sdpa, 20)}
        rows.append(r)
        for m in METRICS:
            totals[f"{kernel.lower()}_{m}"] += calls * r[m]
        host[kernel.lower()].append(r["host_us"])

    for shape, calls in smoke.MAIN_SHAPES:
        b, t, h, d = shape
        qkv = torch.randn((b, t, 3 * h * d), device="cuda",
                          generator=gen).to(torch.bfloat16)
        q, k, v = (x.unflatten(-1, (h, d)) for x in qkv.split(h * d, dim=-1))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        timed("K1", lambda: fa.flash_attention(q, k, v),
              lambda: F.scaled_dot_product_attention(qt, kt, vt), calls,
              shape=shape)
    for shape, s_len, lens, mask_q, calls in smoke.ragged_shapes():
        b, t, h, d = shape
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        if mask_q:
            qkv = torch.randn((b, t, 3 * h * d), device="cuda",
                              generator=gen).to(torch.bfloat16)
            q, k, v = (x.unflatten(-1, (h, d))
                       for x in qkv.split(h * d, dim=-1))
        else:
            q = torch.randn((b, t, h, d), device="cuda",
                            generator=gen).to(torch.bfloat16)
            kv = torch.randn((b, s_len, 2 * h * d), device="cuda",
                             generator=gen).to(torch.bfloat16)
            k, v = (x.unflatten(-1, (h, d)) for x in kv.split(h * d, dim=-1))
        mask = (torch.arange(s_len, device="cuda")[None, :]
                < lengths[:, None])[:, None, None, :]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        timed("K2",
              lambda: ra.ragged_attention(q, k, v, lengths,
                                          mask_queries=mask_q),
              lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                     attn_mask=mask),
              calls, shape=shape, s=s_len, kind="self" if mask_q else "cross")
    for row in rows:
        print("KERNEL_ROW " + json.dumps(row))
    out = {"checkout": args.checkout, "card": card,
           **{k: round(v, 4) for k, v in totals.items()},
           "k1_host_us": round(sum(host["k1"]) / len(host["k1"]), 2),
           "k2_host_us": round(sum(host["k2"]) / len(host["k2"]), 2)}
    print("KERNEL_AB " + json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
