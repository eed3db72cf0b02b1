#!/usr/bin/env python3
"""What bounds the Hopper attention mainloop: remove one stage at a time.

    python3 tools/torch_attn_limits.py

Copies ``csrc/`` into ``_build/limits/<variant>/`` beside the package,
patches one stage out of ``attention_sm90.cuh`` in each copy, builds each
copy's K1 (``flash_attention.cu``) with the port's nvcc flags (all
variants at once), and times K1 through each library in bf16 at SD1.5's
level-0 and level-1 shapes (column slices of a fused QKV projection), as
device time of a replayed CUDA graph. The variants:

- ``as_built``: the source unchanged;
- ``no_exp``: the exps are the identity (no MUFU work);
- ``no_qk``, ``no_pv``: one product's wgmma not issued;
- ``no_reload``: the producer loads the ring's first stages once, then
  marks later tiles full without loading them (no TMA traffic after the
  first fill);
- ``pingpong_flip``: the two consumer warpgroups take turns to issue
  their products where the source lets them issue freely (D = 40), and
  issue freely where it has them take turns (D >= 64);
- ``serial``: the softmax of each tile waits for both products (no
  overlap of the exps with P.V).

A variant that runs much faster than ``as_built`` removed work that bounds
the kernel; one that runs no faster removed work that is hidden. The
outputs of the patched variants are wrong by design and are not checked.
Prints one line ``LIMITS {...}`` with ms per shape and variant, and the
card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# variant -> [(text in attention_sm90.cuh, replacement)], each text once
PATCHES = {
    "as_built": [],
    "no_exp": [('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                "y = x;")],
    "no_qk": [("wgmma_ss<BK>(sc, a, bd, kk == 0);", "(void)a; (void)bd;")],
    "no_pv": [("""        wgmma_rs<DP>(acc, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                     p[4 * kk + 3], bd);""", "        (void)bd;")],
    "no_reload": [("""        mbar_expect_tx(bar_full + 8 * s, kv_bytes);
        tma_load_5d(sk + s * kTileBytes, &tk, bar_full + 8 * s, j * BK, h, b);
        tma_load_5d(sv + s * kTileBytes, &tv, bar_full + 8 * s, j * BK, h, b);""",
                   """        if (j >= kStages) {
          mbar_arrive(bar_full + 8 * s);
          continue;
        }
        mbar_expect_tx(bar_full + 8 * s, kv_bytes);
        tma_load_5d(sk + s * kTileBytes, &tk, bar_full + 8 * s, j * BK, h, b);
        tma_load_5d(sv + s * kTileBytes, &tv, bar_full + 8 * s, j * BK, h, b);""")],
    "pingpong_flip": [("constexpr bool kPingPong = NC == 2 && DP > 48;",
                       "constexpr bool kPingPong = NC == 2 && DP == 48;")],
    "serial": [("wg_wait<1>();  // S(j) is in", "wg_wait<0>();  // S(j) is in")],
}
# (B, T, H, D): SD1.5 512x512 with CFG, levels 0 and 1
SHAPES = [(2, 4096, 8, 40), (2, 1024, 8, 80)]


def build_variant(name: str, patches) -> Path:
    from stable_diffusion_webui_distributed_tpu_torch.ops import nvcc

    src = ROOT / "stable_diffusion_webui_distributed_tpu_torch" / "csrc"
    out = nvcc.BUILD_DIR / "limits" / name
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(src, out)
    header = out / "attention_sm90.cuh"
    text = header.read_text()
    for old, new in patches:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: patch target found "
                             f"{text.count(old)} times: {old[:60]!r}")
        text = text.replace(old, new)
    header.write_text(text)
    lib = out / "libk1.so"
    nv = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    proc = subprocess.run([nv, *nvcc._NVCC_FLAGS, "-o", str(lib),
                           str(out / "flash_attention.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    return lib


def main() -> int:
    import torch

    from stable_diffusion_webui_distributed_tpu_torch.ops import (
        flash_attention as fa,
    )

    import chip_smoke as smoke

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    with ThreadPoolExecutor(len(PATCHES)) as pool:
        libs = dict(zip(PATCHES, pool.map(lambda kv: build_variant(*kv),
                                          PATCHES.items())))
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = []
    for b, t, h, d in SHAPES:
        qkv = torch.randn((b, t, 3 * h * d), device="cuda",
                          generator=gen).to(torch.bfloat16)
        q, k, v = (x.unflatten(-1, (h, d)) for x in qkv.split(h * d, dim=-1))
        inputs.append((q, k, v, torch.empty((b, t, h, d), device="cuda",
                                            dtype=torch.bfloat16)))
    result = {"card": smoke.card()}
    for name, lib in libs.items():
        fn = ctypes.CDLL(str(lib)).sdt_flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_longlong] * 9 + [ctypes.c_float, ctypes.c_int,
                                      ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for (q, k, v, o) in inputs:
            b, t, h, d = q.shape

            def call(q=q, k=k, v=v, o=o):
                code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          o.data_ptr(), b, t, t, h, d,
                          *fa.kernel_strides(q, k, v), d ** -0.5, 1,
                          fa.current_stream(q))
                if code != fa.PATHS.index("hopper"):
                    raise RuntimeError(f"{name}: returned {code}, not the "
                                       f"Hopper path")

            ms = smoke.graph_ms(call, 20)
            result[f"{name} {tuple(q.shape)}"] = round(ms, 4)
            print(f"limits: {name} {tuple(q.shape)}: {ms:.4f} ms")
    print("LIMITS " + json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
