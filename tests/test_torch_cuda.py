"""Kernels K1 and K2 on the card: each CUDA kernel against its plain
PyTorch version; and the int8 products of ``ops/quant.py``
(``torch._int_mm``, padded where it needs) against their exact plain
products.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU mode): they carry
the ``cuda`` marker and skip without one. The file imports no JAX, so it
also runs on a GPU machine that has none:

    python -m pytest tests/test_torch_cuda.py -q

Tolerances against the plain f32 version: 2e-5 for f32 inputs (TF32 off;
the sums run in another order), 1e-2 for bf16 (both round the output to
bf16, and the kernel also rounds the probabilities to bf16 for the second
product).

Each launch is also held to its path: the C entry point returns the path
it launched, and the wrapper counts the launch there. bf16 at the UNets'
head dims takes the Hopper kernel (TMA + wgmma); the shapes it cannot take
go to the general kernel.
"""

import pytest
import torch

from stable_diffusion_webui_distributed_tpu_torch.ops import flash_attention as fa
from stable_diffusion_webui_distributed_tpu_torch.ops import ragged_attention as ra

TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _path_counted(wrapper, call):
    """Runs ``call`` once; asserts it launched ``wrapper``'s kernel once, on
    one path. Returns the output and the path."""
    before = wrapper.launches, dict(wrapper.path_launches)
    out = call()
    torch.cuda.synchronize()
    assert wrapper.launches == before[0] + 1
    grown = [p for p, n in wrapper.path_launches.items() if n != before[1][p]]
    assert len(grown) == 1
    assert wrapper.path_launches[grown[0]] == before[1][grown[0]] + 1
    return out, grown[0]


def _hopper_expected(q):
    """bf16 at the UNets' head dims, laid out as the tests make them."""
    return (q.dtype == torch.bfloat16 and q.shape[-1] in (40, 64, 80, 160)
            and q.data_ptr() % 16 == 0)


def _check(q, k, v):
    out, path = _path_counted(fa.flash_attention,
                              lambda: fa.flash_attention(q, k, v))
    assert (path == "hopper") == _hopper_expected(q)
    assert out.shape == q.shape and out.dtype == q.dtype
    ref = fa.flash_attention_reference(q, k, v)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[q.dtype]
    return out


# (B, T, H, D, S): SD1.5 512x512 with CFG, then ragged edges, head dims that
# are no multiple of 8 or 16 (the general kernel's scalar-load path), and
# D = 256; then the Hopper kernel's edges: S shorter than one key tile,
# S = 1, S a multiple of the stage ring (5 x 128 keys at D = 40, 4 x 64 at
# D = 160, twice 4 x 128 at D = 80) and S that fills the ring once and a
# bit, a long S, T no multiple of 64 or 128, 64-row blocks (T <= 256)
# beside 128-row ones, and SDXL's head dim 64
CASES = [(2, 4096, 8, 40, 4096), (2, 1024, 8, 80, 1024),
         (2, 256, 8, 160, 256), (2, 64, 8, 160, 64), (1, 1000, 8, 64, 1000),
         (1, 77, 3, 8, 77), (2, 65, 3, 40, 200), (1, 100, 2, 33, 77),
         (1, 64, 1, 1, 3), (2, 130, 2, 256, 130),
         (2, 300, 2, 40, 50), (1, 200, 2, 80, 1), (1, 500, 2, 40, 640),
         (1, 300, 2, 160, 256), (1, 300, 2, 80, 1024), (1, 500, 2, 40, 700),
         (1, 16384, 1, 64, 16384),
         (2, 1000, 3, 80, 513), (1, 257, 2, 160, 300), (2, 100, 2, 40, 129),
         (2, 4096, 10, 64, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_kernel_matches_plain_on_card(card, case, dtype):
    b, t, h, d, s = case
    gen = torch.Generator(device=card).manual_seed(0)
    q = torch.randn((b, t, h, d), device=card, generator=gen).to(dtype)
    k, v = (torch.randn((b, s, h, d), device=card, generator=gen).to(dtype)
            for _ in range(2))
    _check(q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fused_qkv_slices_read_in_place(card, dtype):
    """The UNet hands K1 column slices of one fused QKV projection; the
    result equals that of contiguous copies, bit for bit."""
    gen = torch.Generator(device=card).manual_seed(1)
    x = torch.randn((2, 1024, 3 * 640), device=card, generator=gen).to(dtype)
    q, k, v = (y.unflatten(-1, (8, 80)) for y in x.split(640, dim=-1))
    assert not q.is_contiguous()
    out = _check(q, k, v)
    assert torch.equal(out, fa.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous()))


@pytest.mark.cuda
def test_repeat_launch_gives_same_bits(card):
    gen = torch.Generator(device=card).manual_seed(2)
    q, k, v = (torch.randn((2, 4096, 8, 40), device=card, generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    assert torch.equal(fa.flash_attention(q, k, v),
                       fa.flash_attention(q, k, v))
    lens = torch.tensor([4096, 3000], dtype=torch.int32, device=card)
    assert torch.equal(ra.ragged_attention(q, k, v, lens),
                       ra.ragged_attention(q, k, v, lens))


FRESH_THREAD = """
import sys, threading, torch
from stable_diffusion_webui_distributed_tpu_torch.ops import flash_attention as fa
from stable_diffusion_webui_distributed_tpu_torch.ops import ragged_attention as ra
q, k, v = (torch.randn((2, 512, 2, 40), device="cuda").to(torch.bfloat16)
           for _ in range(3))
lens = torch.tensor([512, 300], dtype=torch.int32, device="cuda")
out = {}
def run():
    out["k1"] = fa.flash_attention(q, k, v)
    out["k2"] = ra.ragged_attention(q, k, v, lens)
    torch.cuda.synchronize()
thread = threading.Thread(target=run)
thread.start()
thread.join()
assert torch.equal(out["k1"], fa.flash_attention(q, k, v))
assert torch.equal(out["k2"], ra.ragged_attention(q, k, v, lens))
assert fa.flash_attention.path_launches["hopper"] == 2
print("fresh thread ok")
"""


@pytest.mark.cuda
def test_first_launch_on_a_fresh_thread(card):
    """A library's first launch on a thread that made no CUDA call (the
    wrappers bind the card's context there first), in a process of its own
    so that the libraries load there."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", FRESH_THREAD], cwd=root,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "fresh thread ok" in proc.stdout


@pytest.mark.cuda
def test_rejects_what_the_kernel_cannot_take(card):
    q = torch.zeros((1, 8, 2, 16), device=card, dtype=torch.float16)
    with pytest.raises(ValueError, match="f32 or bf16"):
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 264), device=card)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 16, 2), device=card).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous last"):
        fa.flash_attention(q, q, q)


# K2: (B, T, H, D, S, true lengths, mask_queries). SD1.5 512x768 with CFG
# (rows of 512x512, 512x640 and 512x768 images, the group padded to 4) at
# levels 0 and 3, cross-attention over 2 * 77 context tokens, then lengths
# that straddle tiles, a single valid token, head dims that are no
# multiple of 8, and D = 256
RAGGED_CASES = [
    (8, 6144, 8, 40, 6144, [4096, 5120, 6144, 6144] * 2, True),
    (8, 96, 8, 160, 96, [64, 80, 96, 96] * 2, True),
    (8, 1536, 8, 80, 154, [77, 77, 77, 77, 154, 77, 77, 77], False),
    (4, 256, 2, 32, 256, [256, 77, 130, 1], True),
    (4, 256, 2, 32, 256, [129, 128, 127, 255], True),
    (2, 100, 2, 33, 77, [50, 77], True),
    (2, 130, 2, 256, 130, [130, 65], False),
    # the Hopper kernel: query tiles straddling the valid rows, a single
    # valid row, lengths at and across 128- and 64-key tile edges, and
    # cross-attention over 154 keys (two 128-key tiles, the last part
    # masked) at 64- and 128-row blocks
    (4, 300, 2, 40, 300, [300, 129, 200, 1], True),
    (4, 1000, 2, 80, 1000, [1000, 640, 257, 130], True),
    (3, 200, 2, 160, 200, [200, 65, 64], True),
    (4, 300, 2, 64, 154, [77, 154, 1, 100], False),
    (2, 200, 2, 40, 154, [154, 77], False),
]


def _check_ragged(q, k, v, lens, mask_queries):
    out, path = _path_counted(
        ra.ragged_attention,
        lambda: ra.ragged_attention(q, k, v, lens,
                                    mask_queries=mask_queries))
    assert (path == "hopper") == _hopper_expected(q)
    assert out.shape == q.shape and out.dtype == q.dtype
    ref = ra.ragged_attention_reference(
        q, k, v, lens, q_true_len=lens if mask_queries else None)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[q.dtype]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", RAGGED_CASES,
                         ids=lambda c: f"{c[:5]}-{'self' if c[6] else 'cross'}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_ragged_kernel_matches_plain_on_card(card, case, dtype):
    b, t, h, d, s, lens, mask_queries = case
    gen = torch.Generator(device=card).manual_seed(3)
    q = torch.randn((b, t, h, d), device=card, generator=gen).to(dtype)
    k, v = (torch.randn((b, s, h, d), device=card, generator=gen).to(dtype)
            for _ in range(2))
    lens = torch.tensor(lens, dtype=torch.int32, device=card)
    out = _check_ragged(q, k, v, lens, mask_queries)
    if mask_queries:
        for row, n in enumerate(lens.tolist()):
            assert torch.all(out[row, n:] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 63, 64, 127])
@pytest.mark.parametrize("d", [40, 160])
def test_hopper_padded_tail_is_inert_at_every_offset(card, d, offset):
    """The Hopper kernel's TMA boxes bring the padded tail's rows into the
    last key tile; whatever they hold (inf in K, NaN in V) the output is
    bit for bit the same, wherever in a tile the tail starts (128-key tiles
    at D = 40, 64-key tiles at D = 160)."""
    gen = torch.Generator(device=card).manual_seed(6)
    q, k, v = (torch.randn((2, 512, 2, d), device=card, generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    n = 256 + offset
    lens = torch.tensor([n, 512], dtype=torch.int32, device=card)
    base = _check_ragged(q, k, v, lens, True)
    k[0, n:], v[0, n:] = float("inf"), float("nan")
    for mask_queries in (True, False):
        out = ra.ragged_attention(q, k, v, lens, mask_queries=mask_queries)
        assert torch.isfinite(out.float()).all()
        if mask_queries:
            assert torch.equal(out, base)


@pytest.mark.cuda
def test_misaligned_base_takes_the_general_path(card):
    """A view whose base is not 16-byte aligned cannot be a TMA operand: it
    goes to the general kernel, says so in the counts, and agrees."""
    gen = torch.Generator(device=card).manual_seed(7)
    n = 2 * 300 * 2 * 40
    q, k, v = (torch.randn(n + 1, device=card, generator=gen)
               .to(torch.bfloat16)[1:].view(2, 300, 2, 40) for _ in range(3))
    assert q.data_ptr() % 16
    _, path = _path_counted(fa.flash_attention,
                            lambda: fa.flash_attention(q, k, v))
    assert path == "general"
    _check(q, k, v)
    lens = torch.tensor([300, 150], dtype=torch.int32, device=card)
    _, path = _path_counted(ra.ragged_attention,
                            lambda: ra.ragged_attention(q, k, v, lens))
    assert path == "general"


# head dim -> the path a bf16 launch takes: D % 8 == 0 with D rounded up
# to 16 in {48, 64, 80, 160} takes the Hopper kernel
HEAD_DIM_PATHS = {1: "general", 8: "general", 33: "general", 40: "hopper",
                  48: "hopper", 56: "hopper", 64: "hopper", 72: "hopper",
                  80: "hopper", 96: "general", 152: "hopper", 160: "hopper",
                  256: "general"}


@pytest.mark.cuda
def test_both_kernels_report_the_expected_path(card):
    """For each layout, K1 and K2 launch on the path TMA's rules give (a
    16-byte aligned base and strides of multiples of 16 bytes), count it,
    and a scale that is not positive takes the general kernel."""
    bf16 = torch.bfloat16
    x = torch.zeros((2, 64, 3 * 2 * 40 + 8), device=card, dtype=bf16)
    y = torch.zeros((2, 64, 3 * 2 * 40 + 4), device=card, dtype=bf16)
    layouts = [(torch.zeros((2, 64, 2, d), device=card, dtype=dt),
                path if dt == bf16 else "f32")
               for d, path in HEAD_DIM_PATHS.items()
               for dt in (bf16, torch.float32)]
    layouts += [(x[..., :80].unflatten(-1, (2, 40)), "hopper"),
                (x[..., 8:88].unflatten(-1, (2, 40)), "hopper"),
                (x[..., 4:84].unflatten(-1, (2, 40)), "general"),
                (x[:, :, :240].unflatten(-1, (2, 120))[..., :40], "hopper"),
                (y[..., :80].unflatten(-1, (2, 40)), "general")]
    lens = torch.full((2,), 64, dtype=torch.int32, device=card)
    for q, want in layouts:
        for scale in (None, -0.5):
            if scale is not None and want == "hopper":
                want = "general"
            _, k1 = _path_counted(fa.flash_attention,
                                  lambda: fa.flash_attention(q, q, q, scale))
            _, k2 = _path_counted(
                ra.ragged_attention,
                lambda: ra.ragged_attention(q, q, q, lens, scale))
            assert k1 == k2 == want, (q.shape, q.stride(), scale)


@pytest.mark.cuda
def test_negative_scale_takes_the_general_path(card):
    gen = torch.Generator(device=card).manual_seed(8)
    q, k, v = (torch.randn((2, 300, 2, 40), device=card, generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    out, path = _path_counted(fa.flash_attention,
                              lambda: fa.flash_attention(q, k, v, -0.2))
    assert path == "general"
    ref = fa.flash_attention_reference(q, k, v, -0.2)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[q.dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_ragged_padded_tail_is_inert_on_card(card, dtype):
    """Whatever the padded K/V tail holds (even inf), the output is bit for
    bit the same: the kernel never reads it."""
    gen = torch.Generator(device=card).manual_seed(4)
    q, k, v = (torch.randn((2, 200, 2, 40), device=card, generator=gen)
               .to(dtype) for _ in range(3))
    lens = torch.tensor([100, 64], dtype=torch.int32, device=card)
    base = _check_ragged(q, k, v, lens, True)
    k[0, 100:], v[1, 64:] = float("inf"), float("nan")
    assert torch.equal(ra.ragged_attention(q, k, v, lens), base)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1024, 8, 80), (2, 4096, 8, 40),
                                   (2, 256, 8, 160), (1, 300, 2, 64)],
                         ids=str)
def test_ragged_full_length_equals_k1(card, shape):
    gen = torch.Generator(device=card).manual_seed(5)
    q, k, v = (torch.randn(shape, device=card, generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    lens = torch.full((shape[0],), shape[1], dtype=torch.int32, device=card)
    assert torch.equal(ra.ragged_attention(q, k, v, lens),
                       fa.flash_attention(q, k, v))


@pytest.mark.cuda
def test_ragged_rejects_what_the_kernel_cannot_take(card):
    q = torch.zeros((2, 8, 2, 16), device=card)
    with pytest.raises(ValueError, match="true_len lies on"):
        ra.ragged_attention(q, q, q, torch.tensor([8, 8]))
    with pytest.raises(ValueError, match="f32 or bf16"):
        ra.ragged_attention(q.half(), q.half(), q.half(),
                            torch.tensor([8, 8], device=card))


# -- the int8 products (ops/quant.py) on the card ------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8192, 320, 960), (154, 768, 640),
                                   (5, 37, 19), (16, 6, 8), (33, 2880, 7)])
def test_int8_mm_equals_the_plain_products_on_card(card, m, k, n):
    """``torch._int_mm`` with its operands zero-padded where it needs (more
    than 16 rows, sizes multiples of 8): the exact int32 products."""
    from stable_diffusion_webui_distributed_tpu_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), dtype=torch.int8, device=card,
                      generator=gen)
    w = torch.randint(-127, 128, (n, k), dtype=torch.int8, device=card,
                      generator=gen)
    before = quant.int8_mm.launches
    got = quant.int8_mm(a, w.t())
    assert quant.int8_mm.launches == before + 1
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    assert torch.equal(got.cpu(),
                       quant.int8_mm_reference(a.cpu(), w.t().cpu()))


@pytest.mark.cuda
def test_int8_conv_on_card_equals_the_cpu(card):
    from stable_diffusion_webui_distributed_tpu_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((2, 13, 9, 11), device=card, generator=gen)
    w = torch.randn((7, 13, 3, 3), device=card, generator=gen)
    out, acc = quant.int8_conv(x, w, (2, 2), (1, 1), accumulators=True)
    ref, ref_acc = quant.int8_conv(x.cpu(), w.cpu(), (2, 2), (1, 1),
                                   accumulators=True)
    assert torch.equal(acc.cpu(), ref_acc)
    torch.testing.assert_close(out.cpu(), ref, rtol=1e-6, atol=0)
