"""Kernels K1 and K2 on the card: each CUDA kernel against its plain
PyTorch version.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU mode): they carry
the ``cuda`` marker and skip without one. The file imports no JAX, so it
also runs on a GPU machine that has none:

    python -m pytest tests/test_torch_cuda.py -q

Tolerances against the plain f32 version: 2e-5 for f32 inputs (TF32 off;
the sums run in another order), 1e-2 for bf16 (both round the output to
bf16, and the kernel also rounds the probabilities to bf16 for the second
product).
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


def _check(q, k, v):
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == q.dtype
    ref = fa.flash_attention_reference(q, k, v)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[q.dtype]
    return out


# (B, T, H, D, S): SD1.5 512x512 with CFG, then ragged edges, head dims that
# are no multiple of 8 or 16 (the kernel's scalar-load path), and D = 256
CASES = [(2, 4096, 8, 40, 4096), (2, 1024, 8, 80, 1024),
         (2, 256, 8, 160, 256), (2, 64, 8, 160, 64), (1, 1000, 8, 64, 1000),
         (1, 77, 3, 8, 77), (2, 65, 3, 40, 200), (1, 100, 2, 33, 77),
         (1, 64, 1, 1, 3), (2, 130, 2, 256, 130)]


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
]


def _check_ragged(q, k, v, lens, mask_queries):
    before = ra.ragged_attention.launches
    out = ra.ragged_attention(q, k, v, lens, mask_queries=mask_queries)
    torch.cuda.synchronize()
    assert ra.ragged_attention.launches == before + 1
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
def test_ragged_full_length_equals_k1(card):
    gen = torch.Generator(device=card).manual_seed(5)
    q, k, v = (torch.randn((2, 1024, 8, 80), device=card, generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    lens = torch.full((2,), 1024, dtype=torch.int32, device=card)
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
