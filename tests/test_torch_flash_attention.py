"""Kernel K1: the port's flash attention against the JAX package's.

On the CPU the port's wrapper computes its plain version; it is held against
the JAX Pallas kernel run in interpret mode, as tests/test_ops.py runs it, at
f32 with rtol = atol = 2e-5 (the two sum in different orders). bf16 inputs
are compared at one bf16 step (1e-2): both round an f32 result to bf16. The
CUDA kernel itself runs only on the card: ``test_torch_cuda.py`` holds it
against the plain version there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stable_diffusion_webui_distributed_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention,
)
from stable_diffusion_webui_distributed_tpu_torch.ops import flash_attention as fa
from stable_diffusion_webui_distributed_tpu_torch.ops import ragged_attention as ra

RNG = np.random.default_rng(3)


def qkv(b, t, h, d, s=None):
    s = t if s is None else s
    return (RNG.standard_normal((b, t, h, d), np.float32),
            RNG.standard_normal((b, s, h, d), np.float32),
            RNG.standard_normal((b, s, h, d), np.float32))


def port(q, k, v, dtype=torch.float32):
    return fa.flash_attention(*(torch.from_numpy(x).to(dtype)
                                for x in (q, k, v)))


# (B, T, H, D, S, block_q, block_k): test_ops.py's shapes, then the
# remaining SD head dims
CASES = {
    "t256-block128": (2, 256, 4, 32, None, 128, 128),
    "t128-block64": (2, 128, 4, 32, None, 64, 64),
    "t64-block64": (2, 64, 4, 32, None, 64, 64),
    "s77-non-tiling": (1, 64, 4, 32, 77, 128, 128),
    "many-k-tiles": (2, 512, 2, 32, None, 128, 64),
    "d40": (1, 256, 8, 40, None, 64, 64),
    "d80": (1, 128, 8, 80, None, 64, 64),
    "d160": (1, 128, 4, 160, None, 64, 64),
    "d64": (2, 128, 4, 64, None, 64, 64),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_kernel(case):
    b, t, h, d, s, bq, bk = CASES[case]
    q, k, v = qkv(b, t, h, d, s)
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               block_q=bq, block_k=bk, interpret=True)
    got = port(q, k, v)
    assert got.shape == (b, t, h, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_bf16_inputs_match_jax_kernel():
    q, k, v = qkv(1, 128, 2, 32)
    want = jax_flash_attention(*(jnp.asarray(x).astype(jnp.bfloat16)
                                 for x in (q, k, v)),
                               block_q=64, block_k=64, interpret=True)
    got = port(q, k, v, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=1e-2, atol=1e-2)


def test_cpu_tensors_take_the_plain_path_without_a_launch():
    before = fa.flash_attention.launches
    q, k, v = qkv(1, 96, 2, 40, 50)
    out = port(q, k, v)
    ref = fa.flash_attention_reference(*(torch.from_numpy(x)
                                         for x in (q, k, v)))
    assert fa.flash_attention.launches == before == 0
    assert torch.equal(out, ref)


def test_strided_views_are_read_in_place():
    """The UNet hands K1 column slices of a fused QKV projection."""
    qkv_t = torch.from_numpy(RNG.standard_normal((2, 64, 3 * 4 * 16),
                                                 np.float32))
    q, k, v = (t.unflatten(-1, (4, 16)) for t in qkv_t.split(64, dim=-1))
    assert not q.is_contiguous()
    torch.testing.assert_close(
        fa.flash_attention(q, k, v),
        fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous()),
        rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["rank", "heads", "dtype"])
def test_rejects_what_it_cannot_take(bad):
    q = torch.zeros(1, 8, 2, 16)
    k = torch.zeros(1, 8, 2, 16)
    if bad == "rank":
        q = q[0]
    elif bad == "heads":
        k = torch.zeros(1, 8, 3, 16)
    else:
        k = k.to(torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, k)


class OtherDevice(torch.Tensor):
    """A tensor that reports a device neither the CPU nor CUDA."""

    @property
    def device(self):
        return torch.device("xpu")


def test_non_cpu_device_never_falls_back():
    # a meta tensor computes nothing: it gets the plain version's shape
    # (the FLOP pricer's products), and no launch is counted
    before = fa.flash_attention.launches
    q = torch.empty(1, 8, 2, 16, device="meta")
    out = fa.flash_attention(q, q, q)
    assert out.device.type == "meta" and out.shape == q.shape
    assert fa.flash_attention.launches == before
    other = torch.empty(1, 8, 2, 16).as_subclass(OtherDevice)
    with pytest.raises(ValueError, match="no flash_attention for device"):
        fa.flash_attention(other, other, other)


@pytest.fixture(params=["flash_attention", "ragged_attention"])
def wrapper(request):
    """A kernel wrapper with its launch counts at 0, restored afterwards."""
    fn = getattr(fa if request.param == "flash_attention" else ra,
                 request.param)
    saved = fn.launches, dict(fn.path_launches)
    fa.reset_launches(fn)
    yield fn
    fn.launches, fn.path_launches = saved


@pytest.mark.parametrize("path", fa.PATHS)
def test_a_launch_counts_on_the_path_the_library_reports(wrapper, path):
    """The C entry point chooses the path and returns its index; the
    wrapper counts the launch there and on no other path."""
    fa.count_launch(wrapper, fa.PATHS.index(path))
    assert wrapper.launches == 1
    assert wrapper.path_launches == {p: int(p == path) for p in fa.PATHS}


@pytest.mark.parametrize("code", [-1, -700])
def test_a_failed_launch_raises_and_counts_nothing(wrapper, code):
    """A negated cudaError_t from the entry point raises, uncounted."""
    with pytest.raises(RuntimeError, match=f"{wrapper.__name__} launch "
                       f"failed: cudaError {-code}$"):
        fa.count_launch(wrapper, code)
    assert wrapper.launches == 0
    assert not any(wrapper.path_launches.values())


def test_cpu_launches_count_on_no_path():
    before = dict(fa.flash_attention.path_launches)
    port(*qkv(1, 64, 2, 40))
    assert fa.flash_attention.path_launches == before
    assert set(before) == set(fa.PATHS)
