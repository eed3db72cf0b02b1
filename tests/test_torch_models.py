"""The port's models against the JAX package's, on TINY in f32 on the CPU.

The same Flax weights (``test_pipeline.init_params``, carried over with
``bridge.flax_to_torch``) and the same numpy inputs go through both. CLIP
(clip skip 0 and 1, and the engine's emphasis with the chunk mean restored),
the UNet's full forward and ``VAE.decode`` must agree within 2e-5 absolute:
the two sum in different orders, and the largest gap seen is about 4e-6 on
outputs of order 1.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stable_diffusion_webui_distributed_tpu.models.clip import (
    CLIPTextModel as JaxCLIP,
)
from stable_diffusion_webui_distributed_tpu.models.configs import TINY as JTINY
from stable_diffusion_webui_distributed_tpu.models.unet import UNet as JaxUNet
from stable_diffusion_webui_distributed_tpu.models.vae import VAE as JaxVAE
from stable_diffusion_webui_distributed_tpu.pipeline.engine import (
    Engine as JaxEngine,
)
from stable_diffusion_webui_distributed_tpu.pipeline.payload import (
    GenerationPayload as JaxPayload,
)
from stable_diffusion_webui_distributed_tpu.runtime.interrupt import (
    GenerationState as JaxState,
)
from stable_diffusion_webui_distributed_tpu_torch import bridge
from stable_diffusion_webui_distributed_tpu_torch.models.configs import TINY
from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import Engine
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.interrupt import (
    GenerationState,
)
from test_pipeline import init_params

ATOL = 2e-5
RNG = np.random.default_rng(11)


@pytest.fixture(scope="module")
def params():
    return jax.device_get(jax.jit(init_params, static_argnums=0)(JTINY))


@pytest.fixture(scope="module")
def modules(params):
    sds = bridge.flax_to_torch(TINY, params)
    mods = bridge.build_modules(TINY)
    for name, module in mods.items():
        module.load_state_dict(sds[name], strict=True)
        module.eval()
    return mods


@pytest.mark.parametrize("skip", [0, 1])
def test_clip_matches_jax(params, modules, skip):
    ids = RNG.integers(0, TINY.text_encoder.vocab_size, (2, 77))
    ids[:, -1] = TINY.text_encoder.vocab_size - 1  # EOS is the largest id
    ctx_j, pooled_j = JaxCLIP(JTINY.text_encoder).apply(
        {"params": params["text_encoder"]}, jnp.asarray(ids, jnp.int32),
        skip=skip)
    with torch.no_grad():
        ctx_t, pooled_t = modules["text_encoder"](torch.from_numpy(ids),
                                                  skip=skip)
    np.testing.assert_allclose(ctx_t.numpy(), np.asarray(ctx_j), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(pooled_t.numpy(), np.asarray(pooled_j),
                               rtol=0, atol=ATOL)


def test_unet_full_forward_matches_jax(params, modules):
    x = RNG.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([981.0, 10.5], np.float32)
    ctx = RNG.standard_normal((2, 154, 32)).astype(np.float32)  # 2 chunks
    want = JaxUNet(JTINY.unet).apply({"params": params["unet"]},
                                     jnp.asarray(x), jnp.asarray(t),
                                     jnp.asarray(ctx))
    with torch.no_grad():
        got = modules["unet"](*(torch.from_numpy(a) for a in (x, t, ctx)))
    assert got.shape == (2, 16, 16, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_vae_decode_matches_jax(params, modules):
    lat = RNG.standard_normal((2, 8, 8, 4)).astype(np.float32)
    want = JaxVAE(JTINY.vae).apply({"params": params["vae"]},
                                   jnp.asarray(lat), method=JaxVAE.decode)
    with torch.no_grad():
        got = modules["vae"](torch.from_numpy(lat))
    assert got.shape == want.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.fixture(scope="module")
def engines(params):
    jax_engine = JaxEngine(JTINY, params, state=JaxState())
    port = Engine(TINY, bridge.flax_to_torch(TINY, params),
                  state=GenerationState(), device="cpu")
    return jax_engine, port


@pytest.mark.parametrize("prompt,negative,clip_skip", [
    ("a (red:1.3) cow, [blue] sky", "blurry", 0),
    ("((very)) plain", "", 2),
    (" ".join(["long"] * 90) + " (tail:0.6)", "short", 1),  # two chunks
])
def test_encode_prompts_matches_jax(engines, prompt, negative, clip_skip):
    """Emphasis weights scale the tokens and the chunk mean is restored;
    the chunks join along the sequence axis, cond and uncond padded to one
    chunk count."""
    jax_engine, port = engines
    kw = dict(prompt=prompt, negative_prompt=negative, clip_skip=clip_skip)
    (ju, jc), (jpu, jpc) = jax_engine.encode_prompts(JaxPayload(**kw))
    with torch.no_grad():
        (tu, tc), (tpu, tpc) = port.encode_prompts(GenerationPayload(**kw))
    for got, want in ((tu, ju), (tc, jc), (tpu, jpu), (tpc, jpc)):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                                   rtol=0, atol=ATOL)
