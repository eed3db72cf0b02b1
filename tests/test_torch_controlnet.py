"""The port's img2img modules against the JAX package's, on the CPU in f32.

The same weights and the same numpy inputs go through both packages:
- the VAE encoder's moments (TINY's ``init_params`` weights);
- the ControlNet's residuals, on weights converted from a synthetic ldm
  checkpoint (``make_ldm_controlnet``, as ``tests/test_adapters.py`` makes
  it) and on a TINY_XL ControlNet with the added-conditioning branch;
- a UNet call with residuals added to its skips and mid block;
each within 1e-5 of the JAX output relative to its largest value. The
preprocessors and the mask's box blur must give the JAX package's arrays
exactly, and the bilinear resize ``jax.image.resize``'s within 1e-6 (it
antialiases when it shrinks an axis).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stable_diffusion_webui_distributed_tpu.models import controlnet as jcn
from stable_diffusion_webui_distributed_tpu.models.configs import TINY as JTINY
from stable_diffusion_webui_distributed_tpu.models.configs import (
    TINY_XL as JTINY_XL,
)
from stable_diffusion_webui_distributed_tpu.models.unet import UNet as JaxUNet
from stable_diffusion_webui_distributed_tpu.models.vae import VAE as JaxVAE
from stable_diffusion_webui_distributed_tpu.pipeline import (
    engine as jax_engine,
)
from stable_diffusion_webui_distributed_tpu_torch import bridge
from stable_diffusion_webui_distributed_tpu_torch.models import controlnet
from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
    TINY,
    TINY_XL,
)
from stable_diffusion_webui_distributed_tpu_torch.models.vae import (
    Encoder,
    encode,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline import image
from test_adapters import make_ldm_controlnet
from test_pipeline import init_params

RTOL = 1e-5  # of the largest reference value
RNG = np.random.default_rng(23)


def assert_close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) / scale <= rtol


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


@pytest.fixture(scope="module")
def cn_params():
    cfg = JTINY.unet
    return jax.device_get(jcn.convert_controlnet(make_ldm_controlnet(cfg),
                                                 cfg))


def port_controlnet(family, tree):
    module = controlnet.ControlNet(family.unet)
    module.load_state_dict(bridge.controlnet_flax_to_torch(tree),
                           strict=True)
    return module.eval()


@pytest.mark.parametrize("size", [16, 24])
def test_vae_encoder_moments_match_jax(params, modules, size):
    img = RNG.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    mean_j, logvar_j = JaxVAE(JTINY.vae).apply(
        {"params": params["vae"]}, jnp.asarray(img), method=JaxVAE.encode)
    with torch.no_grad():
        mean_t, logvar_t = encode(modules["vae_encoder"],
                                  torch.from_numpy(img))
    assert mean_t.shape == (2, size // 2, size // 2, 4)
    assert_close(mean_t.numpy(), mean_j)
    assert_close(logvar_t.numpy(), logvar_j)


def test_logvar_is_clipped():
    enc = Encoder(TINY.vae)
    with torch.no_grad():
        for p in enc.parameters():
            p.zero_()
        enc.quant_conv.bias.fill_(1e3)
        mean, logvar = encode(enc, torch.zeros(1, 8, 8, 3))
    assert float(mean.min()) == 1e3
    assert float(logvar.min()) == float(logvar.max()) == 20.0


def _cn_inputs(cfg, lat=8, batch=2, added=False):
    x = RNG.standard_normal((batch, lat, lat, 4)).astype(np.float32)
    t = np.array([981.0, 10.5][:batch], np.float32)
    ctx = RNG.standard_normal((batch, 77, cfg.cross_attention_dim)).astype(
        np.float32)
    hint = RNG.uniform(0, 1, (batch, 8 * lat, 8 * lat, 3)).astype(np.float32)
    extra = ([RNG.standard_normal((batch, cfg.projection_input_dim))
              .astype(np.float32)] if added else [])
    return [x, t, ctx, hint] + extra


def test_controlnet_residuals_match_jax(cn_params):
    cfg = JTINY.unet
    inputs = _cn_inputs(cfg)
    want = jcn.ControlNet(cfg).apply({"params": cn_params},
                                     *map(jnp.asarray, inputs))
    module = port_controlnet(TINY, cn_params)
    with torch.no_grad():
        got = module(*map(torch.from_numpy, inputs))
    assert len(got) == len(want) == 5  # 4 skips of TINY's UNet + mid
    for g, w in zip(got, want):
        assert_close(g.permute(0, 2, 3, 1).numpy(), w)


def test_controlnet_sdxl_branch_matches_jax():
    """TINY_XL's ControlNet takes the added conditioning through
    ``add_fc1``/``add_fc2``; every parameter, the zero convolutions
    included, is drawn at random so that each residual is nonzero."""
    cfg = JTINY_XL.unet
    inputs = _cn_inputs(cfg, added=True)
    init = jcn.ControlNet(cfg).init(jax.random.key(3),
                                    *map(jnp.asarray, inputs))["params"]
    rng = np.random.default_rng(5)
    tree = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 0.05).astype(np.float32)
        + (1.0 if a.ndim == 1 else 0.0), jax.device_get(init))
    want = jcn.ControlNet(cfg).apply({"params": tree},
                                     *map(jnp.asarray, inputs))
    module = port_controlnet(TINY_XL, tree)
    assert hasattr(module, "add_fc1")
    with torch.no_grad():
        got = module(*map(torch.from_numpy, inputs))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert float(np.abs(np.asarray(w)).max()) > 0
        assert_close(g.permute(0, 2, 3, 1).numpy(), w)


def test_seeded_controlnet_has_the_converted_names(cn_params):
    converted = bridge.controlnet_flax_to_torch(cn_params)
    seeded = bridge.init_seeded_controlnet(TINY, seed=0, device="cpu")
    assert {n: tuple(t.shape) for n, t in seeded.items()} == \
        {n: tuple(t.shape) for n, t in converted.items()}
    # the zero convolutions are drawn, not zeroed
    assert seeded["zero_conv_0.weight"].abs().sum() > 0
    assert seeded["hint.conv_out.weight"].abs().sum() > 0


def test_unet_with_residuals_matches_jax(params, modules, cn_params):
    cfg = JTINY.unet
    x, t, ctx, hint = _cn_inputs(cfg)
    res = jcn.ControlNet(cfg).apply({"params": cn_params}, jnp.asarray(x),
                                    jnp.asarray(t), jnp.asarray(ctx),
                                    jnp.asarray(hint))
    want = JaxUNet(cfg).apply({"params": params["unet"]}, jnp.asarray(x),
                              jnp.asarray(t), jnp.asarray(ctx),
                              control_residuals=res)
    plain = JaxUNet(cfg).apply({"params": params["unet"]}, jnp.asarray(x),
                               jnp.asarray(t), jnp.asarray(ctx))
    residuals = [torch.from_numpy(np.array(r)).permute(0, 3, 1, 2)
                 for r in res]
    with torch.no_grad():
        got = modules["unet"](torch.from_numpy(x), torch.from_numpy(t),
                              torch.from_numpy(ctx),
                              control_residuals=residuals)
    assert float(np.abs(np.asarray(want) - np.asarray(plain)).max()) > 1e-3
    assert_close(got.numpy(), want)


def test_unet_checks_the_residual_count(modules):
    x = torch.zeros(1, 8, 8, 4)
    with pytest.raises(ValueError, match="control residuals"):
        modules["unet"](x, torch.ones(1), torch.zeros(1, 77, 32),
                        control_residuals=[torch.zeros(1, 32, 8, 8)])


def test_inpainting_family_takes_nine_channels():
    """An inpainting family's UNet takes the latent, the mask and the
    masked image's latent (4 + 1 + 4 channels) through ``in_channels``."""
    from stable_diffusion_webui_distributed_tpu.models.configs import (
        TINY_INPAINT as JTINY_INPAINT,
    )
    from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
        TINY_INPAINT,
    )

    flax = jax.device_get(jax.jit(init_params, static_argnums=0)(
        JTINY_INPAINT))
    unet = bridge.build_modules(TINY_INPAINT)["unet"]
    unet.load_state_dict(bridge.flax_to_torch(TINY_INPAINT, flax)["unet"],
                         strict=True)
    x = RNG.standard_normal((2, 8, 8, 9)).astype(np.float32)
    t = np.array([500.0, 20.0], np.float32)
    ctx = RNG.standard_normal((2, 77, 32)).astype(np.float32)
    want = JaxUNet(JTINY_INPAINT.unet).apply(
        {"params": flax["unet"]}, *map(jnp.asarray, (x, t, ctx)))
    with torch.no_grad():
        got = unet.eval()(*map(torch.from_numpy, (x, t, ctx)))
    assert got.shape == (2, 8, 8, 4)
    assert_close(got.numpy(), want)


def _pattern(h, w):
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([(x * 7) % 256, (y * 5) % 256, ((x + y) * 3) % 256], -1)
    img[h // 3: h // 2, w // 4: w // 2] = 255  # a block with hard edges
    return img.astype(np.uint8)


@pytest.mark.parametrize("name", ["none", "canny", "invert", "inpaint",
                                  "inpaint_only", "unknown-module"])
def test_preprocessors_equal_jax(name):
    img = _pattern(40, 56)
    mask = np.zeros((40, 56), np.uint8)
    mask[20:] = 255
    want = jcn.run_preprocessor(name, img, mask=mask)
    got = controlnet.run_preprocessor(name, img, mask=mask)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_canny_on_a_float_image_equals_jax():
    img = RNG.uniform(0, 255, (33, 47, 3)).astype(np.float32)
    np.testing.assert_array_equal(controlnet.preprocess_canny(img),
                                  jcn.preprocess_canny(img))


@pytest.mark.parametrize("radius", [1, 4, 9])
def test_box_blur_equals_jax(radius):
    m = (RNG.uniform(0, 1, (48, 40, 1)) > 0.6).astype(np.float32)
    np.testing.assert_array_equal(image.box_blur(m, radius),
                                  jax_engine._box_blur(m, radius))


@pytest.mark.parametrize("src,dst", [
    ((32, 24, 3), (64, 48, 3)),    # 2x up
    ((64, 48, 3), (32, 24, 3)),    # 0.5x down
    ((64, 64, 1), (8, 8, 1)),      # 8x down (a mask to latent size)
    ((30, 50, 3), (64, 40, 3)),    # one axis up, one down
])
def test_bilinear_resize_matches_jax(src, dst):
    img = RNG.uniform(0, 1, src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(img), dst, "bilinear"))
    got = image.resize_bilinear(img, dst)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_resize_image_equals_jax_helper():
    img = RNG.uniform(0, 1, (40, 30, 3)).astype(np.float32)
    np.testing.assert_allclose(image.resize_image(img, 64, 48),
                               jax_engine._resize_image(img, 64, 48),
                               rtol=0, atol=1e-6)
    assert image.resize_image(img, 30, 40) is img
