"""Ragged dispatch in the port against the JAX package, on the CPU.

Kernel K2: on the CPU the port's ``ragged_attention`` computes its plain
version. It is held against the JAX package's dense reference and its
Pallas kernel in interpret mode, mirroring ``tests/test_ragged.py``, in f32
with rtol = atol = 2e-5 (the two sum in different orders): head dims,
lengths that straddle tiles, full length against dense attention, mixed
rows against per-row dense attention with an exactly zero tail, a padded
K/V tail that leaves the output bit for bit unchanged, and the
cross-attention form (keys masked, queries kept). The CUDA kernel itself
runs only on the card (``test_torch_cuda.py``).

The ragged UNet forward (``true_rows``, ``ctx_true``) is held against the
JAX UNet's within 2e-5, and a ragged solo request through the engine
against the JAX engine's: equal seeds and infotext, pixels within 1 uint8
level, and the latent rows past the true rows exactly 0. The port's
bucketer runs the JAX package's ragged bucketer cases.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stable_diffusion_webui_distributed_tpu.models.configs import TINY as JTINY
from stable_diffusion_webui_distributed_tpu.models.unet import UNet as JaxUNet
from stable_diffusion_webui_distributed_tpu.ops.ragged_attention import (
    ragged_attention as jax_ragged_attention,
)
from stable_diffusion_webui_distributed_tpu.ops.ragged_attention import (
    ragged_attention_reference as jax_ragged_reference,
)
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
from stable_diffusion_webui_distributed_tpu_torch.ops import ragged_attention as ra
from stable_diffusion_webui_distributed_tpu_torch.ops.flash_attention import (
    flash_attention_reference,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import Engine
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
    b64png_to_array,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.interrupt import (
    GenerationState,
)
from stable_diffusion_webui_distributed_tpu_torch.serving.bucketer import (
    ShapeBucketer,
)
from test_pipeline import init_params

TOL = dict(rtol=2e-5, atol=2e-5)
RNG = np.random.default_rng(7)


def qkv(b, t, h, d, s=None):
    s = t if s is None else s
    return (RNG.standard_normal((b, t, h, d), np.float32),
            RNG.standard_normal((b, s, h, d), np.float32),
            RNG.standard_normal((b, s, h, d), np.float32))


def port(q, k, v, lens, mask_queries=True):
    return ra.ragged_attention(
        *(torch.from_numpy(x) for x in (q, k, v)),
        torch.tensor(lens, dtype=torch.int32),
        mask_queries=mask_queries).numpy()


def jax_kernel(q, k, v, lens, block=128):
    return np.asarray(jax_ragged_attention(
        *(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(lens, jnp.int32),
        block_q=block, block_k=block, interpret=True))


def jax_reference(q, k, v, lens, mask_queries=True):
    tl = jnp.asarray(lens, jnp.int32)
    return np.asarray(jax_ragged_reference(
        *(jnp.asarray(x) for x in (q, k, v)), tl,
        q_true_len=tl if mask_queries else None))


# -- kernel K2's plain version ---------------------------------------------

@pytest.mark.parametrize("d", [16, 32, 40, 64])
def test_matches_jax_across_head_dims(d):
    q, k, v = qkv(3, 256, 2, d)
    lens = (256, 130, 77)
    got = port(q, k, v, lens)
    np.testing.assert_allclose(got, jax_kernel(q, k, v, lens), **TOL)
    np.testing.assert_allclose(got, jax_reference(q, k, v, lens), **TOL)


# lengths that straddle tile boundaries every way a prefix can: exactly one
# tile, one past, one short, and a single valid token
@pytest.mark.parametrize("lens", [(256, 77, 130, 1), (129, 128, 127, 255)])
def test_non_divisor_true_lengths(lens):
    q, k, v = qkv(len(lens), 256, 2, 32)
    got = port(q, k, v, lens)
    np.testing.assert_allclose(got, jax_kernel(q, k, v, lens), **TOL)
    np.testing.assert_allclose(got, jax_reference(q, k, v, lens), **TOL)


def test_full_length_equals_dense():
    q, k, v = qkv(2, 128, 4, 32)
    got = port(q, k, v, (128, 128))
    dense = jax.nn.dot_product_attention(
        *(jnp.asarray(x) for x in (q, k, v)), scale=1 / 32 ** 0.5)
    np.testing.assert_allclose(got, np.asarray(dense), **TOL)
    np.testing.assert_allclose(got, flash_attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v))).numpy(), **TOL)


def test_mixed_rows_match_per_row_dense():
    """Each row's valid prefix equals dense attention over just that
    prefix, and the padded tail comes out exactly zero."""
    q, k, v = qkv(4, 256, 2, 32)
    lens = (256, 192, 100, 33)
    got = port(q, k, v, lens)
    for b, n in enumerate(lens):
        dense = jax.nn.dot_product_attention(
            jnp.asarray(q[b:b + 1, :n]), jnp.asarray(k[b:b + 1, :n]),
            jnp.asarray(v[b:b + 1, :n]), scale=1 / 32 ** 0.5)
        np.testing.assert_allclose(got[b, :n], np.asarray(dense[0]), **TOL)
        assert np.all(got[b, n:] == 0.0)


def test_padded_kv_tail_is_inert():
    """Whatever the padded K/V tail holds, the output is bit for bit the
    same: masked probabilities are exactly 0."""
    q, k, v = qkv(2, 128, 2, 16)
    lens = (100, 64)
    base = port(q, k, v, lens)
    k2, v2 = k.copy(), v.copy()
    k2[0, 100:], k2[1, 64:] = 1e4, -1e4
    v2[0, 100:], v2[1, 64:] = -1e4, 1e4
    np.testing.assert_array_equal(port(q, k2, v2, lens), base)


@pytest.mark.parametrize("lens", [(77, 154), (154, 77)])
def test_cross_attention_masks_keys_only(lens):
    """The UNet's ragged cross-attention: 2*77 context tokens, each row
    masked past its own prompt, every query row kept."""
    q, k, v = qkv(2, 96, 2, 16, s=154)
    got = port(q, k, v, lens, mask_queries=False)
    np.testing.assert_allclose(
        got, jax_reference(q, k, v, lens, mask_queries=False), **TOL)
    assert np.all(np.abs(got).sum(axis=(2, 3)) > 0)  # no row zeroed


def test_cpu_tensors_take_the_plain_path_without_a_launch():
    q, k, v = (torch.from_numpy(x) for x in qkv(2, 96, 2, 40, 50))
    lens = torch.tensor([50, 17])
    before = ra.ragged_attention.launches
    out = ra.ragged_attention(q, k, v, lens)
    ref = ra.ragged_attention_reference(q, k, v, lens, q_true_len=lens)
    assert ra.ragged_attention.launches == before
    assert torch.equal(out, ref)


def test_cpu_launches_count_on_no_path():
    before = dict(ra.ragged_attention.path_launches)
    q = torch.zeros(2, 64, 2, 40)
    ra.ragged_attention(q, q, q, torch.tensor([64, 10]))
    assert ra.ragged_attention.path_launches == before


class OtherDevice(torch.Tensor):
    """A tensor that reports a device neither the CPU nor CUDA."""

    @property
    def device(self):
        return torch.device("xpu")


def test_rejects_what_it_cannot_take():
    q = torch.zeros(2, 8, 2, 16)
    with pytest.raises(ValueError, match="true_len"):
        ra.ragged_attention(q, q, q, torch.tensor([8]))
    with pytest.raises(ValueError, match="true_len"):
        ra.ragged_attention(q, q, q, torch.tensor([8.0, 8.0]))
    # a meta tensor gets the plain version's shape (the FLOP pricer's
    # products); a device neither the CPU nor CUDA raises
    meta = torch.empty(2, 8, 2, 16, device="meta")
    out = ra.ragged_attention(meta, meta, meta, torch.tensor([8, 8]))
    assert out.device.type == "meta" and out.shape == meta.shape
    other = torch.zeros(2, 8, 2, 16).as_subclass(OtherDevice)
    with pytest.raises(ValueError, match="no ragged_attention for device"):
        ra.ragged_attention(other, other, other, torch.tensor([8, 8]))


# -- the ragged UNet forward -------------------------------------------------

@pytest.fixture(scope="module")
def params():
    return jax.device_get(jax.jit(init_params, static_argnums=0)(JTINY))


def test_ragged_unet_matches_jax(params):
    """Rows of 16, 11 and 5 valid latent rows (ceil-halved to 8, 6 and 3
    at level 1) and contexts of 77 and 154 valid tokens."""
    sds = bridge.flax_to_torch(TINY, params)
    unet = bridge.build_modules(TINY)["unet"]
    unet.load_state_dict(sds["unet"], strict=True)
    x = RNG.standard_normal((3, 16, 12, 4)).astype(np.float32)
    t = np.array([981.0, 10.5, 500.0], np.float32)
    ctx = RNG.standard_normal((3, 154, 32)).astype(np.float32)
    true_rows = np.array([16, 11, 5], np.int32)
    ctx_true = np.array([154, 77, 77], np.int32)
    want = JaxUNet(JTINY.unet).apply(
        {"params": params["unet"]}, jnp.asarray(x), jnp.asarray(t),
        jnp.asarray(ctx), true_rows=jnp.asarray(true_rows),
        ctx_true=jnp.asarray(ctx_true))
    with torch.no_grad():
        got = unet(*(torch.from_numpy(a) for a in (x, t, ctx)),
                   true_rows=torch.from_numpy(true_rows),
                   ctx_true=torch.from_numpy(ctx_true))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


# -- the ragged solo engine run ----------------------------------------------

# 48x40 in a 64x64 bucket: 20 of 32 latent rows; a prompt of two chunks
# against a one-chunk negative, so the two context lengths differ
RAGGED = dict(prompt=" ".join(["ragged cow"] * 40), negative_prompt="blurry",
              steps=4, width=64, height=64, seed=31, batch_size=2,
              override_settings={"ragged_true_wh": [48, 40]})


@pytest.fixture(scope="module")
def port_engine(params):
    return Engine(TINY, bridge.flax_to_torch(TINY, params), chunk_size=4,
                  state=GenerationState(), device="cpu")


def test_ragged_solo_run_matches_jax(params, port_engine, monkeypatch):
    latents = []
    decode = port_engine._decode_u8

    def spy(lat, width, height):
        latents.append(lat.clone())
        return decode(lat, width, height)

    monkeypatch.setattr(port_engine, "_decode_u8", spy)
    got = port_engine.generate_range(GenerationPayload(**RAGGED))
    want = JaxEngine(JTINY, params, chunk_size=4, state=JaxState()) \
        .generate_range(JaxPayload(**RAGGED))
    assert got.seeds == want.seeds == [31, 32]
    assert got.infotexts == want.infotexts
    for a, b in zip(got.images, want.images):
        pa = b64png_to_array(a).astype(np.int32)
        pb = b64png_to_array(b).astype(np.int32)
        assert pa.shape == pb.shape == (64, 64, 3)
        assert np.abs(pa - pb).max() <= 1
    (lat,) = latents
    assert lat.shape == (2, 32, 32, 4)
    assert torch.all(lat[:, 20:] == 0)
    assert lat[:, :20].std() > 0.1


def test_ragged_image_is_not_the_classic_image(port_engine):
    """The JAX package's GroupNorms and convolutions span the padded rows,
    so a ragged image (here cropped to its true size) is not the image the
    same seed gives at that size. A fact about the reference, which the
    port keeps (ROADMAP section 3)."""
    ragged = port_engine.generate_range(GenerationPayload(**RAGGED))
    classic = port_engine.generate_range(GenerationPayload(
        **{**RAGGED, "override_settings": {}, "width": 48, "height": 40}))
    a = b64png_to_array(ragged.images[0]).astype(np.int32)
    b = b64png_to_array(classic.images[0]).astype(np.int32)
    crop = ShapeBucketer.crop_ragged(a, 48, 40)
    assert crop.shape == b.shape
    assert np.abs(crop - b).mean() > 1.0


# -- the port's bucketer: the JAX package's ragged cases --------------------

def payload(**kw):
    return GenerationPayload(**{"prompt": "a cow", "steps": 4, "width": 32,
                                "height": 32, "seed": 7, **kw})


def test_bucket_shape_ragged_tallest_in_width_class():
    b = ShapeBucketer(shapes=[(64, 16), (64, 64), (96, 48)], batches=[1])
    assert b.bucket_shape_ragged(64, 20) == (64, 64)
    assert b.bucket_shape_ragged(48, 64) == (64, 64)
    assert b.bucket_shape_ragged(80, 40) == (96, 48)
    assert b.bucket_shape_ragged(80, 64) is None


def test_ragged_ladder_env_override(monkeypatch):
    monkeypatch.setenv("SDTPU_RAGGED_LADDER", "64x64")
    b = ShapeBucketer(shapes=[(32, 32), (48, 48)], batches=[1])
    assert b.bucket_shape_ragged(40, 40) == (64, 64)
    assert b.bucket_shape(40, 40) == (48, 48)


def test_padding_ratio_modes(monkeypatch):
    b = ShapeBucketer(shapes=[(64, 64)], batches=[4])
    monkeypatch.delenv("SDTPU_RAGGED", raising=False)
    assert b.padding_ratio(32, 16) == pytest.approx(8.0)
    assert b.padding_ratio(32, 16, batch=1) == pytest.approx(32.0)
    assert b.padding_ratio(64, 64, batch=3) == pytest.approx(4 / 3)
    monkeypatch.setenv("SDTPU_RAGGED", "1")
    assert b.padding_ratio(32, 16) == pytest.approx(2.0)
    assert b.padding_ratio(64, 16) == pytest.approx(1.0)


def test_marker_stamped_with_true_dims(monkeypatch):
    monkeypatch.setenv("SDTPU_RAGGED", "1")
    b = ShapeBucketer(shapes=[(64, 64)], batches=[1])
    run, bucketed = b.bucket_payload(payload(width=48, height=32),
                                     ragged=True)
    assert bucketed and (run.width, run.height) == (64, 64)
    assert run.override_settings["ragged_true_wh"] == [48, 32]
    exact, _ = b.bucket_payload(payload(width=64, height=64), ragged=True)
    assert exact.override_settings["ragged_true_wh"] == [64, 64]
    classic, _ = b.bucket_payload(payload(width=48, height=32))
    assert "ragged_true_wh" not in (classic.override_settings or {})


def test_crop_ragged_top_aligned():
    img = np.arange(64 * 64 * 3, dtype=np.int64).astype(
        np.uint8).reshape(64, 64, 3)
    back = ShapeBucketer.crop_ragged(img, 48, 32)
    assert back.shape == (32, 48, 3)
    np.testing.assert_array_equal(back, img[:32, 8:56])
    assert ShapeBucketer.crop_ragged(img, 64, 64) is img


def test_malformed_ladder_warns_and_falls_back(monkeypatch):
    monkeypatch.setenv("SDTPU_BUCKET_LADDER", "64xsixty")
    with pytest.warns(UserWarning, match="SDTPU_BUCKET_LADDER"):
        b = ShapeBucketer()
    assert b.shapes[0] == (512, 512)
