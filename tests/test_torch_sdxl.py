"""SDXL base and refiner in the port against the JAX package, on the CPU.

TINY_XL (two text encoders, added conditioning with 6 time ids) and
TINY_REFINER (one projected bigG-shaped encoder, 5 time ids with the
aesthetic score) carry the JAX package's Flax weights across with
``strict=True``. In f32: ``make_added_cond``, the UNet with added
conditioning, the bigG-shaped encoder's context and pooled output and the
dual encode must agree within 2e-5 (the tolerance of
``tests/test_torch_models.py``); TINY_XL txt2img and the TINY_XL ->
TINY_REFINER handoff at ``refiner_switch_at=0.5`` must give the JAX
engine's seeds and infotext and pixels within 1 uint8 level. A switch of
1.0 gives the base image, and an unknown refiner name runs the base model
alone. SDXL under ragged dispatch: ``tests/test_torch_ragged_sdxl.py``.
"""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stable_diffusion_webui_distributed_tpu.models.clip import (
    CLIPTextModel as JaxCLIP,
)
from stable_diffusion_webui_distributed_tpu.models.configs import (
    TINY_REFINER as JTINY_REFINER,
)
from stable_diffusion_webui_distributed_tpu.models.configs import (
    TINY_XL as JTINY_XL,
)
from stable_diffusion_webui_distributed_tpu.models.unet import UNet as JaxUNet
from stable_diffusion_webui_distributed_tpu.models.unet import (
    make_added_cond as jax_make_added_cond,
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
from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
    TINY_REFINER,
    TINY_XL,
)
from stable_diffusion_webui_distributed_tpu_torch.models.unet import (
    make_added_cond,
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
from stable_diffusion_webui_distributed_tpu_torch.serving.dispatcher import (
    ServingDispatcher,
)
from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
    METRICS,
)
from test_pipeline import init_params

ATOL = 2e-5
RNG = np.random.default_rng(21)
FAMILIES = {"tiny-xl": (JTINY_XL, TINY_XL),
            "tiny-refiner": (JTINY_REFINER, TINY_REFINER)}
REFINER = "tiny-ref"
BASE_REQUEST = dict(prompt="a (red:1.2) cow", negative_prompt="blurry",
                    steps=6, width=32, height=32, batch_size=2, seed=9,
                    cfg_scale=5.0)


@pytest.fixture(scope="module")
def flax_params():
    return {name: jax.device_get(jax.jit(init_params, static_argnums=0)(jf))
            for name, (jf, _) in FAMILIES.items()}


@pytest.fixture(scope="module")
def modules(flax_params):
    out = {}
    for name, (_, fam) in FAMILIES.items():
        sds = bridge.flax_to_torch(fam, flax_params[name])
        mods = bridge.build_modules(fam)
        for comp, module in mods.items():
            module.load_state_dict(sds[comp], strict=True)
            module.eval()
        out[name] = mods
    return out


@pytest.mark.parametrize("name,components", [
    ("tiny-xl", ["text_encoder", "text_encoder_2", "unet", "vae",
                 "vae_encoder"]),
    ("tiny-refiner", ["text_encoder", "unet", "vae", "vae_encoder"]),
])
def test_flax_trees_load_strict(flax_params, name, components):
    fam = FAMILIES[name][1]
    converted = bridge.flax_to_torch(fam, flax_params[name])
    seeded = bridge.init_seeded(fam, seed=0, device="cpu")
    assert sorted(converted) == sorted(seeded) == sorted(components)
    for comp, module in bridge.build_modules(fam).items():
        missing, unexpected = module.load_state_dict(converted[comp],
                                                     strict=True)
        assert not missing and not unexpected
        assert {n: tuple(t.shape) for n, t in seeded[comp].items()} == \
            {n: tuple(t.shape) for n, t in converted[comp].items()}
    assert "add_fc1.weight" in converted["unet"]


def test_make_added_cond_matches_jax():
    pooled = RNG.standard_normal((3, 48)).astype(np.float32)
    ids = np.array([[1024, 1024, 0, 0, 1024, 1024], [768, 512, 0, 0, 768,
                                                     512],
                    [32, 32, 0, 0, 32, 32]], np.float32)
    want = jax_make_added_cond(jnp.asarray(pooled), jnp.asarray(ids), 8)
    got = make_added_cond(torch.from_numpy(pooled), torch.from_numpy(ids), 8)
    assert tuple(got.shape) == (3, 48 + 6 * 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_unet_with_added_cond_matches_jax(flax_params, modules, name):
    jfam, fam = FAMILIES[name]
    u = fam.unet
    x = RNG.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([981.0, 10.5], np.float32)
    ctx = RNG.standard_normal((2, 154, u.cross_attention_dim)).astype(
        np.float32)
    added = RNG.standard_normal((2, u.projection_input_dim)).astype(
        np.float32)
    want = JaxUNet(jfam.unet).apply(
        {"params": flax_params[name]["unet"]}, jnp.asarray(x),
        jnp.asarray(t), jnp.asarray(ctx), jnp.asarray(added))
    with torch.no_grad():
        got = modules[name]["unet"](
            *(torch.from_numpy(a) for a in (x, t, ctx, added)))
    assert got.shape == (2, 16, 16, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    with pytest.raises(ValueError, match="added_cond"):
        modules[name]["unet"](*(torch.from_numpy(a) for a in (x, t, ctx)))


@pytest.mark.parametrize("name,component", [
    ("tiny-xl", "text_encoder_2"), ("tiny-xl", "text_encoder"),
    ("tiny-refiner", "text_encoder")])
@pytest.mark.parametrize("skip", [None, 0])
def test_text_encoders_match_jax(flax_params, modules, name, component,
                                 skip):
    """The bigG-shaped encoder: gelu, the raw penultimate state (SDXL's
    default skip, no final LayerNorm on it) and the projected pooled EOS
    state."""
    jfam = FAMILIES[name][0]
    cfg = getattr(jfam, component)
    ids = RNG.integers(0, cfg.vocab_size, (2, 77))
    ids[:, -1] = cfg.vocab_size - 1  # EOS is the largest id
    ctx_j, pooled_j = JaxCLIP(cfg).apply(
        {"params": flax_params[name][component]}, jnp.asarray(ids, jnp.int32),
        skip=skip)
    with torch.no_grad():
        ctx_t, pooled_t = modules[name][component](torch.from_numpy(ids),
                                                   skip=skip)
    assert tuple(pooled_t.shape) == (2, cfg.projection_dim or
                                     cfg.hidden_size)
    np.testing.assert_allclose(ctx_t.numpy(), np.asarray(ctx_j), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(pooled_t.numpy(), np.asarray(pooled_j),
                               rtol=0, atol=ATOL)


# -- engines ------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_engines(flax_params):
    refiner = JaxEngine(JTINY_REFINER, flax_params["tiny-refiner"],
                        chunk_size=4, state=JaxState(), model_name=REFINER)
    base = JaxEngine(JTINY_XL, flax_params["tiny-xl"], chunk_size=4,
                     state=JaxState(),
                     engine_provider=lambda n: refiner if n == REFINER
                     else None)
    return base, refiner


@pytest.fixture(scope="module")
def port_engines(flax_params):
    refiner = Engine(TINY_REFINER, bridge.flax_to_torch(
        TINY_REFINER, flax_params["tiny-refiner"]), chunk_size=4,
        state=GenerationState(), model_name=REFINER, device="cpu")
    base = Engine(TINY_XL, bridge.flax_to_torch(
        TINY_XL, flax_params["tiny-xl"]), chunk_size=4,
        state=GenerationState(), device="cpu",
        engine_provider=lambda n: refiner if n == REFINER else None)
    return base, refiner


def pixels(b64):
    return b64png_to_array(b64).astype(np.int32)


def assert_same_images(got, want):
    assert got.seeds == want.seeds
    assert got.infotexts == want.infotexts
    assert len(got.images) == len(want.images)
    for a, b in zip(got.images, want.images):
        pa, pb = pixels(a), pixels(b)
        assert pa.shape == pb.shape
        assert np.abs(pa - pb).max() <= 1
        assert pa.std() > 1.0  # not a constant image


def test_dual_encode_matches_jax(jax_engines, port_engines):
    """The two encoders' contexts join on the channel axis in f32 with the
    chunk mean restored; the pooled output is the second encoder's, from
    the first chunk."""
    kw = dict(prompt=" ".join(["long"] * 90) + " (tail:0.6)",
              negative_prompt="short", clip_skip=2)
    (ju, jc), (jpu, jpc) = jax_engines[0].encode_prompts(JaxPayload(**kw))
    with torch.no_grad():
        (tu, tc), (tpu, tpc) = port_engines[0].encode_prompts(
            GenerationPayload(**kw))
    assert tuple(tc.shape) == (1, 154, 80) and tuple(tpc.shape) == (1, 48)
    for got, want in ((tu, ju), (tc, jc), (tpu, jpu), (tpc, jpc)):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                                   rtol=0, atol=ATOL)


@pytest.mark.parametrize("sampler", ["Euler a", "DPM++ 2M Karras"])
def test_sdxl_txt2img_matches_jax(jax_engines, port_engines, sampler):
    body = dict(BASE_REQUEST, sampler_name=sampler)
    want = jax_engines[0].txt2img(JaxPayload(**body))
    got = port_engines[0].txt2img(GenerationPayload(**body))
    assert_same_images(got, want)


@pytest.mark.parametrize("sampler", ["Euler a", "DPM++ 2M", "DPM adaptive"])
def test_refiner_handoff_matches_jax(jax_engines, port_engines, sampler):
    body = dict(BASE_REQUEST, sampler_name=sampler,
                refiner_checkpoint=REFINER, refiner_switch_at=0.5)
    want = jax_engines[0].txt2img(JaxPayload(**body))
    got = port_engines[0].txt2img(GenerationPayload(**body))
    assert_same_images(got, want)
    plain = port_engines[0].txt2img(GenerationPayload(
        **dict(BASE_REQUEST, sampler_name=sampler)))
    assert got.images != plain.images  # the refiner ran


def test_refiner_subrange_equals_whole_batch_rows(port_engines):
    p = GenerationPayload(**dict(BASE_REQUEST, refiner_checkpoint=REFINER,
                                 refiner_switch_at=0.5))
    whole = port_engines[0].generate_range(p)
    one = port_engines[0].generate_range(p, 1, 1)
    assert one.images == whole.images[1:]
    assert one.infotexts == whole.infotexts[1:]


@pytest.mark.parametrize("extra", [
    {"refiner_checkpoint": REFINER, "refiner_switch_at": 1.0},
    {"refiner_checkpoint": "missing", "refiner_switch_at": 0.5},
])
def test_base_alone_when_the_refiner_does_not_run(jax_engines,
                                                  port_engines, extra):
    plain = port_engines[0].txt2img(GenerationPayload(**BASE_REQUEST))
    got = port_engines[0].txt2img(GenerationPayload(**BASE_REQUEST, **extra))
    assert got.images == plain.images
    want = jax_engines[0].txt2img(JaxPayload(**BASE_REQUEST, **extra))
    assert_same_images(got, want)


def test_interrupt_in_the_base_phase_skips_the_refiner(port_engines):
    base, refiner = port_engines
    calls, armed = [], [True]
    refiner_denoise = refiner._denoise

    def spy(*args, **kwargs):
        calls.append(kwargs.get("start_step"))
        return refiner_denoise(*args, **kwargs)

    def listener(progress):
        if armed[0] and progress.sampling_step >= 2:
            base.state.flag.interrupt()

    refiner._denoise = spy
    base.state.add_listener(listener)
    p = GenerationPayload(**dict(BASE_REQUEST, refiner_checkpoint=REFINER,
                                 refiner_switch_at=0.5, batch_size=1))
    try:
        base.state.begin_request()
        out = base.generate_range(p)
        assert calls == [] and len(out.images) == 1
        armed[0] = False
        base.state.begin_request()
        base.generate_range(p)
        assert calls == [3]  # int(6 * 0.5)
    finally:
        armed[0] = False
        del refiner._denoise
        base.state.begin_request()


def test_coalesced_sdxl_rows_keep_their_own_conditioning(port_engines,
                                                         monkeypatch):
    """Two SDXL requests with different prompts share one dispatch: each
    row carries its own context and pooled conditioning, so each image
    equals its request run alone within 1 uint8 level, with its own seed
    and infotext."""
    monkeypatch.delenv("SDTPU_RAGGED", raising=False)
    base = port_engines[0]
    disp = ServingDispatcher(
        base, bucketer=ShapeBucketer(shapes=[(32, 32)], batches=[2]),
        window=0.5)
    payloads = [GenerationPayload(**dict(BASE_REQUEST, batch_size=1,
                                         prompt=p, seed=30 + i))
                for i, p in enumerate(["a red cow", "a (blue:1.4) horse"])]
    results = [None, None]

    def run(i):
        results[i] = disp.submit(payloads[i])

    METRICS.clear()
    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        assert not t.is_alive()
    s = METRICS.summary()
    assert (s["dispatches"], s["coalesced_requests"]) == (1, 2)
    for got, p in zip(results, payloads):
        want = base.generate_range(p)
        assert got.seeds == want.seeds == [p.seed]
        assert got.infotexts == want.infotexts
        assert np.abs(pixels(got.images[0])
                      - pixels(want.images[0])).max() <= 1
