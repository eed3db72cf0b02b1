"""The port's img2img, inpainting and ControlNet against the JAX engine's.

TINY engines of both packages on the same Flax weights, in f32 on the CPU;
ControlNet units run a ControlNet converted from a synthetic ldm checkpoint
(``make_ldm_controlnet``), handed to the JAX engine as its Flax tree and to
the port as ``bridge.controlnet_flax_to_torch`` of it. For the same request
both must give the same seeds and infotext and pixels within 1 uint8 level
(they sum in different orders). Inside the port: a unit at weight 0, a unit
whose window misses every step and a ControlNet with zero output
convolutions give the bytes of the request without the unit, and a
sub-range gives the whole batch's rows.
"""

import base64
import io

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from stable_diffusion_webui_distributed_tpu.models import controlnet as jcn
from stable_diffusion_webui_distributed_tpu.models.configs import TINY as JTINY
from stable_diffusion_webui_distributed_tpu.models.configs import (
    TINY_INPAINT as JTINY_INPAINT,
)
from stable_diffusion_webui_distributed_tpu.models.configs import (
    TINY_REFINER as JTINY_REFINER,
)
from stable_diffusion_webui_distributed_tpu.models.configs import (
    TINY_XL as JTINY_XL,
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
    TINY,
    TINY_INPAINT,
    TINY_REFINER,
    TINY_XL,
)
from stable_diffusion_webui_distributed_tpu_torch.ops import flash_attention
from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import (
    Engine,
    parse_controlnet_units,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
    array_to_b64png,
    b64png_to_array,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.interrupt import (
    GenerationState,
)
from test_adapters import make_ldm_controlnet
from test_pipeline import init_params

CN = "cn-test"
REFINER = "tiny-ref"


def _pattern(h, w):
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([(x * 9) % 256, (y * 7) % 256, ((x + y) * 4) % 256], -1)
    img[h // 4: h // 2, w // 3: 2 * w // 3] = (250, 40, 30)
    return img.astype(np.uint8)


INIT = array_to_b64png(_pattern(32, 32))
INIT_OTHER_SIZE = array_to_b64png(_pattern(40, 24))
_mask = np.zeros((32, 32, 3), np.uint8)
_mask[16:] = 255
MASK = array_to_b64png(_mask)
HINT = array_to_b64png(_pattern(48, 48))

BASE = dict(prompt="a cow (in a field:1.2)", negative_prompt="blurry",
            steps=6, width=32, height=32, seed=11, subseed=4,
            denoising_strength=0.6)


def unit(**kw):
    return {"controlnet": {"args": [{
        "enabled": True, "image": HINT, "module": "canny", "model": CN,
        "weight": 1.0, **kw}]}}


IMG2IMG = {
    "euler-a-batch2": dict(BASE, init_images=[INIT], batch_size=2),
    "heun": dict(BASE, init_images=[INIT], sampler_name="Heun"),
    "dpm-adaptive": dict(BASE, init_images=[INIT],
                         sampler_name="DPM adaptive", steps=4),
    "init-of-another-size": dict(BASE, init_images=[INIT_OTHER_SIZE]),
    **{f"inpaint-fill-{f}": dict(BASE, init_images=[INIT], mask=MASK,
                                 inpainting_fill=f, mask_blur=2)
       for f in range(4)},
    "inpaint-dpm-adaptive": dict(BASE, init_images=[INIT], mask=MASK,
                                 sampler_name="DPM adaptive", steps=4),
    "controlnet": dict(BASE, init_images=[INIT], batch_size=2,
                       alwayson_scripts=unit()),
    "controlnet-window": dict(BASE, init_images=[INIT],
                              alwayson_scripts=unit(guidance_start=0.4,
                                                    guidance_end=0.7,
                                                    weight=0.8)),
}
TXT2IMG = {
    "controlnet": dict(BASE, alwayson_scripts=unit(module="none")),
    # a window that catches the first attempts only, as the JAX package
    # gates DPM adaptive's attempts
    "controlnet-adaptive-window": dict(
        BASE, sampler_name="DPM adaptive", steps=4,
        alwayson_scripts=unit(guidance_start=0.0, guidance_end=0.6)),
}


@pytest.fixture(scope="module")
def params():
    return jax.device_get(jax.jit(init_params, static_argnums=0)(JTINY))


@pytest.fixture(scope="module")
def cn_tree():
    cfg = JTINY.unet
    return jax.device_get(jcn.convert_controlnet(make_ldm_controlnet(cfg),
                                                 cfg))


@pytest.fixture(scope="module")
def jax_engine(params, cn_tree):
    return JaxEngine(JTINY, params, chunk_size=4, state=JaxState(),
                     controlnet_provider=lambda n: cn_tree if n == CN
                     else None)


@pytest.fixture(scope="module")
def port(params, cn_tree):
    sd = bridge.controlnet_flax_to_torch(cn_tree)
    return Engine(TINY, bridge.flax_to_torch(TINY, params), chunk_size=4,
                  state=GenerationState(), device="cpu",
                  controlnet_provider=lambda n: sd if n == CN else None)


def pixels(b64):
    return b64png_to_array(b64).astype(np.int32)


def assert_same_images(got, want, size=(32, 32)):
    assert got.seeds == want.seeds
    assert got.subseeds == want.subseeds
    assert got.infotexts == want.infotexts
    assert len(got.images) == len(want.images)
    for a, b in zip(got.images, want.images):
        pa, pb = pixels(a), pixels(b)
        assert pa.shape == pb.shape == (size[1], size[0], 3)
        assert np.abs(pa - pb).max() <= 1
        assert pa.std() > 1.0  # not a constant image


@pytest.mark.parametrize("name", sorted(IMG2IMG))
def test_img2img_matches_jax(jax_engine, port, name):
    want = jax_engine.img2img(JaxPayload(**IMG2IMG[name]))
    got = port.img2img(GenerationPayload(**IMG2IMG[name]))
    assert_same_images(got, want)


@pytest.mark.parametrize("name", sorted(TXT2IMG))
def test_txt2img_with_controlnet_matches_jax(jax_engine, port, name):
    want = jax_engine.txt2img(JaxPayload(**TXT2IMG[name]))
    got = port.txt2img(GenerationPayload(**TXT2IMG[name]))
    assert_same_images(got, want)


def test_unit_changes_the_image_and_windows_gate_it(port):
    body = dict(BASE, init_images=[INIT])
    plain = port.img2img(GenerationPayload(**body))
    full = port.img2img(GenerationPayload(**body, alwayson_scripts=unit()))
    window = port.img2img(GenerationPayload(
        **body, alwayson_scripts=unit(guidance_start=0.4,
                                      guidance_end=0.7)))
    assert len({plain.images[0], full.images[0], window.images[0]}) == 3


@pytest.mark.parametrize("extra", [
    {"weight": 0.0},
    # img2img at strength 0.6 runs steps 3-5 of 6: (i + 0.5) / 6 >= 0.58
    {"guidance_start": 0.0, "guidance_end": 0.5},
    {"enabled": False},
    {"model": "no-such-controlnet"},
])
def test_inactive_unit_gives_the_bytes_of_no_unit(port, extra):
    body = dict(BASE, init_images=[INIT], batch_size=2)
    plain = port.img2img(GenerationPayload(**body))
    got = port.img2img(GenerationPayload(**body,
                                         alwayson_scripts=unit(**extra)))
    assert got.images == plain.images


def test_zero_init_controlnet_gives_the_bytes_of_no_unit(params):
    """A Flax-initialised ControlNet has zero output convolutions, so its
    residuals are zero and the image is that of no unit, byte for byte."""
    cfg = JTINY.unet
    lat = np.zeros((1, 16, 16, 4), np.float32)
    tree = jax.device_get(jcn.ControlNet(cfg).init(
        jax.random.key(1), lat, np.ones((1,), np.float32),
        np.zeros((1, 77, cfg.cross_attention_dim), np.float32),
        np.zeros((1, 128, 128, 3), np.float32))["params"])
    sd = bridge.controlnet_flax_to_torch(tree)
    engine = Engine(TINY, bridge.flax_to_torch(TINY, params), chunk_size=4,
                    state=GenerationState(), device="cpu",
                    controlnet_provider=lambda n: sd)
    plain = engine.txt2img(GenerationPayload(**BASE))
    got = engine.txt2img(GenerationPayload(**BASE, alwayson_scripts=unit()))
    assert got.images == plain.images


def test_controlnet_loads_once_per_name(params, cn_tree):
    calls = []
    sd = bridge.controlnet_flax_to_torch(cn_tree)

    def provider(name):
        calls.append(name)
        return sd if name == CN else None

    engine = Engine(TINY, bridge.flax_to_torch(TINY, params), chunk_size=4,
                    state=GenerationState(), device="cpu",
                    controlnet_provider=provider)
    body = dict(BASE, steps=2, alwayson_scripts=unit())
    first = engine.txt2img(GenerationPayload(**body))
    again = engine.txt2img(GenerationPayload(**body))
    assert calls == [CN]
    assert again.images == first.images


def test_subrange_equals_whole_batch_rows(port):
    body = IMG2IMG["controlnet"]
    whole = port.img2img(GenerationPayload(**body))
    one = port.generate_range(GenerationPayload(**body), 1, 1, "img2img")
    assert one.images == whole.images[1:]
    assert one.seeds == whole.seeds[1:] == [12]


def test_cpu_img2img_launches_no_kernel(port):
    before = flash_attention.flash_attention.launches
    port.img2img(GenerationPayload(**dict(BASE, steps=2,
                                          init_images=[INIT])))
    assert flash_attention.flash_attention.launches == before


def test_inpaint_pins_the_unmasked_latent(port):
    """Outside the mask the last step pins the latent to the init latent
    noised to sigma 0: the rows far above the mask are the init latent,
    exactly."""
    seen = []
    decode = port._decode_u8

    def capture(latents, width, height):
        seen.append(latents.clone())
        return decode(latents, width, height)

    port._decode_u8 = capture
    try:
        port.img2img(GenerationPayload(**IMG2IMG["inpaint-fill-1"]))
    finally:
        del port._decode_u8
    init = torch.from_numpy(b64png_to_array(INIT).astype(np.float32) / 255.0)
    init_lat = port.run_on_device(port._encode_images, init[None])
    # the mask starts at latent row 8; blurred by 2 px (3 passes) and
    # resized, it reaches up to row 4
    assert torch.equal(seen[0][:, :4], init_lat[:, :4])
    assert not torch.equal(seen[0][:, 8:], init_lat[:, 8:])


def test_mikubill_mask_parse_matches_jax(jax_engine):
    mask = np.zeros((16, 16), np.uint8)
    mask[:8] = 255
    body = dict(prompt="x", steps=2, width=32, height=32, seed=1,
                alwayson_scripts={"ControlNet": {"args": [
                    {"enabled": True,
                     "image": {"image": HINT, "mask": array_to_b64png(mask)},
                     "module": "inpaint", "model": CN},
                    {"enabled": True, "input_image": HINT, "model": CN},
                    {"enabled": False, "image": HINT, "model": CN},
                    {"enabled": True, "model": CN}]}})
    want = jax_engine._parse_controlnet_units(JaxPayload(**body))
    got = parse_controlnet_units(GenerationPayload(**body))
    assert got == want
    assert len(got) == 2 and got[0]["mask"] is not None


def test_data_url_init_image(port):
    raw = base64.b64decode(INIT)
    url = "data:image/png;base64," + base64.b64encode(raw).decode()
    body = dict(BASE, steps=2)
    a = port.img2img(GenerationPayload(**body, init_images=[INIT]))
    b = port.img2img(GenerationPayload(**body, init_images=[url]))
    assert a.images == b.images
    img = Image.open(io.BytesIO(base64.b64decode(a.images[0])))
    assert img.size == (32, 32)


# -- an inpainting family -------------------------------------------------------

@pytest.fixture(scope="module")
def inpaint_params():
    return jax.device_get(jax.jit(init_params, static_argnums=0)(
        JTINY_INPAINT))


@pytest.mark.parametrize("name,body", [
    ("txt2img", dict(BASE)),
    ("img2img", dict(BASE, init_images=[INIT])),
    ("masked-img2img", dict(BASE, init_images=[INIT], mask=MASK,
                            inpainting_fill=0)),
    # the ControlNet sees the bare 4-channel latent, the UNet all 9
    ("masked-img2img-controlnet", dict(BASE, init_images=[INIT], mask=MASK,
                                       inpainting_fill=1,
                                       alwayson_scripts=unit())),
])
def test_inpainting_family_matches_jax(inpaint_params, cn_tree, name, body):
    jax_engine = JaxEngine(JTINY_INPAINT, inpaint_params, chunk_size=4,
                           state=JaxState(),
                           controlnet_provider=lambda n: cn_tree)
    sd = bridge.controlnet_flax_to_torch(cn_tree)
    port = Engine(TINY_INPAINT,
                  bridge.flax_to_torch(TINY_INPAINT, inpaint_params),
                  chunk_size=4, state=GenerationState(), device="cpu",
                  controlnet_provider=lambda n: sd)
    run = "txt2img" if name == "txt2img" else "img2img"
    want = getattr(jax_engine, run)(JaxPayload(**body))
    got = getattr(port, run)(GenerationPayload(**body))
    assert_same_images(got, want)
    if name == "txt2img":
        assert list(port._blank_cond_cache) == [(1, 32, 32)]


# -- the SDXL refiner handoff ---------------------------------------------------

def test_sdxl_img2img_hands_over_to_the_refiner():
    flax = {n: jax.device_get(jax.jit(init_params, static_argnums=0)(f))
            for n, f in (("xl", JTINY_XL), ("ref", JTINY_REFINER))}
    jref = JaxEngine(JTINY_REFINER, flax["ref"], chunk_size=4,
                     state=JaxState(), model_name=REFINER)
    jbase = JaxEngine(JTINY_XL, flax["xl"], chunk_size=4, state=JaxState(),
                      engine_provider=lambda n: jref if n == REFINER
                      else None)
    ref = Engine(TINY_REFINER, bridge.flax_to_torch(TINY_REFINER,
                                                    flax["ref"]),
                 chunk_size=4, state=GenerationState(), model_name=REFINER,
                 device="cpu")
    base = Engine(TINY_XL, bridge.flax_to_torch(TINY_XL, flax["xl"]),
                  chunk_size=4, state=GenerationState(), device="cpu",
                  engine_provider=lambda n: ref if n == REFINER else None)
    body = dict(BASE, init_images=[INIT], batch_size=2,
                refiner_checkpoint=REFINER, refiner_switch_at=0.7)
    want = jbase.img2img(JaxPayload(**body))
    got = base.img2img(GenerationPayload(**body))
    assert_same_images(got, want)
    alone = base.img2img(GenerationPayload(**dict(body,
                                                  refiner_switch_at=1.0)))
    assert alone.images != got.images


def test_engine_without_device_raises_when_no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bridge.init_seeded_controlnet(TINY, 0)
