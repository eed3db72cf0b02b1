"""The port's hires fix against the JAX engine's.

TINY engines of both packages on the same Flax weights, in f32 on the CPU
(32x32 first passes, 64x64 second passes by default). For the same
``enable_hr`` request both must give the same seeds and infotext and pixels
within 1 uint8 level: every latent upscaler name, fractional scales and an
explicit target size, a second pass of its own step count, a batch and a
sub-range of it, a name that resolves to no file (the bytes of "Latent",
with a warning), the image-space path through an RRDBNet file that the
port's registry scans, two-evaluation and adaptive samplers, a ControlNet
unit, an inpainting family and the SDXL refiner handoff inside both passes.
The server answers a hires request through its dispatcher, and the CPU path
launches no kernel.
"""

import json
import logging
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax

from stable_diffusion_webui_distributed_tpu.models import controlnet as jcn
from stable_diffusion_webui_distributed_tpu.models import esrgan as jesrgan
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
from stable_diffusion_webui_distributed_tpu_torch import bridge, cli
from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
    TINY,
    TINY_INPAINT,
    TINY_REFINER,
    TINY_XL,
)
from stable_diffusion_webui_distributed_tpu_torch.ops import flash_attention
from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import Engine
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
    array_to_b64png,
    b64png_to_array,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.registry import (
    ModelRegistry,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.interrupt import (
    GenerationState,
)
from stable_diffusion_webui_distributed_tpu_torch.server.api import ApiServer
from test_adapters import make_ldm_controlnet
from test_esrgan import make_rrdb_sd
from test_pipeline import init_params

CN = "cn-test"
REFINER = "tiny-ref"
UPSCALER = "Tiny_x4plus"

BASE = dict(prompt="a cow (in a field:1.2)", negative_prompt="blurry",
            steps=3, width=32, height=32, seed=11, subseed=4,
            enable_hr=True, hr_scale=2.0, denoising_strength=0.6)


def _pattern(h, w):
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([(x * 9) % 256, (y * 7) % 256, ((x + y) * 4) % 256], -1)
    return img.astype(np.uint8)


HINT = array_to_b64png(_pattern(48, 48))

REQUESTS = {
    "latent-2x": dict(BASE),
    "latent-1.5x": dict(BASE, hr_scale=1.5),
    # both sizes given: 64 wide, 40 tall; one alone falls back to hr_scale
    "resize-xy": dict(BASE, hr_resize_x=64, hr_resize_y=40),
    "resize-x-only": dict(BASE, hr_resize_x=48, hr_scale=1.5),
    "second-pass-steps": dict(BASE, hr_second_pass_steps=4,
                              denoising_strength=0.75),
    "batch-2": dict(BASE, batch_size=2),
    **{f"name-{n}": dict(BASE, hr_upscaler=n, hr_scale=1.5)
       for n in ("Latent", "Latent (antialiased)", "Latent (nearest)",
                 "Latent (nearest-exact)", "Latent (bicubic)")},
    "heun": dict(BASE, sampler_name="Heun", steps=2),
    "dpm-adaptive": dict(BASE, sampler_name="DPM adaptive"),
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
def model_dir(tmp_path_factory):
    """A model directory whose ``ESRGAN/`` holds one tiny RRDBNet."""
    root = tmp_path_factory.mktemp("models")
    os.makedirs(root / "ESRGAN")
    from safetensors.numpy import save_file

    save_file(make_rrdb_sd(), str(root / "ESRGAN" / f"{UPSCALER}.safetensors"))
    return str(root)


@pytest.fixture(scope="module")
def jax_engine(params, cn_tree, model_dir):
    path = os.path.join(model_dir, "ESRGAN", f"{UPSCALER}.safetensors")
    upscale = jesrgan.make_upscaler(jesrgan.load_esrgan(path))
    return JaxEngine(JTINY, params, chunk_size=4, state=JaxState(),
                     controlnet_provider=lambda n: cn_tree if n == CN
                     else None,
                     upscaler_provider=lambda n: upscale if n == UPSCALER
                     else None)


@pytest.fixture(scope="module")
def port(params, cn_tree, model_dir):
    sd = bridge.controlnet_flax_to_torch(cn_tree)
    registry = ModelRegistry(model_dir, device="cpu")
    return Engine(TINY, bridge.flax_to_torch(TINY, params), chunk_size=4,
                  state=GenerationState(), device="cpu",
                  controlnet_provider=lambda n: sd if n == CN else None,
                  upscaler_provider=registry.upscaler_provider)


def pixels(b64):
    return b64png_to_array(b64).astype(np.int32)


def assert_same_images(got, want, size):
    assert got.seeds == want.seeds
    assert got.subseeds == want.subseeds
    assert got.infotexts == want.infotexts
    assert len(got.images) == len(want.images)
    for a, b in zip(got.images, want.images):
        pa, pb = pixels(a), pixels(b)
        assert pa.shape == pb.shape == (size[1], size[0], 3)
        assert np.abs(pa - pb).max() <= 1
        assert pa.std() > 1.0  # not a constant image


def target(body):
    if body.get("hr_resize_x") and body.get("hr_resize_y"):
        return body["hr_resize_x"], body["hr_resize_y"]
    s = body["hr_scale"]
    f = 2  # TINY's VAE factor
    return (int(body["width"] * s) // f * f, int(body["height"] * s) // f * f)


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_hires_matches_jax(jax_engine, port, name):
    body = REQUESTS[name]
    want = jax_engine.txt2img(JaxPayload(**body))
    got = port.txt2img(GenerationPayload(**body))
    assert_same_images(got, want, target(body))
    assert f"Size: {target(body)[0]}x{target(body)[1]}" in got.infotexts[0]


def test_latent_names_pick_their_kernels(port):
    """The five latent names give three images: bilinear (plain and
    antialiased), nearest (both spellings) and bicubic."""
    got = {n: port.txt2img(GenerationPayload(**REQUESTS[f"name-{n}"]))
           .images[0]
           for n in ("Latent", "Latent (antialiased)", "Latent (nearest)",
                     "Latent (nearest-exact)", "Latent (bicubic)")}
    assert got["Latent"] == got["Latent (antialiased)"]
    assert got["Latent (nearest)"] == got["Latent (nearest-exact)"]
    assert len(set(got.values())) == 3


def test_unknown_upscaler_falls_back_to_latent_bilinear(port, caplog):
    latent = port.txt2img(GenerationPayload(**BASE))
    with caplog.at_level(logging.WARNING):
        got = port.txt2img(GenerationPayload(**BASE,
                                             hr_upscaler="R-ESRGAN 4x+"))
    assert got.images == latent.images
    assert any("'R-ESRGAN 4x+' unavailable" in r.getMessage()
               for r in caplog.records)


def test_image_space_upscaler_matches_jax(jax_engine, port):
    body = dict(BASE, hr_upscaler=UPSCALER)
    want = jax_engine.txt2img(JaxPayload(**body))
    got = port.txt2img(GenerationPayload(**body))
    assert_same_images(got, want, (64, 64))
    latent = port.txt2img(GenerationPayload(**BASE))
    assert got.images != latent.images
    again = port.txt2img(GenerationPayload(**body))
    assert again.images == got.images


def test_image_space_micro_batches_give_the_same_rows(port, monkeypatch):
    """Under a decode pixel budget of one 64x64 image the image-space path
    runs a batch of 2 one row at a time; the rows are those of one
    micro-batch of 2 (a row's numbers do not depend on its batch mate on
    the CPU)."""
    body = dict(BASE, hr_upscaler=UPSCALER, batch_size=2)
    whole = port.txt2img(GenerationPayload(**body))
    monkeypatch.setenv("SDTPU_DECODE_PIXELS", str(64 * 64))
    sliced = port.txt2img(GenerationPayload(**body))
    for a, b in zip(sliced.images, whole.images):
        assert np.abs(pixels(a) - pixels(b)).max() <= 1


def test_subrange_equals_whole_batch_rows(port):
    body = REQUESTS["batch-2"]
    whole = port.txt2img(GenerationPayload(**body))
    one = port.generate_range(GenerationPayload(**body), 1, 1)
    assert one.images == whole.images[1:]
    assert one.seeds == whole.seeds[1:] == [12]


def test_controlnet_unit_in_both_passes_matches_jax(jax_engine, port):
    body = dict(BASE, alwayson_scripts={"controlnet": {"args": [{
        "enabled": True, "image": HINT, "module": "none", "model": CN,
        "weight": 0.8, "guidance_start": 0.0, "guidance_end": 0.8}]}})
    want = jax_engine.txt2img(JaxPayload(**body))
    got = port.txt2img(GenerationPayload(**body))
    assert_same_images(got, want, (64, 64))
    plain = port.txt2img(GenerationPayload(**BASE))
    assert got.images != plain.images


def test_cpu_hires_launches_no_kernel(port):
    before = flash_attention.flash_attention.launches
    port.txt2img(GenerationPayload(**dict(BASE, steps=2)))
    assert flash_attention.flash_attention.launches == before


def test_inpainting_family_matches_jax():
    flax = jax.device_get(jax.jit(init_params, static_argnums=0)(
        JTINY_INPAINT))
    jax_engine = JaxEngine(JTINY_INPAINT, flax, chunk_size=4,
                           state=JaxState())
    port = Engine(TINY_INPAINT, bridge.flax_to_torch(TINY_INPAINT, flax),
                  chunk_size=4, state=GenerationState(), device="cpu")
    body = dict(BASE, steps=2)
    want = jax_engine.txt2img(JaxPayload(**body))
    got = port.txt2img(GenerationPayload(**body))
    assert_same_images(got, want, (64, 64))
    # the blank conditioning at both passes' sizes
    assert sorted(port._blank_cond_cache) == [(1, 32, 32), (1, 64, 64)]


def test_sdxl_refiner_hands_over_in_both_passes():
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
    body = dict(BASE, steps=4, hr_scale=1.5, refiner_checkpoint=REFINER,
                refiner_switch_at=0.5)
    want = jbase.txt2img(JaxPayload(**body))
    got = base.txt2img(GenerationPayload(**body))
    assert_same_images(got, want, (48, 48))
    alone = base.txt2img(GenerationPayload(**dict(body,
                                                  refiner_switch_at=1.0)))
    assert alone.images != got.images


def call(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def test_server_answers_hires_through_the_dispatcher(port, monkeypatch):
    monkeypatch.setenv("SDTPU_BUCKET_LADDER", "32x32")
    server = ApiServer(port, port=0).start()
    try:
        assert server.dispatcher is not None
        body = dict(BASE, steps=2)
        status, resp = call(server.port, "/sdapi/v1/txt2img", body)
    finally:
        server.stop()
    assert status == 200
    assert pixels(resp["images"][0]).shape == (64, 64, 3)
    assert "Size: 64x64" in json.loads(resp["info"])["infotexts"][0]
    want = port.txt2img(GenerationPayload(**body))
    assert resp["images"] == want.images


def test_cli_hands_the_registry_upscalers_to_the_engine(model_dir, tmp_path):
    args = cli.build_parser().parse_args([
        "generate", "--prompt", "x", "--hires", "--hires-scale", "1.5",
        "--family", "tiny", "--device", "cpu", "--model-dir", model_dir,
        "--distributed-config", str(tmp_path / "fleet.json")])
    world, registry = cli._build_world(args)
    engine = world.master().backend.engine
    assert engine.upscaler_provider == registry.upscaler_provider
    assert engine.upscaler_provider(UPSCALER) is not None
    assert args.hires and args.hires_scale == 1.5
