"""The port's txt2img engine against the JAX package's, on TINY on the CPU.

Both engines hold the same Flax weights (the port's through
``bridge.flax_to_torch``) and run in f32. For the same request they must give
the same seeds and infotext, and decoded pixels within 1 uint8 level (the
two sum in different orders; a value near a rounding edge may land on the
other side). Pixels are compared, not base64: the JAX package may encode its
PNGs natively. Inside the port, sub-ranges must equal the whole-batch rows
exactly, and repeats must give the same bytes.
"""

import numpy as np
import pytest
import torch

import jax

from stable_diffusion_webui_distributed_tpu.models.configs import TINY as JTINY
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
from stable_diffusion_webui_distributed_tpu_torch.ops import flash_attention
from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import Engine
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
    b64png_to_array,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.interrupt import (
    GenerationState,
)
from test_pipeline import init_params

REQUESTS = {
    "euler-a-batch2": dict(prompt="a cow (jumping:1.3)",
                           negative_prompt="blurry", steps=6, width=64,
                           height=64, batch_size=2, seed=42, subseed=3),
    "euler-variation-n-iter": dict(prompt="a cow", steps=5, width=64,
                                   height=48, n_iter=2, seed=7, clip_skip=1,
                                   sampler_name="Euler", subseed=5,
                                   subseed_strength=0.3),
}


@pytest.fixture(scope="module")
def params():
    return jax.device_get(jax.jit(init_params, static_argnums=0)(JTINY))


@pytest.fixture(scope="module")
def jax_engine(params):
    return JaxEngine(JTINY, params, state=JaxState())


@pytest.fixture(scope="module")
def port(params):
    return Engine(TINY, bridge.flax_to_torch(TINY, params), chunk_size=4,
                  state=GenerationState(), device="cpu")


@pytest.fixture(scope="module")
def port_runs(port):
    return {name: port.txt2img(GenerationPayload(**kw))
            for name, kw in REQUESTS.items()}


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_txt2img_matches_jax(jax_engine, port_runs, name):
    want = jax_engine.txt2img(JaxPayload(**REQUESTS[name]))
    got = port_runs[name]
    assert got.seeds == want.seeds
    assert got.subseeds == want.subseeds
    assert got.infotexts == want.infotexts
    assert len(got.images) == len(want.images)
    for a, b in zip(got.images, want.images):
        pa = b64png_to_array(a).astype(np.int32)
        pb = b64png_to_array(b).astype(np.int32)
        assert pa.shape == pb.shape
        assert np.abs(pa - pb).max() <= 1
        assert pa.std() > 1.0  # not a constant image


def test_subrange_equals_whole_batch_rows(port, port_runs):
    p = GenerationPayload(**REQUESTS["euler-a-batch2"])
    whole = port_runs["euler-a-batch2"]
    one = port.generate_range(p, 1, 1)
    assert one.images == whole.images[1:]
    assert one.seeds == whole.seeds[1:]
    assert one.infotexts == whole.infotexts[1:]


def test_repeat_gives_same_bytes(port, port_runs):
    again = port.txt2img(GenerationPayload(**REQUESTS["euler-a-batch2"]))
    assert again.images == port_runs["euler-a-batch2"].images


def test_cpu_run_launches_no_kernel(port):
    before = flash_attention.flash_attention.launches
    port.txt2img(GenerationPayload(prompt="a cow", steps=2, width=32,
                                   height=32, seed=3))
    assert flash_attention.flash_attention.launches == before


def test_engine_without_device_raises_when_no_gpu(params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(TINY, bridge.init_seeded(TINY, 0, device="cpu"))


@pytest.mark.parametrize("extra", [
    {"override_settings": {"deepcache": 3}},
    {"override_settings": {"cfg_cutoff": 0.5}},
    {"override_settings": {"precision": "int8"}},
    {"precision": "int8"},
])
def test_cost_levers_are_served(port, extra):
    """The step cache, CFG truncation and int8, which earlier slices
    refused, are served, and each engages (other bytes than the plain
    request's; their parity with the JAX package is
    ``test_torch_stepcache.py``'s and ``test_torch_quant.py``'s)."""
    body = {"prompt": "a cow", "steps": 2, "width": 32, "height": 32,
            "seed": 3}
    plain = port.txt2img(GenerationPayload(**body))
    got = port.txt2img(GenerationPayload(**body, **extra))
    assert len(got.images) == 1 and got.seeds == plain.seeds
    assert got.images != plain.images


def test_lora_tags_are_served(port):
    """A ``<lora:...>`` tag is served, not refused: stripped before
    tokenizing and kept in the infotext; an adapter the engine cannot find
    is skipped, so the image is the tagless one."""
    body = {"prompt": "a cow", "steps": 2, "width": 32, "height": 32,
            "seed": 3}
    plain = port.txt2img(GenerationPayload(**body))
    tagged = port.txt2img(GenerationPayload(
        **{**body, "prompt": "a <lora:thing:0.8> cow"}))
    assert tagged.images == plain.images
    assert "a <lora:thing:0.8> cow" in tagged.infotexts[0]


def test_interrupt_stops_between_chunks(params):
    state = GenerationState()
    engine = Engine(TINY, bridge.flax_to_torch(TINY, params), chunk_size=1,
                    state=state, device="cpu")
    seen = []

    def listener(progress):
        seen.append(progress.sampling_step)
        if progress.sampling_step >= 2:
            state.flag.interrupt()

    state.add_listener(listener)
    out = engine.generate_range(GenerationPayload(
        prompt="a cow", steps=8, width=32, height=32, seed=1))
    assert max(seen) == 2
    assert len(out.images) == 1  # the group in flight is decoded
