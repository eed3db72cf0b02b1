"""Every sampler of the port's engine against the JAX package's, on TINY on
the CPU.

Both engines hold the same Flax weights and run in f32. For each of the 18
sampler names the same batch-2 request must give the same seeds and
infotext and decoded pixels within 1 uint8 level (the tolerance of
``tests/test_torch_engine.py``); DPM adaptive must also take the same number
of attempts. Inside the port, sub-ranges of DPM++ SDE (fresh noise at two
points of each step) and DPM++ 2M (a history) must equal the whole batch's
rows exactly, and an interrupt stops DPM adaptive between attempts.
"""

import numpy as np
import pytest

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
from stable_diffusion_webui_distributed_tpu.samplers import kdiffusion as jkd
from stable_diffusion_webui_distributed_tpu_torch import bridge
from stable_diffusion_webui_distributed_tpu_torch.models.configs import TINY
from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import Engine
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
    b64png_to_array,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.interrupt import (
    GenerationState,
)
from test_pipeline import init_params

NAMES = list(jkd.SAMPLERS)
REQUEST = dict(prompt="a cow (jumping:1.2)", negative_prompt="blurry",
               steps=5, width=32, height=32, batch_size=2, seed=42,
               subseed=3, cfg_scale=6.5)


@pytest.fixture(scope="module")
def params():
    return jax.device_get(jax.jit(init_params, static_argnums=0)(JTINY))


@pytest.fixture(scope="module")
def jax_engine(params):
    return JaxEngine(JTINY, params, state=JaxState())


@pytest.fixture(scope="module")
def port(params):
    # chunks of 2 steps: the history crosses chunk boundaries
    return Engine(TINY, bridge.flax_to_torch(TINY, params), chunk_size=2,
                  state=GenerationState(), device="cpu")


def pixels(b64):
    return b64png_to_array(b64).astype(np.int32)


@pytest.mark.parametrize("name", NAMES)
def test_every_sampler_matches_jax(jax_engine, port, name, monkeypatch):
    jax_runs = []
    run = jkd.sample_dpm_adaptive

    def counted(*args, **kwargs):
        x, info = run(*args, **kwargs)
        jax_runs.append(info)
        return x, info

    monkeypatch.setattr(jkd, "sample_dpm_adaptive", counted)
    want = jax_engine.txt2img(JaxPayload(**REQUEST, sampler_name=name))
    got = port.txt2img(GenerationPayload(**REQUEST, sampler_name=name))
    assert got.seeds == want.seeds == [42, 43]
    assert got.subseeds == want.subseeds
    assert got.infotexts == want.infotexts
    assert f"Sampler: {name}" in got.infotexts[0]
    for a, b in zip(got.images, want.images):
        pa, pb = pixels(a), pixels(b)
        assert pa.shape == pb.shape == (32, 32, 3)
        assert np.abs(pa - pb).max() <= 1
        assert pa.std() > 1.0  # not a constant image
    if name == "DPM adaptive":
        assert [i["completed"] for i in jax_runs] == [True]
        assert port.last_adaptive_attempts == jax_runs[0]["steps"] > 0
    else:
        assert jax_runs == []


@pytest.mark.parametrize("name", ["DPM++ SDE", "DPM++ 2M"])
def test_subrange_equals_whole_batch_rows(port, name):
    p = GenerationPayload(**REQUEST, sampler_name=name)
    whole = port.generate_range(p)
    one = port.generate_range(p, 1, 1)
    assert one.images == whole.images[1:]
    assert one.seeds == whole.seeds[1:]
    assert one.infotexts == whole.infotexts[1:]
    assert port.generate_range(p).images == whole.images  # repeat


def test_adaptive_interrupt_stops_between_attempts(params):
    state = GenerationState()
    engine = Engine(TINY, bridge.flax_to_torch(TINY, params), state=state,
                    device="cpu")
    p = GenerationPayload(**REQUEST, sampler_name="DPM adaptive")
    engine.generate_range(p)
    full = engine.last_adaptive_attempts
    seen = []

    def listener(progress):
        seen.append(progress.sampling_step)
        if progress.sampling_step >= 1:
            state.flag.interrupt()

    state.add_listener(listener)
    out = engine.generate_range(p)
    assert 1 <= engine.last_adaptive_attempts < full
    assert max(seen) == 1
    assert len(out.images) == 2  # the group in flight is decoded
    assert "incomplete" not in out.infotexts[0]  # interrupted, not stuck
