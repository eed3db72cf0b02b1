"""The port's two-stage pipeline (``parallel/stage_pipeline.py``) against
its sequential path and the JAX package's pipeline, on TINY_XL and
TINY_REFINER on the CPU: unmeshed it gives the sequential bytes; on two
virtual meshes (JAX on two disjoint pairs of the conftest's virtual
devices) the JAX package's pipelined pixels within 1 uint8 level; its
refusals are JAX's (JAX ``tests/test_parallel_pipeline.py``).
"""

import dataclasses

import pytest

import jax

from stable_diffusion_webui_distributed_tpu.models.configs import (
    TINY_REFINER as JTINY_REFINER,
    TINY_XL as JTINY_XL,
)
from stable_diffusion_webui_distributed_tpu.parallel import (
    stage_pipeline as jsp,
)
from stable_diffusion_webui_distributed_tpu.pipeline.engine import (
    Engine as JaxEngine,
)
from stable_diffusion_webui_distributed_tpu.pipeline.payload import (
    GenerationPayload as JaxPayload,
)
from stable_diffusion_webui_distributed_tpu.runtime import mesh as jmesh
from stable_diffusion_webui_distributed_tpu.runtime.interrupt import (
    GenerationState as JaxState,
)
from stable_diffusion_webui_distributed_tpu_torch import bridge
from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
    TINY_REFINER,
    TINY_XL,
)
from stable_diffusion_webui_distributed_tpu_torch.parallel.stage_pipeline import (
    pipelined_txt2img,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import Engine
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.interrupt import (
    GenerationState,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.mesh import (
    build_mesh,
)
from test_torch_parallel import (  # noqa: F401 — fixtures
    _hint,
    assert_within_one,
    cpus,
    gates_off,
    seeded,
)

REFINE = dict(prompt="staged cow", steps=4, width=32, height=32, seed=21,
              batch_size=2, n_iter=2, refiner_checkpoint="tiny-ref",
              refiner_switch_at=0.5)


@pytest.fixture(scope="module")
def xl_params():
    return seeded(JTINY_XL, 10), seeded(JTINY_REFINER, 11)


def xl_engines(xl_params, base_mesh=None, ref_mesh=None):
    bp, rp = xl_params
    place = (lambda m: {"device": "cpu"} if m is None else {"mesh": m})
    ref = Engine(TINY_REFINER, bridge.flax_to_torch(TINY_REFINER, rp),
                 chunk_size=4, state=GenerationState(),
                 model_name="tiny-ref", **place(ref_mesh))
    base = Engine(TINY_XL, bridge.flax_to_torch(TINY_XL, bp), chunk_size=4,
                  state=GenerationState(), **place(base_mesh),
                  engine_provider=lambda n: ref if n == "tiny-ref" else None)
    return base, ref


def test_pipeline_unmeshed_gives_the_sequential_bytes(xl_params):
    base, ref = xl_engines(xl_params)
    want = base.txt2img(GenerationPayload(**REFINE))
    got = pipelined_txt2img(base, ref, GenerationPayload(**REFINE))
    assert got.images == want.images
    assert got.seeds == want.seeds and got.infotexts == want.infotexts


def test_pipeline_on_two_meshes_matches_jax(xl_params):
    base, ref = xl_engines(xl_params, build_mesh("dp=2", cpus(2)),
                           build_mesh("dp=2", cpus(2)))
    got = pipelined_txt2img(base, ref, GenerationPayload(**REFINE))
    bp, rp = xl_params
    devs = jax.devices()
    jbase = JaxEngine(JTINY_XL, bp, chunk_size=4, state=JaxState(),
                      mesh=jmesh.build_mesh("dp=2", devices=devs[0:2]))
    jref = JaxEngine(JTINY_REFINER, rp, chunk_size=4, state=JaxState(),
                     mesh=jmesh.build_mesh("dp=2", devices=devs[2:4]),
                     model_name="tiny-ref")
    want = jsp.pipelined_txt2img(jbase, jref, JaxPayload(**REFINE))
    assert len(got.images) == 4
    assert_within_one(got, want)


REFUSALS = [
    dict(prompt="x", steps=4, width=32, height=32, seed=1),
    dict(prompt="x", steps=4, width=32, height=32, seed=1,
         sampler_name="DPM adaptive", refiner_checkpoint="tiny-ref",
         refiner_switch_at=0.5),
    dict(prompt="x", steps=4, width=32, height=32, seed=1, enable_hr=True,
         hr_scale=2.0, refiner_checkpoint="tiny-ref", refiner_switch_at=0.5),
    dict(prompt="x", steps=4, width=32, height=32, seed=1,
         init_images=[_hint()], refiner_checkpoint="tiny-ref",
         refiner_switch_at=0.5),
    dict(prompt="x", steps=4, width=32, height=32, seed=1,
         all_prompts=["a", "b"], batch_size=2,
         refiner_checkpoint="tiny-ref", refiner_switch_at=0.5),
    dict(prompt="x", steps=4, width=32, height=32, seed=1,
         refiner_checkpoint="tiny-ref", refiner_switch_at=0.5,
         alwayson_scripts={"controlnet": {"args": [
             {"image": _hint(), "module": "none", "model": "m"}]}}),
]


def test_pipeline_refusals_are_jax_s(xl_params):
    base, ref = xl_engines(xl_params)
    bp, rp = xl_params
    jbase = JaxEngine(JTINY_XL, bp, chunk_size=4, state=JaxState())
    jref = JaxEngine(JTINY_REFINER, rp, chunk_size=4, state=JaxState())
    for body in REFUSALS:
        with pytest.raises(ValueError) as got:
            pipelined_txt2img(base, ref, GenerationPayload(**body))
        with pytest.raises(ValueError) as want:
            jsp.pipelined_txt2img(jbase, jref, JaxPayload(**body))
        assert str(got.value) == str(want.value)
    # an inpainting family is refused after the payload passes
    base.family = dataclasses.replace(base.family, unet=dataclasses.replace(
        base.family.unet, in_channels=9))
    with pytest.raises(ValueError, match="inpainting checkpoints"):
        pipelined_txt2img(base, ref, GenerationPayload(**REFINE))


