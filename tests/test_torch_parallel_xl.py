"""The port's engine with CLIP and the VAE placed over ``tp``, against the
JAX package's engine on the same mesh spec and the port's meshless engine,
on the CPU.

- **Against JAX on ``dp=4,tp=2``** (JAX on the conftest's eight virtual
  CPU devices, the port on a virtual mesh of eight ``cpu`` entries): TINY_XL
  txt2img at batch 4 (the dual encode, the pooled projection and the f32
  decoder on their shards), TINY img2img at batch 4 and a TINY inpaint
  request (the VAE encoder on its shards), each within 1 uint8 level of
  the JAX engine's images and of the port's meshless ones (JAX
  ``tests/test_pipeline.py`` ``TestMeshEngine``'s bound). Two JAX engines
  are compiled, one per family.
- **The placement's lifecycle on ``tp=2``**: construction places the text
  encoders and the VAE encoder with replica 0's layout and the decoder per
  replica, ``set_mesh(None)`` removes every placement; after ``set_vae``
  with a second seed's VAE, after restoring the checkpoint's and after a
  LoRA merge that touches text-encoder keys the modules in use are placed
  again and the images are the meshless engine's. The stage pipeline's
  refiner on a mesh of its own: ``tests/test_torch_parallel_te_vae.py``.

The weights are parameter trees filled from a seeded numpy stream (shapes
from ``jax.eval_shape``); both packages take the same trees.
"""

import pytest

from stable_diffusion_webui_distributed_tpu.models.configs import (
    TINY as JTINY,
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
from stable_diffusion_webui_distributed_tpu.runtime import mesh as jmesh
from stable_diffusion_webui_distributed_tpu.runtime.interrupt import (
    GenerationState as JaxState,
)
from stable_diffusion_webui_distributed_tpu_torch import bridge
from stable_diffusion_webui_distributed_tpu_torch.models import unet as unet_mod
from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
    TINY,
    TINY_XL,
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
from test_torch_img2img import INIT, MASK
from test_torch_lora import make_adapter
from test_torch_parallel import (  # noqa: F401 — fixtures
    assert_within_one,
    cpus,
    gates_off,
    seeded,
)

LORA = "te-lora"
BASE = dict(prompt="mesh cow", negative_prompt="blurry", steps=3, width=32,
            height=32, seed=24, sampler_name="Euler a")
REQUESTS = {
    "tiny-xl txt2img batch 4": ("tiny-xl", "txt2img",
                                dict(BASE, batch_size=4)),
    "tiny img2img batch 4": ("tiny", "img2img",
                             dict(BASE, batch_size=4, init_images=[INIT],
                                  denoising_strength=0.6)),
    "tiny inpaint": ("tiny", "img2img",
                     dict(BASE, batch_size=4, init_images=[INIT], mask=MASK,
                          inpainting_fill=1, mask_blur=2,
                          denoising_strength=0.7)),
}
JFAMILIES = {"tiny": JTINY, "tiny-xl": JTINY_XL}
FAMILIES = {"tiny": TINY, "tiny-xl": TINY_XL}


@pytest.fixture(scope="module")
def trees():
    return {"tiny": seeded(JTINY, 40), "tiny-xl": seeded(JTINY_XL, 41)}


def port_engine(family, tree, spec=None, **kw):
    fam = FAMILIES[family]
    return Engine(fam, bridge.flax_to_torch(fam, tree), chunk_size=3,
                  state=GenerationState(),
                  **({"device": "cpu"} if spec is None else
                     {"mesh": build_mesh(spec, cpus(8))}), **kw)


@pytest.fixture(scope="module")
def engines(trees):
    """Per family: the port meshless, the port on ``dp=4,tp=2`` and the
    JAX engine on the same spec, built at first use."""
    built = {}

    def get(family):
        if family not in built:
            tree = trees[family]
            built[family] = (
                port_engine(family, tree),
                port_engine(family, tree, "dp=4,tp=2"),
                JaxEngine(JFAMILIES[family], tree, chunk_size=3,
                          state=JaxState(),
                          mesh=jmesh.build_mesh("dp=4,tp=2")))
        return built[family]

    return get


def placed(module):
    """``(column, row)``: the module's layers split by output and by input
    features."""
    plans = [m.tp for m in module.modules()
             if isinstance(m, (unet_mod.Dense, unet_mod.Conv))]
    return (sum(isinstance(p, unet_mod._Column) for p in plans),
            sum(isinstance(p, unet_mod._Row) for p in plans))


def home_modules(engine):
    return [m for m in (engine.text_encoder, engine.text_encoder_2,
                        engine.vae_encoder) if m is not None]


def assert_placed(engine):
    """Every text encoder and VAE half of ``engine`` split over its mesh's
    ``tp``: the decoder of each replica, the others with replica 0's
    layout."""
    tp = engine.mesh.shape["tp"]
    for module in (*home_modules(engine),
                   *engine._replicas(engine.vae, engine.mesh)):
        column, row = placed(module)
        assert column > 0 and row > 0, module
        some = next(m.tp for m in module.modules()
                    if getattr(m, "tp", None) is not None)
        assert len(some.devices) == tp


# -- against JAX on dp=4,tp=2 ----------------------------------------------------

@pytest.mark.parametrize("case", list(REQUESTS))
def test_placed_text_encoders_and_vae_match_jax_and_meshless(engines, case):
    family, route, body = REQUESTS[case]
    plain, port, jax_engine = engines(family)
    assert_placed(port)
    got = getattr(port, route)(GenerationPayload(**body))
    assert len(got.images) == 4
    assert_within_one(got, getattr(jax_engine, route)(JaxPayload(**body)))
    assert_within_one(got, getattr(plain, route)(GenerationPayload(**body)))


# -- the lifecycle on tp=2 -------------------------------------------------------

def test_set_mesh_none_unplaces_and_a_mesh_places_again(trees):
    engine = port_engine("tiny-xl", trees["tiny-xl"], "tp=2")
    assert_placed(engine)
    mesh = engine.mesh
    engine.set_mesh(None)
    for module in (*home_modules(engine), engine.vae, engine.unet):
        assert placed(module) == (0, 0)
    engine.set_mesh(mesh)
    assert_placed(engine)


def test_vae_swap_and_lora_merge_place_again(trees):
    tree = trees["tiny"]
    adapter = make_adapter(TINY, rank=4, seed=3)
    provider = {"lora_provider": lambda n: adapter if n == LORA else None}
    plain = port_engine("tiny", tree, **provider)
    tp2 = port_engine("tiny", tree, "tp=2", **provider)
    other = bridge.init_seeded(TINY, seed=42, device="cpu")
    vae = {"vae": other["vae"], "vae_encoder": other["vae_encoder"]}
    body = dict(BASE, init_images=[INIT], denoising_strength=0.6)
    images = {}
    for step in ("other vae", "checkpoint vae", "lora"):
        if step == "lora":
            body = dict(body, prompt=f"mesh cow <lora:{LORA}:0.8>")
        else:
            arg = vae if step == "other vae" else None
            kept = (tp2.vae, tp2.vae_encoder)
            plain.set_vae(arg)
            tp2.set_vae(arg)
            # the outgoing pair keeps no placement
            assert all(placed(m) == (0, 0) for m in kept)
        got = tp2.img2img(GenerationPayload(**body))
        assert_placed(tp2)
        assert_within_one(got, plain.img2img(GenerationPayload(**body)))
        images[step] = got.images
    assert len({tuple(v) for v in images.values()}) == 3
    assert any(comp == "text_encoder" for comp, _ in tp2._pristine)
