"""The hires pass, the refiner handoff and inpainting on a mesh across
processes (``dp`` over the ranks, ROADMAP queue 3, item 3b), against the
one-process port on the same global spec, on TINY on the CPU.

A pair of ranks runs the global ``dp=4,tp=2`` over four ``cpu`` entries a
rank, as ``tests/test_torch_multihost_faults.py`` sets it up: the hires
pass on a rank's rows, with the "Latent" resize and with the image-space
upscaler (each rank decodes, upscales and encodes its own rows: its
micro-batch is a rank's rows, not the group's), the refiner handoff
through the registry's refiner engine, which shares the spanning mesh,
and inpainting on a TINY_INPAINT engine (the inpainting conditioning cut
to a rank's rows). Both ranks return the one-process port's images,
seeds and infotexts, byte for byte.
"""

import pytest
import torch

from stable_diffusion_webui_distributed_tpu.models.configs import (
    TINY_INPAINT as JTINY_INPAINT,
)
from stable_diffusion_webui_distributed_tpu_torch import bridge
from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
    TINY_INPAINT,
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
from test_torch_multihost_faults import (  # noqa: F401 — fixtures
    HIRES_CASES,
    SPEC,
    check,
    models,
    one_process,
    run_pair,
)
from test_torch_parallel import BASE, gates_off, seeded  # noqa: F401

INPAINT = {"inpainting": ("img2img", {
    **BASE, "batch_size": 4, "seed": 78, "init_images": [INIT],
    "mask": MASK, "inpainting_fill": 1, "denoising_strength": 0.6})}


@pytest.fixture(scope="module")
def inpaint_weights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("faults-inpaint") / "inpaint.pt")
    torch.save(bridge.flax_to_torch(TINY_INPAINT, seeded(JTINY_INPAINT, 1)),
               path)
    return path


@pytest.fixture(scope="module")
def ranks(models, inpaint_weights, tmp_path_factory):
    return run_pair(tmp_path_factory.mktemp("hires-ranks"), models, [
        ("3b", HIRES_CASES, {}),
        ("inpaint", INPAINT, {"weights": inpaint_weights,
                              "family": TINY_INPAINT.name})])


@pytest.mark.parametrize("case", list(HIRES_CASES))
def test_both_ranks_return_the_one_process_images(case, ranks, one_process):
    kind, body = HIRES_CASES[case]
    want = one_process.txt2img(GenerationPayload(**body))
    assert len(want.images) == 4
    check(ranks, "3b", case, want)


def test_inpainting_on_both_ranks_is_the_one_process_images(
        ranks, inpaint_weights):
    engine = Engine(TINY_INPAINT, torch.load(inpaint_weights), chunk_size=3,
                    state=GenerationState(),
                    mesh=build_mesh(SPEC, ["cpu"] * 8))
    kind, body = INPAINT["inpainting"]
    want = engine.img2img(GenerationPayload(**body))
    assert len(want.images) == 4
    check(ranks, "inpaint", "inpainting", want)
