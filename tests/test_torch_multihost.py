"""The port's engine on a mesh across two processes, on TINY on the CPU.

Two rank subprocesses (``tests/torch_multihost_rank.py``, which imports
only the port) join a gloo group on ``127.0.0.1``; each has a virtual
local mesh of four ``cpu`` entries, so the global spec ``dp=4,tp=2`` puts
replicas 0 and 1 on rank 0 and replicas 2 and 3 on rank 1. Each rank
computes its replicas' rows and the pixels are gathered over the group.

- txt2img at batch 4, batch 4 with ``n_iter`` 2 (a rank's rows are then
  two ranges of the request) and the odd batch 3 (every row on rank 0,
  replica 0: JAX's odd-batch fallback), and img2img at batch 4: both
  ranks return the same images, seeds and infotexts, byte for byte those
  of the one-process port on ``dp=4,tp=2`` over eight ``cpu`` entries;
- batch 4 and batch 4 x ``n_iter`` 2 within 1 uint8 level of the JAX
  engine on the same spec (``tests/test_torch_parallel.py``'s tolerance;
  the odd batch against JAX is in ``tests/test_torch_multihost_odd.py``).

One pair of ranks runs every case; the weights go to the ranks in a
``torch.save`` file.
"""

import pytest

from stable_diffusion_webui_distributed_tpu.models.configs import (
    TINY as JTINY,
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
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
    GenerationResult,
)
from test_torch_multihost_mesh import SPEC, run_ranks, weights_file
from test_torch_parallel import (  # noqa: F401 — fixtures
    BASE,
    _hint,
    assert_within_one,
    gates_off,
    params,
    port_engine,
)

CASES = {
    "batch 4": ("txt2img", {**BASE, "batch_size": 4}),
    "batch 4 x n_iter 2": ("txt2img", {**BASE, "batch_size": 4,
                                       "n_iter": 2, "seed": 40}),
    "odd batch 3": ("txt2img", {**BASE, "batch_size": 3, "seed": 50}),
    "img2img batch 4": ("img2img", {**BASE, "batch_size": 4, "seed": 60,
                                    "init_images": [_hint()],
                                    "denoising_strength": 0.6}),
}
#: the cases held to the JAX engine here: one compile (group size 4)
JAX_CASES = ("batch 4", "batch 4 x n_iter 2")


def as_result(got: dict) -> GenerationResult:
    return GenerationResult(images=got["images"], seeds=got["seeds"],
                            infotexts=got["infotexts"])


@pytest.fixture(scope="module")
def ranks(params, tmp_path_factory):
    """Both ranks' results of every case, from one run of the pair."""
    tmp = tmp_path_factory.mktemp("multihost")
    outs = run_ranks(tmp, "engine", weights=weights_file(params, tmp),
                     cases=[[name, kind, body]
                            for name, (kind, body) in CASES.items()])
    for out in outs:
        assert "error" not in out, out.get("error")
    return outs


@pytest.fixture(scope="module")
def one_process(params):
    """The one-process port on the same global spec: eight ``cpu``
    entries."""
    return port_engine(params, {}, SPEC)


@pytest.mark.parametrize("case", list(CASES))
def test_both_ranks_return_the_one_process_images(case, ranks, one_process):
    kind, body = CASES[case]
    run = one_process.img2img if kind == "img2img" else one_process.txt2img
    want = run(GenerationPayload(**body))
    assert len(want.images) == body["batch_size"] * body.get("n_iter", 1)
    for out in ranks:
        got = out[case]
        assert got["images"] == want.images
        assert got["seeds"] == want.seeds
        assert got["infotexts"] == want.infotexts


@pytest.fixture(scope="module")
def jax_engine(params):
    return JaxEngine(JTINY, params, chunk_size=3, state=JaxState(),
                     mesh=jmesh.build_mesh(SPEC))


@pytest.mark.parametrize("case", JAX_CASES)
def test_ranks_match_the_jax_engine_on_the_same_spec(case, ranks,
                                                     jax_engine):
    _, body = CASES[case]
    want = jax_engine.txt2img(JaxPayload(**body))
    assert_within_one(as_result(ranks[0][case]), want)
