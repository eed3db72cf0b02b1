"""int8 on ``tp=2`` over one ``cpu`` entry a rank, across two processes,
against the one-process port and the JAX engine on the same global spec,
on TINY on the CPU.

Each rank holds one shard of every split product. A row product's
per-token and per-channel scales are the max over both shards' maxima,
taken over the group before either shard quantizes, and the shards' int32
accumulators are summed in shard order on both ranks: both ranks return
the one-process port's bytes, and the JAX engine's images within the
int8 bound of ``tests/test_torch_parallel.py`` (``SERVED``).
"""

import pytest

from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
)
from test_torch_multihost_mesh import run_ranks, weights_file
from test_torch_multihost_spans import (
    SPANS,
    check_held,
    check_ranks,
    jax_images,
    one_process,
)
from test_torch_parallel import (  # noqa: F401 — fixtures
    BASE,
    SERVED,
    assert_within,
    gates_off,
    params,
)

NAME = "tp=2"
BODY = {**BASE, **SERVED["int8"][0], "batch_size": 2, "seed": 34}


@pytest.fixture(scope="module")
def ranks(params, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp-int8")
    outs = run_ranks(tmp, "runs", runs=[{
        "name": NAME, "mesh": SPANS[NAME][0], "local": SPANS[NAME][1],
        "weights": weights_file(params, tmp),
        "cases": [["int8", "txt2img", BODY]]}])
    for out in outs:
        assert "error" not in out, out.get("error")
    return outs


def test_both_ranks_return_the_one_process_int8_images(ranks, params):
    want = one_process(params, NAME).txt2img(GenerationPayload(**BODY))
    assert len(want.images) == 2
    check_ranks(ranks, NAME, "int8", want)
    check_held(ranks, params, NAME)


def test_ranks_match_the_jax_engine_at_int8(ranks, params):
    want = jax_images(params, NAME, BODY)
    for out in ranks:
        assert out[NAME]["int8"]["seeds"] == want.seeds
        assert_within(out[NAME]["int8"]["images"], want, SERVED["int8"][1])
