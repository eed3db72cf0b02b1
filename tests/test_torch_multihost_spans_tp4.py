"""``tp=4`` over two ``cpu`` entries a rank, across two processes, against
the one-process port and the JAX engine on the same global spec, on TINY
on the CPU.

Each rank holds two of the replica's four shards: a collective brings the
other rank's two in one exchange, padded to the most shards a rank owns.
The checks are ``tests/test_torch_multihost_spans.py``'s.
"""

import pytest

from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
)
from test_torch_multihost import as_result
from test_torch_multihost_spans import (
    SPANS,
    check_held,
    check_ranks,
    jax_images,
    one_process,
    run_spans,
)
from test_torch_parallel import assert_within_one, gates_off, params  # noqa: F401,E501

NAMES = ("tp=4",)


@pytest.fixture(scope="module")
def ranks(params, tmp_path_factory):
    return run_spans(params, tmp_path_factory.mktemp("spans-tp4"), NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_both_ranks_return_the_one_process_images(name, ranks, params):
    body = SPANS[name][2]
    want = one_process(params, name).txt2img(GenerationPayload(**body))
    assert len(want.images) == body["batch_size"]
    check_ranks(ranks, name, name, want)


@pytest.mark.parametrize("name", NAMES)
def test_each_rank_holds_only_its_own_shards(name, ranks, params):
    check_held(ranks, params, name)


@pytest.mark.parametrize("name", NAMES)
def test_ranks_match_the_jax_engine_on_the_same_spec(name, ranks, params):
    want = jax_images(params, name, SPANS[name][2])
    for out in ranks:
        assert_within_one(as_result(out[name][name]), want)
