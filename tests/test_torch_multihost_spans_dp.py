"""``dp=2,tp=2`` over one ``cpu`` entry and three, across two processes,
against the one-process port and the JAX engine on the same global spec,
on TINY on the CPU.

Rank 1 owns shard 1 of replica 0 and all of replica 1: it runs replica
0's rows with rank 0 (their collectives over the pair) and replica 1's
alone, and the pixel gather takes each replica's rows from one of its
ranks. The same pair then builds the mirror, three entries and one:
replica 1 spans the ranks, yet rank 0 runs the text encoders on replica
0, its first, so rank 1 runs them on its own entry alone (both give the
one-process values). The checks are
``tests/test_torch_multihost_spans.py``'s.
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

NAMES = ("dp=2,tp=2", "dp=2,tp=2 3+1")


@pytest.fixture(scope="module")
def ranks(params, tmp_path_factory):
    return run_spans(params, tmp_path_factory.mktemp("spans-dp"), NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_both_ranks_return_the_one_process_images(name, ranks, params):
    body = SPANS[name][2]
    want = one_process(params, name).txt2img(GenerationPayload(**body))
    assert len(want.images) == body["batch_size"]
    check_ranks(ranks, name, name, want)


@pytest.mark.parametrize("name", NAMES)
def test_each_rank_holds_only_its_own_shards(name, ranks, params):
    check_held(ranks, params, name)


def test_ranks_match_the_jax_engine_on_the_same_spec(ranks, params):
    # one global spec and request: one JAX engine for both splits
    want = jax_images(params, NAMES[0], SPANS[NAMES[0]][2])
    for name in NAMES:
        for out in ranks:
            assert_within_one(as_result(out[name][name]), want)
