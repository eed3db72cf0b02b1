"""Traced LoRA (``SDTPU_LORA_TRACED=1``) on ``tp=2`` over one ``cpu``
entry a rank, across two processes, against the one-process port and the
JAX engine on the same global spec, on TINY on the CPU.

A column site's ``h = x @ down^T`` is computed on both ranks, each adding
its shard's rows of ``h @ up^T``; a row site's partial ``h`` of each shard
is summed over the group in shard order before ``up``. The adapter
(``tests/test_torch_lora.py`` ``make_adapter``, rank 4) reaches the ranks
as a ``Lora/`` file of a model directory each: both ranks return the
one-process port's bytes, with no merge, and the JAX traced engine's
images within 1 uint8 level (``tests/test_torch_parallel.py``'s
``SERVED``).

The same pair then takes the merged path on a second engine: a merge
writes whole weights, so each rank first gathers back the weights its
placements freed (a collective over the replica's ranks), merges, and
places anew; the request after it, without the adapter, gathers them
back again to restore the pristine weights. Both requests give the
one-process port's bytes, and each rank again holds its own shards
alone.
"""

import os

import pytest
from safetensors.numpy import save_file

from stable_diffusion_webui_distributed_tpu_torch.models.configs import TINY
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
)
from test_torch_lora import make_adapter
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
    LORA,
    SERVED,
    assert_within,
    gates_off,
    params,
)

NAME = "tp=2"
BODY = {**BASE, **SERVED["traced LoRA"][0], "batch_size": 2, "seed": 35}
#: the merged path, then a request without the adapter (the merge undone)
MERGED = [["merged", "txt2img", {**BODY, "seed": 37}],
          ["after", "txt2img", {**BASE, "batch_size": 2, "seed": 38}]]


@pytest.fixture(scope="module")
def adapter():
    return make_adapter(TINY, rank=4, seed=3)


@pytest.fixture(scope="module")
def ranks(params, adapter, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp-lora")
    models = tmp / "models"
    os.makedirs(models / "Lora")
    save_file(adapter, str(models / "Lora" / f"{LORA}.safetensors"))
    outs = run_ranks(tmp, "runs", runs=[{
        "name": NAME, "mesh": SPANS[NAME][0], "local": SPANS[NAME][1],
        "weights": weights_file(params, tmp), "registry": str(models),
        "env": {"SDTPU_LORA_TRACED": "1"},
        "cases": [["traced", "txt2img", BODY]]}, {
        "name": "merged", "mesh": SPANS[NAME][0], "local": SPANS[NAME][1],
        "weights": weights_file(params, tmp), "registry": str(models),
        "cases": MERGED}])
    for out in outs:
        assert "error" not in out, out.get("error")
    return outs


@pytest.fixture
def traced(monkeypatch):
    monkeypatch.setenv("SDTPU_LORA_TRACED", "1")


def test_both_ranks_return_the_one_process_traced_images(ranks, params,
                                                         adapter, traced):
    one = one_process(params, NAME, {"lora_provider": {LORA: adapter}.get})
    want = one.txt2img(GenerationPayload(**BODY))
    assert one._traced_lora is not None and not one._pristine
    check_ranks(ranks, NAME, "traced", want)
    check_held(ranks, params, NAME)


def test_ranks_match_the_jax_traced_engine(ranks, params, adapter, traced):
    want = jax_images(params, NAME, BODY, lora_provider={LORA: adapter}.get)
    for out in ranks:
        assert out[NAME]["traced"]["seeds"] == want.seeds
        assert_within(out[NAME]["traced"]["images"], want,
                      SERVED["traced LoRA"][1])


def test_a_merge_gathers_the_freed_weights_back_on_every_rank(
        ranks, params, adapter):
    one = one_process(params, NAME, {"lora_provider": {LORA: adapter}.get})
    for case, _, body in MERGED:
        want = one.txt2img(GenerationPayload(**body))
        check_ranks(ranks, "merged", case, want)
    assert one._lora_merge_total > 0
    check_held(ranks, params, NAME, run="merged")
