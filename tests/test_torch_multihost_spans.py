"""A replica's ``tp`` and ``sp`` shards across two processes, against the
one-process port and the JAX engine on the same global spec, on TINY on
the CPU.

A pair of ranks (``tests/torch_multihost_rank.py``, which imports only the
port) builds meshes in turn, each a global spec over the two ranks'
``cpu`` entries (:data:`SPANS`):

- ``tp=2`` over one entry a rank (each rank holds one shard of the one
  replica), at batch 2;
- ``tp=4`` over two entries a rank (local and remote shards in one
  replica);
- ``sp=2`` over one entry a rank (the ring's two positions on two ranks);
- ``tp=2,sp=2`` over three entries and one (rank 0 holds both shards,
  rank 1 one position of shard 1's ring);
- ``dp=2,tp=2`` over one entry and three (rank 1 owns shard 1 of replica
  0 and all of replica 1).

On ``tp=2`` the pair also runs DPM adaptive: both ranks of the replica
run its step controller, on one error, so their attempts stay in step.

On each, both ranks exchange shards over the group, their images, seeds
and infotexts are byte for byte those of the one-process port over as
many ``cpu`` entries, and within 1 uint8 level of the JAX engine on the
same spec (``tests/test_torch_parallel.py``'s tolerance); each rank's
modules and placements hold the weights of its own shards and of the layers
that are not split, and nothing more (their bytes, against the one-process
replica's). A JAX engine compiles for some 15 s
here, so this file runs ``tp=2``, ``_spans_tp4.py`` ``tp=4``,
``_spans_sp.py`` the two ``sp`` meshes and ``_spans_dp.py`` the two
``dp=2,tp=2`` splits; int8 and traced
LoRA on ``tp=2`` are ``tests/test_torch_multihost_tp_int8.py`` and
``_tp_lora.py``.
"""

import functools

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
)
from stable_diffusion_webui_distributed_tpu_torch.samplers import kdiffusion
from test_torch_multihost import as_result
from test_torch_multihost_mesh import run_ranks, weights_file
from test_torch_parallel import (  # noqa: F401 — fixtures
    BASE,
    assert_within_one,
    gates_off,
    params,
    port_engine,
)
from torch_multihost_rank import held as held_of

#: each mesh: its global spec, each rank's entries, the request, and the
#: held-shard patterns of each rank's replicas (by local replica)
SPANS = {
    "tp=2": ("tp=2", [1, 1], {**BASE, "batch_size": 2},
             [{"0": [[True, False]]}, {"0": [[False, True]]}]),
    "tp=4": ("tp=4", [2, 2], {**BASE, "batch_size": 2, "seed": 31},
             [{"0": [[True, True, False, False]]},
              {"0": [[False, False, True, True]]}]),
    "sp=2": ("sp=2", [1, 1], {**BASE, "batch_size": 2, "seed": 32},
             [{"0": []}, {"0": []}]),
    "dp=2,tp=2": ("dp=2,tp=2", [1, 3], {**BASE, "batch_size": 2,
                                        "seed": 33},
                  [{"0": [[True, False]]},
                   {"0": [[False, True]], "1": [[True, True]]}]),
    # rank 0 owns an entry in every row, rank 1 one entry of shard 1's
    # ring: the tp collectives and that ring share the pair's group, and
    # rank 0 enters each exchange although it holds every part
    "tp=2,sp=2 3+1": ("tp=2,sp=2", [3, 1], {**BASE, "batch_size": 2,
                                            "seed": 34},
                      [{"0": [[True, True]]}, {"0": [[False, True]]}]),
    # the mirror: replica 1 spans the ranks, but rank 0 computes the text
    # encoders on replica 0, its first, so rank 1 computes them alone
    "dp=2,tp=2 3+1": ("dp=2,tp=2", [3, 1], {**BASE, "batch_size": 2,
                                            "seed": 33},
                      [{"0": [[True, True]], "1": [[True, False]]},
                       {"1": [[False, True]]}]),
}


def span_runs(weights, spans, **extra):
    """The rank job's ``runs`` for ``spans`` (names of :data:`SPANS`)."""
    return [{"name": name, "mesh": SPANS[name][0], "local": SPANS[name][1],
             "weights": weights, **extra,
             "cases": [[name, "txt2img", SPANS[name][2]]]}
            for name in spans]


def run_spans(params, tmp, names, **extra):
    """Both ranks' results of the meshes ``names``, from one run of the
    pair; ``extra`` goes into each run (a registry, an env)."""
    outs = run_ranks(tmp, "runs", runs=span_runs(weights_file(params, tmp),
                                                 names, **extra))
    for out in outs:
        assert "error" not in out, out.get("error")
    return outs


def one_process(params, name, providers=None):
    """The one-process port on mesh ``name``'s global spec."""
    spec, local, _, _ = SPANS[name]
    return port_engine(params, providers or {}, spec, ["cpu"] * sum(local))


def jax_images(params, name, body, **kw):
    """The JAX engine's result of ``body`` on mesh ``name``'s spec."""
    engine = JaxEngine(JTINY, params, chunk_size=3, state=JaxState(),
                       mesh=jmesh.build_mesh(SPANS[name][0]), **kw)
    return engine.txt2img(JaxPayload(**body))


def check_ranks(ranks, name, case, want):
    """Both ranks exchanged shards and returned ``want``'s bytes."""
    for out in ranks:
        got = out[name][case]
        assert out[name]["collectives"] > 0
        assert got["images"] == want.images
        assert got["seeds"] == want.seeds
        assert got["infotexts"] == want.infotexts


def check_held(ranks, params, name, run=None):
    """Each rank's replicas hold the weights of their own shards and of
    the layers that are not split, each once, and nothing more: the bytes
    the rank's module holds are the one-process replica's, less the
    shards it does not hold (``run``: the rank job's run on mesh
    ``name``, by default the one of that name)."""
    run = run or name
    for rank, out in enumerate(ranks):
        held = out[run]["held"]
        assert {r: h["patterns"] for r, h in held.items()} == \
            SPANS[name][3][rank]
    for r, want in held_of(one_process(params, name)).items():
        for out in ranks:
            got = out[run]["held"].get(r)
            if got is None:
                continue
            (pattern,) = got["patterns"] or [[True]]
            assert got["shard_bytes"] * len(pattern) == \
                want["shard_bytes"] * sum(pattern)
            assert got["bytes"] - got["shard_bytes"] == \
                want["bytes"] - want["shard_bytes"]


#: the meshes this file runs
NAMES = ("tp=2",)


#: DPM adaptive on ``tp=2``: both ranks run the step controller on the
#: error their exchanged shards give, which must agree to the bit for
#: their collectives to stay in step (the attempt backstop bounds the run
#: and marks the infotexts)
ADAPTIVE = {**BASE, "seed": 36, "sampler_name": "DPM adaptive"}
MAX_ATTEMPTS = 3


@pytest.fixture(scope="module")
def ranks(params, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spans")
    runs = span_runs(weights_file(params, tmp), NAMES,
                     max_attempts=MAX_ATTEMPTS)
    runs[0]["cases"].append(["adaptive", "txt2img", ADAPTIVE])
    outs = run_ranks(tmp, "runs", runs=runs)
    for out in outs:
        assert "error" not in out, out.get("error")
    return outs


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


def test_dpm_adaptive_steps_alike_on_both_ranks_of_a_replica(
        ranks, params, monkeypatch):
    monkeypatch.setattr(kdiffusion, "sample_dpm_adaptive", functools.partial(
        kdiffusion.sample_dpm_adaptive, max_attempts=MAX_ATTEMPTS))
    engine = one_process(params, "tp=2")
    want = engine.txt2img(GenerationPayload(**ADAPTIVE))
    assert engine.last_adaptive_attempts == MAX_ATTEMPTS
    assert all(t.endswith(", DPM adaptive: incomplete")
               for t in want.infotexts)
    check_ranks(ranks, "tp=2", "adaptive", want)
