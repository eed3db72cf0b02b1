"""The port's engine on a mesh: its CUDA graphs and its copies of the
weights, on TINY on the CPU (``tests/test_torch_parallel.py`` holds the
shared fixtures).

- **the tower** on a mesh of its own beside a ``dp=2`` engine gives the
  bytes of the units on the engine's mesh;
- **graphs**: which evaluations capture a graph under a mesh, and a LoRA
  merge, which copies the replicas on other cards anew, captures their
  graphs again rather than replaying graphs of the old copies.
"""

import pytest
import torch

from stable_diffusion_webui_distributed_tpu_torch.parallel import sharding
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import graphs
from stable_diffusion_webui_distributed_tpu_torch.runtime.mesh import (
    build_mesh,
)
from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
    METRICS,
)
from test_torch_parallel import (  # noqa: F401 — fixtures
    BASE,
    LORA,
    assert_within_one,
    cpus,
    gates_off,
    params,
    plain,
    port_engine,
    providers,
)
from test_torch_parallel_rows import ROWS_CASES
from test_torch_warmup import Stub, held_counts


# -- the tower beside a meshed engine -----------------------------------------------

def test_tower_on_its_own_mesh_beside_a_dp_engine(params, providers,
                                                  monkeypatch):
    dp2 = port_engine(params, providers, "dp=2")
    body = {**BASE, "batch_size": 2, "seed": 34,
            **ROWS_CASES["controlnet residuals"]}
    serial = dp2.txt2img(GenerationPayload(**body))
    monkeypatch.setenv("SDTPU_STAGE_GRAPH", "1")
    monkeypatch.setattr(dp2, "_stage_cn_mesh",
                        lambda: build_mesh("dp=2", cpus(2)))
    got = dp2.txt2img(GenerationPayload(**body))
    # the tower's replicas run the engine's row blocks: the same sums
    assert got.images == serial.images



# -- graphs -------------------------------------------------------------------------

@pytest.mark.parametrize("spec, one_device, keys", [
    ("dp=2", True, 2),      # a graph per replica
    ("tp=2,sp=2", True, 1),  # one replica on one device: one graph
    ("tp=2", False, 0),     # shards on several cards: eager
])
def test_which_evaluations_capture_a_graph(spec, one_device, keys, params,
                                           providers, monkeypatch):
    cuda = [torch.device("cuda", i) for i in range(2)]
    assert sharding.one_device(((cuda[0], cuda[0]),))
    assert not sharding.one_device(((cuda[0],), (cuda[1],)))
    eng = port_engine(params, providers, spec)
    eng._graphs = graphs.GraphCache(capture=Stub())
    # a layout over several cards, as the CPU's virtual mesh cannot be
    monkeypatch.setattr(sharding, "one_device", lambda layout: one_device)
    METRICS.clear()
    eng.txt2img(GenerationPayload(**{**BASE, "batch_size": 2}))
    tags = [key[0] for key in eng._graphs.keys()]
    assert len(tags) == keys
    assert sorted(tag[-1][2] for tag in tags) == list(range(keys))
    assert METRICS.summary()["compiles"].get("unet", 0) == keys


class PinnedStub(Stub):
    """The stand-in capture backend whose replay reads the replicas its
    capture read, as a CUDA graph reads the memory of the weights it was
    captured against."""

    def __init__(self, engine):
        self.engine = engine

    def capture(self, fn):
        placed = dict(self.engine._placed)
        out = fn()
        return (fn, out, placed), out

    def replay(self, graph):
        fn, out, placed = graph
        now, self.engine._placed = self.engine._placed, placed
        try:
            out.copy_(held_counts(fn))
        finally:
            self.engine._placed = now


def test_a_lora_merge_recaptures_the_graphs_of_copied_replicas(
        plain, params, providers):
    # cpu:0 and cpu:1 are two "cards": a tensor moved from one to the
    # other is a copy, so each replica runs on copies of the weights
    spec, devices = "dp=2", ["cpu:0", "cpu:1"]
    eng = port_engine(params, providers, spec, devices)
    eng._graphs = graphs.GraphCache(capture=PinnedStub(eng))
    eager = port_engine(params, providers, spec, devices)
    body = {**BASE, "batch_size": 2, "seed": 35}
    lora = {**body, "prompt": f"mesh cow <lora:{LORA}:0.8>"}
    METRICS.clear()
    # tagless, merged, the merge undone: each copies the replicas anew
    for b in (body, lora, body):
        got = eng.txt2img(GenerationPayload(**b))
        assert got.images == eager.txt2img(GenerationPayload(**b)).images
        assert_within_one(got, plain.txt2img(GenerationPayload(**b)))
    # a graph per replica per request: none replays over a copy it did
    # not capture
    assert METRICS.summary()["compiles"]["unet"] == 6
