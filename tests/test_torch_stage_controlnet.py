"""The stage-graph executor's stage-ahead ControlNet
(``Engine._denoise_staged_cn``) against the in-evaluation path and the JAX
package's staged ControlNet, on TINY on the CPU.

A full-window canny unit and a windowed unit (live over the first 30% of
the steps only): the staged request gives the serial request's bytes, and
the JAX staged engine's pixels within 1 uint8 level with equal seeds and
infotexts (the tolerance of ``tests/test_torch_engine.py``). With a
stand-in capture backend, a plain staged request replays the serial
request's graphs, the first stage-ahead request captures its ``cnres``
(one per set of active units) and ``cnstep`` graphs, a repeat none; Heun
(two evaluations a step) keeps the tower inside the evaluation. A tower on
a mesh of its own gives the shared-device bytes (the mesh tests in
``tests/test_torch_parallel_rows.py`` hold it further). The engines and weights
are ``tests/test_torch_stage_graph.py``'s.
"""

from stable_diffusion_webui_distributed_tpu_torch import bridge
from stable_diffusion_webui_distributed_tpu_torch.models.configs import TINY
from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import Engine
from stable_diffusion_webui_distributed_tpu_torch.runtime import graphs
from stable_diffusion_webui_distributed_tpu_torch.runtime.interrupt import (
    GenerationState,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.mesh import (
    build_mesh,
)
from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
    METRICS,
)
from test_torch_stage_graph import (  # noqa: F401 — fixtures
    assert_near_jax,
    cn_body,
    cn_tree,
    engine,
    gates_off,
    jax_engine,
    jax_payload,
    params,
    payload,
    staged,
)
from test_torch_warmup import Stub, held_counts


class ListStub(Stub):
    """The stand-in capture backend, also for the ControlNet stage's list
    of residuals."""

    def replay(self, graph):
        fn, out = graph
        new = held_counts(fn)
        for o, n in zip(out if isinstance(out, list) else [out],
                        new if isinstance(new, list) else [new]):
            o.copy_(n)


def test_stage_ahead_controlnet_matches_evaluation_and_jax(
        engine, jax_engine, staged):
    serial = engine.txt2img(payload(**cn_body(n_iter=2)))
    staged.setenv("SDTPU_STAGE_GRAPH", "1")
    got = engine.txt2img(payload(**cn_body(n_iter=2)))
    assert got.images == serial.images
    assert_near_jax(got, jax_engine.txt2img(jax_payload(**cn_body(
        n_iter=2))))


def test_stage_ahead_captures_once_and_replays_the_serial_graphs(
        params, cn_tree, staged):
    """With the stand-in capture backend: a plain staged request replays
    the serial request's graphs; the first stage-ahead ControlNet request
    captures ``cnres`` and ``cnstep``, a repeat none, and gives the serial
    bytes; Heun keeps the tower inside the evaluation (no ``cnres``)."""
    sd = bridge.controlnet_flax_to_torch(cn_tree)
    eng = Engine(TINY, bridge.flax_to_torch(TINY, params), chunk_size=2,
                 state=GenerationState(), device="cpu",
                 controlnet_provider=lambda n: sd)
    eng._graphs = graphs.GraphCache(capture=ListStub())

    def run(body, on):
        if on:
            staged.setenv("SDTPU_STAGE_GRAPH", "1")
        else:
            staged.delenv("SDTPU_STAGE_GRAPH", raising=False)
        METRICS.clear()
        out = eng.txt2img(payload(**body))
        return out, dict(METRICS.summary()["compiles"])

    plain = dict(seed=5, n_iter=2)
    serial, caps = run(plain, False)
    assert caps == {"unet": 1}
    got, caps = run(plain, True)
    assert got.images == serial.images and caps == {}
    serial, caps = run(cn_body(), False)
    assert set(caps) == {"unet"}
    got, caps = run(cn_body(), True)
    assert got.images == serial.images
    assert caps == {"cnres": 2, "cnstep": 1}  # two unit sets, one UNet
    again, caps = run(cn_body(), True)
    assert again.images == serial.images and caps == {}
    serial, _ = run(cn_body(sampler_name="Heun", seed=47), False)
    got, caps = run(cn_body(sampler_name="Heun", seed=47), True)
    assert got.images == serial.images
    assert "cnres" not in caps and "cnstep" not in caps


def test_tower_on_a_device_of_its_own_is_not_ported(engine, staged):
    """The tower on a mesh of its own (``SDTPU_STAGE_CN_DEVICES``; here a
    patched ``_stage_cn_mesh`` over CPU devices) gives the shared-device
    stage-ahead bytes; the CPU engine's own rule gives no slice."""
    staged.setenv("SDTPU_STAGE_GRAPH", "1")
    shared = engine.txt2img(payload(**cn_body(batch_size=2)))
    for spec in ("dp=1", "dp=2"):
        tower = build_mesh(spec, devices=["cpu"] * 2)
        staged.setattr(engine, "_stage_cn_mesh", lambda t=tower: t)
        got = engine.txt2img(payload(**cn_body(batch_size=2)))
        if spec == "dp=1":
            assert got.images == shared.images
        else:
            # each replica of the tower runs one row
            assert_near_jax(got, shared)
    staged.undo()
    staged.setenv("SDTPU_STAGE_CN_DEVICES", "1")
    assert engine._stage_cn_mesh() is None  # the CPU engine: no slice
