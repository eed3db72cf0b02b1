"""The port's stage-graph executor (``parallel/stage_graph.py``) against
its serial paths and the JAX package's, on TINY on the CPU.

- ``StageGraph``, ``GraphRunner`` and ``OverlapClock`` against the JAX
  package's on the same scripted node functions and an injected clock:
  run order, results, ``on_stage`` calls, overlap seconds and the flush
  order under racing drains;
- staged txt2img (``n_iter`` 3, batch 2, depth 1 and 2, per-image prompts)
  gives the port's serial bytes exactly, and the JAX engine's staged
  pixels within 1 uint8 level with equal seeds and infotexts (the
  tolerance of ``tests/test_torch_engine.py``); a one-shot preempt hook
  between groups and an interrupt that drains the groups in flight (as
  JAX ``tests/test_stagegraph.py``);
- the stage-ahead ControlNet: ``tests/test_torch_stage_controlnet.py``;
  the dispatcher's staged groups: ``tests/test_torch_stage_dispatch.py``
  (each file stays under a minute alone).

The weights are TINY's parameter tree filled from a seeded numpy stream
(both packages take the same tree).
"""

import threading
import time

import numpy as np
import pytest

import jax

from stable_diffusion_webui_distributed_tpu.models import controlnet as jcn
from stable_diffusion_webui_distributed_tpu.models.configs import TINY as JTINY
from stable_diffusion_webui_distributed_tpu.parallel import (
    stage_graph as jsg,
)
from stable_diffusion_webui_distributed_tpu.pipeline.engine import (
    Engine as JaxEngine,
)
from stable_diffusion_webui_distributed_tpu.pipeline.payload import (
    GenerationPayload as JaxPayload,
)
from stable_diffusion_webui_distributed_tpu.runtime.interrupt import (
    GenerationState as JaxState,
)
from stable_diffusion_webui_distributed_tpu_torch import bridge
from stable_diffusion_webui_distributed_tpu_torch.models.configs import TINY
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    prometheus as obs_prom,
)
from stable_diffusion_webui_distributed_tpu_torch.parallel import (
    stage_graph as sg,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import Engine
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
    array_to_b64png,
    b64png_to_array,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.interrupt import (
    GenerationState,
)
from test_adapters import make_ldm_controlnet
from test_pipeline import init_params

#: seconds any one thread of a test may take before the test fails
THREAD_LIMIT = 60.0
CN = "stage-cn"

DEFAULTS = dict(prompt="a stage cow", negative_prompt="blurry", steps=4,
                width=32, height=32, seed=7, subseed=3,
                sampler_name="Euler a")


def payload(**kw):
    return GenerationPayload(**{**DEFAULTS, **kw})


def jax_payload(**kw):
    return JaxPayload(**{**DEFAULTS, **kw})


def _hint():
    y, x = np.mgrid[0:32, 0:32]
    return array_to_b64png(np.stack(
        [x * 8, y * 8, (x + y) * 4], axis=-1).astype(np.uint8))


#: a full-window unit and a windowed one, live in the first half only
UNITS = [
    {"enabled": True, "image": _hint(), "module": "canny", "model": CN,
     "weight": 1.0},
    {"enabled": True, "image": _hint(), "module": "none", "model": CN,
     "weight": 0.7, "guidance_start": 0.0, "guidance_end": 0.3},
]


def cn_body(**kw):
    return {**DEFAULTS, "prompt": "staged control", "steps": 6, "seed": 46,
            "alwayson_scripts": {"controlnet": {"args": UNITS}}, **kw}


@pytest.fixture(scope="module")
def params():
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda: init_params(JTINY))
    return jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.05).astype(s.dtype),
        shapes)


@pytest.fixture(scope="module")
def cn_tree():
    cfg = JTINY.unet
    return jax.device_get(jcn.convert_controlnet(make_ldm_controlnet(cfg),
                                                 cfg))


@pytest.fixture(scope="module")
def engine(params, cn_tree):
    sd = bridge.controlnet_flax_to_torch(cn_tree)
    return Engine(TINY, bridge.flax_to_torch(TINY, params), chunk_size=2,
                  state=GenerationState(), device="cpu",
                  controlnet_provider=lambda n: sd if n == CN else None)


@pytest.fixture(scope="module")
def jax_engine(params, cn_tree):
    return JaxEngine(JTINY, params, chunk_size=2, state=JaxState(),
                     controlnet_provider=lambda n: cn_tree if n == CN
                     else None)


@pytest.fixture
def staged(monkeypatch):
    monkeypatch.setenv("SDTPU_STAGE_GRAPH", "1")
    monkeypatch.delenv("SDTPU_STAGE_DEPTH", raising=False)
    return monkeypatch


@pytest.fixture(autouse=True)
def gates_off(monkeypatch):
    for name in ("SDTPU_STAGE_GRAPH", "SDTPU_STAGE_DEPTH", "SDTPU_CACHE",
                 "SDTPU_RAGGED", "SDTPU_FLEET", "SDTPU_STAGE_CN_DEVICES"):
        monkeypatch.delenv(name, raising=False)


def assert_near_jax(got, want):
    assert got.seeds == want.seeds
    assert got.infotexts == want.infotexts
    assert len(got.images) == len(want.images)
    for a, b in zip(got.images, want.images):
        pa = b64png_to_array(a).astype(np.int32)
        pb = b64png_to_array(b).astype(np.int32)
        assert pa.shape == pb.shape
        assert np.abs(pa - pb).max() <= 1


# -- the executor against the JAX package's ------------------------------------

class FakeClock:
    """perf_counter for both modules: each read advances it one second."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def scripted_graph(mod, clock, log, heard):
    g = mod.StageGraph(label="g", group=7, clock=clock,
                       on_stage=lambda n, s: heard.append((n, s)),
                       obs=False)
    g.add("encode", lambda: log.append("encode") or 2, kind="stage")
    g.add("denoise", lambda e: log.append(("denoise", e)) or e * 3,
          deps=("encode",), kind="denoise")
    g.add("decode", lambda d: log.append(("decode", d)) or d + 1,
          deps=("denoise",), kind="stage")
    g.add("merge", lambda e, d: log.append(("merge", e, d)) or (e, d),
          deps=("encode", "decode"), kind="stage")
    return g


def run_script(mod, monkeypatch):
    monkeypatch.setattr(mod.time, "perf_counter", FakeClock())
    clock = mod.OverlapClock()
    log, heard = [], []
    # another group's windows: one closed, one left open
    clock.begin_denoise("other", 1.5)
    clock.end_denoise("other", 4.5)
    clock.begin_denoise("open", 9.0)
    g = scripted_graph(mod, clock, log, heard)
    first = g.run(until="decode")
    rest = g.run()
    g.close_denoise()
    errors = []
    for args in (("encode", lambda: 0), ("x", lambda: 0, ("missing",))):
        try:
            g.add(*args)
        except ValueError as e:
            errors.append(str(e))
    return (log, heard, first, rest, g.stage_seconds(), g.stage_overlap(),
            clock.summary(), clock.overlap_of(0.0, 20.0, "g"),
            [(n, g.node(n).t0, g.node(n).t1) for n in
             ("encode", "denoise", "decode", "merge")], errors)


def test_stage_graph_and_clock_match_jax(monkeypatch):
    got = run_script(sg, monkeypatch)
    want = run_script(jsg, monkeypatch)
    assert got == want
    log, heard, first, rest = got[:4]
    assert log == ["encode", ("denoise", 2), ("decode", 6), ("merge", 2, 7)]
    assert [n for n, _ in heard] == ["encode", "denoise", "decode", "merge"]
    assert set(first) == {"encode", "denoise", "decode"}
    assert rest["merge"] == (2, 7)
    assert got[6]["stage_overlap_ratio"] > 0


def test_knobs_match_jax(monkeypatch):
    for env in ({}, {"SDTPU_STAGE_GRAPH": "1", "SDTPU_STAGE_DEPTH": "3",
                     "SDTPU_STAGE_CN_DEVICES": "2"},
                {"SDTPU_STAGE_DEPTH": "0", "SDTPU_STAGE_CN_DEVICES": "-1"}):
        for k in ("SDTPU_STAGE_GRAPH", "SDTPU_STAGE_DEPTH",
                  "SDTPU_STAGE_CN_DEVICES"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert (sg.enabled(), sg.depth(), sg.cn_slice_devices()) == \
            (jsg.enabled(), jsg.depth(), jsg.cn_slice_devices())
    assert sg.to_mesh("x", None, batch=True) == "x"
    assert sg.LANES == jsg.LANES


def racing_runner(mod, depth):
    """Eight graphs submitted on one thread while three others drain:
    the flushes, in the order they ran."""
    runner = mod.GraphRunner(depth=depth, clock=mod.OverlapClock())
    flushed = []
    stop = threading.Event()

    def drainer():
        while not stop.is_set():
            runner.drain()
            time.sleep(0.0005)

    threads = [threading.Thread(target=drainer) for _ in range(3)]
    for t in threads:
        t.start()
    for i in range(8):
        g = mod.StageGraph(group=i, clock=None, obs=False)
        g.add("decode", lambda i=i: i)

        def flush(res, i=i):
            time.sleep(0.001)
            flushed.append(res["decode"])

        runner.submit(g, flush)
    stop.set()
    for t in threads:
        t.join(THREAD_LIMIT)
    runner.drain()
    return flushed, runner.flushed, runner.in_flight()


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_flush_order_under_racing_drains(depth):
    for mod in (sg, jsg):
        assert racing_runner(mod, depth) == (list(range(8)), 8, 0)


def test_runner_window_matches_jax():
    """Without racing drains, which submit flushes which group."""
    out = {}
    for mod in (sg, jsg):
        for depth in (1, 2):
            runner = mod.GraphRunner(depth=depth)
            seen = []
            for i in range(5):
                g = mod.StageGraph(group=i, obs=False)
                g.add("decode", lambda i=i: i)
                runner.submit(g, lambda res: seen.append(res["decode"]))
                seen.append(("submitted", i, runner.in_flight()))
            runner.drain()
            out[(mod.__name__.split(".")[0], depth)] = seen
    port = [v for k, v in sorted(out.items()) if "torch" in k[0]]
    jax_ = [v for k, v in sorted(out.items()) if "torch" not in k[0]]
    assert port == jax_


def test_stage_histograms_are_fed():
    obs_prom.clear_histograms()
    g = sg.StageGraph(group=1)
    g.add("encode", lambda: None)
    g.run()
    hists = obs_prom.stage_graph_histograms()
    assert set(hists) == {"encode"}
    assert hists["encode"].name == "sdtpu_stage_graph_seconds"
    assert hists["encode"].snapshot()[2] == 1


# -- staged txt2img ---------------------------------------------------------------

TXT2IMG = {
    "n_iter-3-batch-2": dict(seed=81, n_iter=3, batch_size=2),
    "per-image-prompts": dict(seed=83, batch_size=2, n_iter=2,
                              all_prompts=["a red cow", "a blue cow",
                                           "a cow (in a field:1.2)",
                                           "a green cow"]),
}


@pytest.mark.parametrize("name", sorted(TXT2IMG))
def test_staged_txt2img_matches_serial_and_jax(engine, jax_engine, staged,
                                               name):
    body = TXT2IMG[name]
    staged.delenv("SDTPU_STAGE_GRAPH")
    serial = engine.txt2img(payload(**body))
    staged.setenv("SDTPU_STAGE_GRAPH", "1")
    for depth in ("1", "2"):
        staged.setenv("SDTPU_STAGE_DEPTH", depth)
        got = engine.txt2img(payload(**body))
        assert got.images == serial.images
        assert got.infotexts == serial.infotexts
        assert got.prompts == serial.prompts
    assert_near_jax(got, jax_engine.txt2img(jax_payload(**body)))


def test_preempt_between_groups_changes_no_bytes(engine, staged):
    batch_p, inter_p = payload(seed=70, n_iter=3), payload(seed=71)
    baseline = engine.txt2img(batch_p)
    inter_base = engine.txt2img(inter_p)

    class OneShotHook:
        polls = fired = 0
        result = None

        def should_yield(self):
            self.polls += 1
            return self.fired == 0 and self.polls >= 2

        def yield_device(self):
            self.fired += 1
            self.result = engine.txt2img(inter_p)

    hook = OneShotHook()
    engine.preempt_hook = hook
    try:
        resumed = engine.txt2img(batch_p)
    finally:
        engine.preempt_hook = None
    assert hook.fired == 1
    assert resumed.images == baseline.images
    assert hook.result.images == inter_base.images


def test_interrupt_drains_the_groups_in_flight(engine, staged):
    p = payload(seed=90, n_iter=3)
    baseline = engine.txt2img(p)
    flushes = []
    orig = engine._flush_decoded

    def flush_and_interrupt(out, pl, entries):
        orig(out, pl, entries)
        flushes.append(len(entries))
        if len(flushes) == 1:
            engine.state.flag.interrupt()

    staged.setattr(engine, "_flush_decoded", flush_and_interrupt)
    got = engine.txt2img(p)
    # group 0 flushed, then the latch rose; group 1 was in flight and
    # still drained; group 2 was never submitted
    assert len(got.images) == 2
    assert got.images == baseline.images[:2]
    with sg.CLOCK._lock:
        assert not sg.CLOCK._open  # every window closed


def test_reproducible_flags_hold_while_any_engine_generates():
    """Two engines generating at once on their own device threads (a
    fleet's local remote, the warm pool's residents): the first to leave
    must not put the process-wide cuDNN and TF32 flags back under the
    other. The flags are set by the first to enter and restored by the
    last to leave."""
    import torch

    from stable_diffusion_webui_distributed_tpu_torch.pipeline import (
        engine as engine_mod,
    )

    flags = [(torch.backends.cudnn, "deterministic"),
             (torch.backends.cudnn, "allow_tf32"),
             (torch.backends.cuda.matmul, "allow_tf32")]
    before = [getattr(o, n) for o, n in flags]
    held = [True, False, False]
    card = torch.device("cuda")
    try:
        for o, n in flags:  # what another library may have left
            setattr(o, n, not held[flags.index((o, n))])
        a = engine_mod._reproducible(card)
        b = engine_mod._reproducible(card)
        a.__enter__()
        b.__enter__()
        assert [getattr(o, n) for o, n in flags] == held
        a.__exit__(None, None, None)
        assert [getattr(o, n) for o, n in flags] == held
        b.__exit__(None, None, None)
        assert [getattr(o, n) for o, n in flags] == [not h for h in held]
    finally:
        for (o, n), v in zip(flags, before):
            setattr(o, n, v)
