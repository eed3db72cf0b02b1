"""The port's warmup sweep and graph cache against the JAX package's warmup.

``serving/warmup.py``: the traced-LoRA cells parsed from
``SDTPU_WARMUP_LORA`` and the sweep's report (its points, steps, sampler,
precisions and cells, and the payloads each point runs) must equal the JAX
package's for the same ladder and knobs, the precision rungs of
``SDTPU_WARMUP_PRECISIONS`` included; ``SDTPU_WARMUP=0`` skips without
touching the engine. The port's report has the JAX package's keys but
``xla_cache_dir``, which names a compilation cache the port does not
have (the ``aot`` block comes with ``SDTPU_AOT`` on in both packages; it
is held in ``tests/test_torch_aot.py``).

``runtime/graphs.py``: on the CPU the cache runs with a stand-in capture
backend (``Stub``: the "graph" is the function, replayed on the static
buffers with the launch counters held, as a real replay skips the wrappers'
Python). A TINY engine swept and then asked for a request gives the pixels
of a fresh engine exactly and the JAX engine's within 1 uint8 level (f32,
as ``tests/test_torch_engine.py`` holds them; one seeded model for both,
the port's weights laid out as the JAX package's Flax tree); a second sweep
captures nothing; replayed launch deltas add up to the eager counts; new
signatures capture anew; past the static budget the least recently used
entries go; dropping the engine drops its graphs.
"""

import functools
import gc
import weakref

import numpy as np
import pytest
import torch

import jax

from stable_diffusion_webui_distributed_tpu.models.configs import TINY as JTINY
from stable_diffusion_webui_distributed_tpu.pipeline.engine import (
    Engine as JaxEngine,
)
from stable_diffusion_webui_distributed_tpu.pipeline.payload import (
    GenerationPayload as JaxPayload,
)
from stable_diffusion_webui_distributed_tpu.runtime import mesh as jax_mesh
from stable_diffusion_webui_distributed_tpu.runtime.interrupt import (
    GenerationState as JaxState,
)
from stable_diffusion_webui_distributed_tpu.serving import (
    warmup as jax_warmup,
)
from stable_diffusion_webui_distributed_tpu.serving.bucketer import (
    ShapeBucketer as JaxBucketer,
)
from stable_diffusion_webui_distributed_tpu.serving.metrics import (
    METRICS as JAX_METRICS,
)
from stable_diffusion_webui_distributed_tpu_torch import bridge, cli
from stable_diffusion_webui_distributed_tpu_torch.models.configs import TINY
from stable_diffusion_webui_distributed_tpu_torch.ops import (
    flash_attention as fa,
)
from stable_diffusion_webui_distributed_tpu_torch.ops import (
    ragged_attention as ra,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import Engine
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
    b64png_to_array,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import graphs
from stable_diffusion_webui_distributed_tpu_torch.runtime.interrupt import (
    GenerationState,
)
from stable_diffusion_webui_distributed_tpu_torch.server import api
from stable_diffusion_webui_distributed_tpu_torch.serving import warmup
from stable_diffusion_webui_distributed_tpu_torch.serving.bucketer import (
    ShapeBucketer,
)
from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
    METRICS,
)
from test_pipeline import init_params
from test_torch_lora import make_adapter


def held_counts(fn):
    """``fn()`` with the kernel wrappers' launch counts put back after it."""
    saved = [(w, w.launches, dict(w.path_launches)) for w in graphs.COUNTED]
    try:
        return fn()
    finally:
        for w, n, paths in saved:
            w.launches = n
            w.path_launches.update(paths)


class Stub:
    """A capture backend for the CPU: the graph is the function itself; a
    replay runs it on the static buffers into the static output, the
    wrappers' counts held (a graph replay runs no Python)."""

    def eager(self, fn):
        return fn()

    def capture(self, fn):
        out = fn()
        return (fn, out), out

    def replay(self, graph):
        fn, out = graph
        out.copy_(held_counts(fn))


def reset_counts():
    for w in graphs.COUNTED:
        fa.reset_launches(w)


# -- the sweep against the JAX package's, on recording engines ----------------

class RecordingEngine:
    """What ``warmup_engine`` touches of an engine, both packages' way:
    the state's ``begin_request``, ``_warmup_lora`` and ``generate_range``,
    each call recorded."""

    def __init__(self):
        self.calls = []
        self._warmup_lora = self._traced_lora = None
        self.state = self

    def begin_request(self):
        self.calls.append("begin")

    def generate_range(self, payload, start, count, job):
        self.calls.append((payload.prompt, payload.steps, payload.width,
                           payload.height, payload.batch_size,
                           payload.sampler_name, payload.seed,
                           payload.precision, self._warmup_lora, start,
                           count, job))


class Untouchable:
    def __getattr__(self, name):
        raise AssertionError(f"the skipped sweep touched engine.{name}")


@pytest.fixture
def no_xla_cache(monkeypatch):
    # the JAX sweep turns on XLA's persistent cache; keep it off the disk
    monkeypatch.setattr(jax_mesh, "enable_compilation_cache",
                        lambda cache_dir=None: None)


@pytest.mark.parametrize("traced,raw,want", [
    # tests/test_lora_traced.py TestWarmupCells, the JAX package's own case
    ("1", "r16s1, r10s3,junk,r999s1,r16s1", [None, (16, 1), (16, 4)]),
    ("", "r16s1", [None]),
    ("1", "", [None]),
    ("1", "R8S2, ,r64s4,r0s1,r16s0", None),
    ("0", "r32s1", [None]),
])
def test_lora_cells_match_jax(monkeypatch, traced, raw, want):
    monkeypatch.setenv("SDTPU_LORA_TRACED", traced)
    monkeypatch.setenv("SDTPU_WARMUP_LORA", raw)
    got = warmup._warmup_lora_cells()
    assert got == jax_warmup._warmup_lora_cells()
    if want is not None:
        assert got == want


@pytest.mark.parametrize("ladder,env,kwargs", [
    (None, {}, {}),
    (([(64, 64), (64, 32)], [1, 2]),
     {"SDTPU_WARMUP_STEPS": "3", "SDTPU_WARMUP_SAMPLER": "DPM++ 2M"}, {}),
    (([(32, 32)], [2]), {"SDTPU_LORA_TRACED": "1",
                         "SDTPU_WARMUP_LORA": "r16s1,r64s3"},
     {"steps": 4, "sampler": "Euler"}),
    (([(32, 32)], [1, 2]), {"SDTPU_WARMUP_PRECISIONS": ",int8+conv,int8",
                            "SDTPU_LORA_TRACED": "1",
                            "SDTPU_WARMUP_LORA": "r16s1"}, {"steps": 2}),
])
def test_report_and_points_match_jax(monkeypatch, no_xla_cache, ladder, env,
                                     kwargs):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    port_b = ShapeBucketer(*ladder) if ladder else None
    jax_b = JaxBucketer(*ladder) if ladder else None
    port_e, jax_e = RecordingEngine(), RecordingEngine()
    got = warmup.warmup_engine(port_e, port_b, **kwargs)
    want = jax_warmup.warmup_engine(jax_e, jax_b, **kwargs)
    assert set(got) == set(want) - {"xla_cache_dir"}
    for key in ("skipped", "buckets", "steps", "sampler", "precisions",
                "lora_cells"):
        assert got[key] == want[key], key
    assert port_e.calls == jax_e.calls
    assert port_e._warmup_lora is None and port_e._traced_lora is None
    assert got["stage_builds"] == {}  # a recording engine captures nothing


def test_disabled_sweep_touches_nothing(monkeypatch, no_xla_cache):
    monkeypatch.setenv("SDTPU_WARMUP", "0")
    got = warmup.warmup_engine(Untouchable())
    assert got == jax_warmup.warmup_engine(Untouchable())
    assert got == {"skipped": True, "reason": "SDTPU_WARMUP=0"}


@pytest.mark.parametrize("raw,want", [
    ("int8", ["int8"]),
    (",int8", ["", "int8"]),
    ("bf16,int8", ["bf16", "int8"]),
    ("w8a8, INT8-conv,int8,nonsense", ["int8", "int8+conv", ""]),
    ("", [""]),
])
def test_precision_rungs_match_jax(monkeypatch, raw, want):
    """``SDTPU_WARMUP_PRECISIONS`` gives the JAX package's rungs: each
    bucketed onto the ladder, "" the policy's default."""
    monkeypatch.setenv("SDTPU_WARMUP_PRECISIONS", raw)
    assert warmup._warmup_precisions() == \
        jax_warmup._warmup_precisions() == want


def test_metrics_count_captures_as_jax_counts_compiles():
    METRICS.clear()
    JAX_METRICS.clear()
    for m in (METRICS, JAX_METRICS):
        m.record_compile("unet")
        m.record_compile("unet")
        m.record_compile("ragged")
    assert METRICS.summary()["compiles"] == \
        JAX_METRICS.summary()["compiles"] == {"unet": 2, "ragged": 1}
    METRICS.clear()
    assert METRICS.summary()["compiles"] == {}


# -- the graph cache's bookkeeping -----------------------------------------

def launching_fn(run, call, scalars):
    """An evaluation that "launches" as the wrappers count: two K1
    launches on the Hopper path, one K2 launch on the general path."""
    fa.count_launch(fa.flash_attention, 2)
    fa.count_launch(fa.flash_attention, 2)
    fa.count_launch(ra.ragged_attention, 1)
    return call["x"] * scalars[0] + run["c"].sum(dim=-1)


@pytest.mark.parametrize("broadcast", [False, True])
def test_replayed_launch_deltas_add_up_to_eager_counts(broadcast):
    gen = torch.Generator().manual_seed(0)
    c = torch.randn(3, generator=gen)
    run = {"c": c.expand(4, 3) if broadcast else c.repeat(4, 1)}
    xs = [torch.randn(4, generator=gen) for _ in range(5)]
    reset_counts()
    want = [launching_fn(run, {"x": x}, torch.tensor([0.5 * i]))
            for i, x in enumerate(xs)]
    eager = [(w.launches, dict(w.path_launches)) for w in graphs.COUNTED]

    reset_counts()
    METRICS.clear()
    cache = graphs.GraphCache(capture=Stub())
    binding = cache.binding()
    got = [cache.run(("unet", ()), "unet", launching_fn, run, {"x": x},
                     [0.5 * i], binding).clone() for i, x in enumerate(xs)]
    assert [(w.launches, dict(w.path_launches))
            for w in graphs.COUNTED] == eager
    assert eager[0] == (10, {"f32": 0, "general": 0, "hopper": 10})
    assert eager[1] == (5, {"f32": 0, "general": 5, "hopper": 0})
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    (entry,) = cache.entries()
    assert entry.replays == 4
    assert entry.run["c"].base.shape == ((3,) if broadcast else (4, 3))
    assert METRICS.summary()["compiles"] == {"unet": 1}

    # a new binding reloads the per-run inputs
    run2 = {"c": run["c"] * 2}
    out = cache.run(("unet", ()), "unet", launching_fn, run2, {"x": xs[0]},
                    [1.0], cache.binding())
    assert torch.equal(out, launching_fn(run2, {"x": xs[0]},
                                         torch.tensor([1.0])))
    reset_counts()


@pytest.mark.parametrize("change", [
    "tag", "run name", "run shape", "dtype", "broadcast", "scalars"])
def test_new_signatures_capture_anew(change):
    def fn(run, call, scalars):
        return call["x"] + scalars.sum()

    base = dict(tag=("unet", ()), run={"c": torch.zeros(2, 3)},
                call={"x": torch.zeros(2)}, scalars=[1.0])
    changed = {
        "tag": dict(base, tag=("unet", ((0, 1),))),
        "run name": dict(base, run={"d": torch.zeros(2, 3)}),
        "run shape": dict(base, run={"c": torch.zeros(2, 4)}),
        "dtype": dict(base, call={"x": torch.zeros(2, dtype=torch.float64)}),
        "broadcast": dict(base, run={"c": torch.zeros(3).expand(2, 3)}),
        "scalars": dict(base, scalars=[1.0, 2.0]),
    }[change]
    cache = graphs.GraphCache(capture=Stub())
    for args in (base, base, changed, changed, base):
        cache.run(args["tag"], "unet", fn, args["run"], args["call"],
                  args["scalars"], cache.binding())
    assert len(cache) == 2
    assert sorted(e.replays for e in cache.entries()) == [1, 2]


def test_budget_drops_least_recently_used_entries(monkeypatch):
    def fn(run, call, scalars):
        return call["x"] + run["c"].sum() + scalars[0]

    def entry_for(n):  # static bytes: c (n f32) + x (2 f32) + out + scalar
        return {"c": torch.ones(n)}, {"x": torch.zeros(2)}

    per_entry = 4 * (1000 + 2 + 2 + 1)
    monkeypatch.setattr(graphs, "STATIC_BUDGET", int(2.5 * per_entry))
    cache = graphs.GraphCache(capture=Stub())
    METRICS.clear()
    for n in (1000, 1001, 1000, 1002, 1001):
        cache.run(("unet", ()), "unet", fn, *entry_for(n), [1.0],
                  cache.binding())
    # 1000 was replayed after 1001 was captured, so 1001 went first when
    # 1002 came; captured again at its next call, it pushed 1000 out
    shapes = [e.run["c"].base.shape[0] for e in cache.entries()]
    assert shapes == [1002, 1001]
    assert METRICS.summary()["compiles"] == {"unet": 4}
    assert [e.nbytes() for e in cache.entries()] == [
        per_entry + 8, per_entry + 4]


def test_cpu_tensors_run_eagerly_without_a_backend():
    cache = graphs.GraphCache()
    out = cache.run(("unet", ()), "unet",
                    lambda run, call, s: call["x"] * s[0], {},
                    {"x": torch.ones(2)}, [3.0], cache.binding())
    assert torch.equal(out, torch.full((2,), 3.0))
    assert len(cache) == 0


def test_flatten_round_trips_a_lora_tree():
    tree = {"down_0_attn_0": {"block_0": {"attn1": {
        "qkv": {"down": torch.zeros(1, 2), "up": torch.ones(2, 1)}}}},
        "mid_attn": {"proj_in": {"down": torch.zeros(3)}}}
    flat = graphs.flatten(tree, "lora")
    assert sorted(flat) == ["lora/down_0_attn_0/block_0/attn1/qkv/down",
                            "lora/down_0_attn_0/block_0/attn1/qkv/up",
                            "lora/mid_attn/proj_in/down"]
    back = graphs.unflatten({"ctx": torch.zeros(1), **flat}, "lora")
    assert back.keys() == tree.keys()
    assert back["mid_attn"]["proj_in"]["down"] is \
        tree["mid_attn"]["proj_in"]["down"]
    assert graphs.unflatten({"ctx": torch.zeros(1)}, "lora") is None


# -- engines: the sweep, then a request --------------------------------------

REQUEST = dict(prompt="a cow", negative_prompt="blurry", steps=2, width=64,
               height=64, batch_size=2, seed=42)
LADDER = ([(64, 64)], [1, 2])


def flax_tree(sd, shapes, prefix=()):
    """The Flax tree of ``shapes`` (``jax.eval_shape`` of the JAX init)
    filled from the port's state dict ``sd``: ``bridge.flax_to_torch``
    inverted (Linear (out, in) -> Dense (in, out), OIHW -> HWIO)."""
    out = {}
    for key, node in shapes.items():
        path = prefix + (key,)
        if hasattr(node, "items"):
            out[key] = flax_tree(sd, node, path)
            continue
        *mods, leaf = path
        name = ".".join(mods + ["weight" if leaf in ("kernel", "scale",
                                                     "embedding") else leaf])
        t = sd[name]
        if leaf == "kernel":
            t = t.t() if t.dim() == 2 else t.permute(2, 3, 1, 0)
        assert tuple(t.shape) == tuple(node.shape), name
        out[key] = np.ascontiguousarray(t.numpy())
    return out


@pytest.fixture(scope="module")
def params():
    """One seeded TINY model for both packages: the port's
    ``bridge.init_seeded`` weights, and the same weights as the JAX
    package's Flax tree (whose layout ``jax.eval_shape`` of the JAX init
    gives without compiling it); ``bridge.flax_to_torch`` of that tree
    gives the port's state dicts back exactly."""
    sds = bridge.init_seeded(TINY, 0, device="cpu")
    shapes = jax.eval_shape(functools.partial(init_params, JTINY))
    tree = {"text_encoder": flax_tree(sds["text_encoder"],
                                      shapes["text_encoder"]),
            "text_encoder_2": None,
            "unet": flax_tree(sds["unet"], shapes["unet"]),
            "vae": {"decoder": flax_tree(sds["vae"],
                                         shapes["vae"]["decoder"]),
                    "encoder": flax_tree(sds["vae_encoder"],
                                         shapes["vae"]["encoder"])}}
    assert set(shapes["vae"]) == {"decoder", "encoder"}
    back = bridge.flax_to_torch(TINY, tree)
    for name, sd in sds.items():
        assert back[name].keys() == sd.keys()
        assert all(torch.equal(back[name][k], v) for k, v in sd.items())
    return tree


def port_engine(params, capture=None, **kw):
    engine = Engine(TINY, bridge.flax_to_torch(TINY, params), chunk_size=4,
                    state=GenerationState(), device="cpu", **kw)
    if capture is not None:
        engine._graphs = graphs.GraphCache(capture=capture)
    return engine


def test_request_after_warmup_matches_fresh_engine_and_jax(params):
    warm = port_engine(params, Stub())
    METRICS.clear()
    report = warmup.warmup_engine(warm, ShapeBucketer(*LADDER), steps=2,
                                  sampler="Euler a")
    assert report["buckets"] == [(64, 64, 1), (64, 64, 2)]
    assert report["stage_builds"] == {"unet": 2}
    again = warmup.warmup_engine(warm, ShapeBucketer(*LADDER), steps=2,
                                 sampler="Euler a")
    assert again["stage_builds"] == {}  # JAX tests/test_serving.py:299-300

    got = warm.txt2img(GenerationPayload(**REQUEST))
    assert len(warm._graphs) == 2  # the request replayed the sweep's graph
    fresh = port_engine(params).txt2img(GenerationPayload(**REQUEST))
    assert got.images == fresh.images
    assert got.infotexts == fresh.infotexts
    want = JaxEngine(JTINY, params, chunk_size=4,
                     state=JaxState()).txt2img(JaxPayload(**REQUEST))
    assert got.seeds == want.seeds and got.infotexts == want.infotexts
    for a, b in zip(got.images, want.images):
        pa = b64png_to_array(a).astype(np.int32)
        pb = b64png_to_array(b).astype(np.int32)
        assert np.abs(pa - pb).max() <= 1
        assert pa.std() > 1.0


def test_warmed_lora_cell_serves_an_adapter_by_replay(params, monkeypatch):
    # the sweep's all-zero stand-in set captures the (16, 1) cell's graph;
    # a request with a rank-4 adapter (its fused q/k/v site at rank 12)
    # replays it with its own factors loaded
    monkeypatch.setenv("SDTPU_LORA_TRACED", "1")
    monkeypatch.setenv("SDTPU_WARMUP_LORA", "r12s1")
    adapters = {"a": make_adapter(TINY, rank=4, seed=1)}
    warm = port_engine(params, Stub(), lora_provider=adapters.get)
    METRICS.clear()
    report = warmup.warmup_engine(warm, ShapeBucketer([(32, 32)], [1]),
                                  steps=2)
    assert report["lora_cells"] == ["r16s1"]
    assert report["buckets"] == [(32, 32, 1), (32, 32, 1, "r16s1")]
    assert report["stage_builds"] == {"unet": 2}
    assert warm._warmup_lora is None and warm._traced_lora is None
    payload = GenerationPayload(prompt="a cow <lora:a:0.8>", steps=2,
                                width=32, height=32, seed=5)
    got = warm.txt2img(payload)
    assert METRICS.summary()["compiles"] == {"unet": 2}
    assert (warm._traced_lora.rank_bucket, warm._traced_lora.slots) == \
        (16, 1)
    fresh = port_engine(params, lora_provider=adapters.get)
    assert got.images == fresh.txt2img(payload).images


def test_dropping_the_engine_drops_its_graphs(params):
    engine = port_engine(params, Stub())
    engine.txt2img(GenerationPayload(**dict(REQUEST, width=32, height=32)))
    (entry,) = engine._graphs.entries()
    refs = [weakref.ref(engine._graphs), weakref.ref(entry.output),
            weakref.ref(entry.run["ctx"].base)]
    del engine, entry
    gc.collect()
    assert [r() for r in refs] == [None] * 3


def test_cli_serve_sweeps_before_serving(tmp_path, monkeypatch, capsys):
    for name, value in {"SDTPU_WARMUP": "1", "SDTPU_BUCKET_LADDER": "32x32",
                        "SDTPU_BATCH_LADDER": "1",
                        "SDTPU_WARMUP_STEPS": "2"}.items():
        monkeypatch.setenv(name, value)
    order = []
    sweep = warmup.warmup_engine

    def recorded_sweep(engine, bucketer):
        order.append(("sweep", engine.family.name, bucketer.shapes,
                      bucketer.batches))
        return sweep(engine, bucketer)

    monkeypatch.setattr(warmup, "warmup_engine", recorded_sweep)
    monkeypatch.setattr(api.ApiServer, "serve_forever",
                        lambda self: order.append("serve"))
    assert cli.main(["serve", "--family", "tiny", "--device", "cpu",
                     "--port", "0", "--model-dir", str(tmp_path / "models"),
                     "--distributed-config",
                     str(tmp_path / "fleet.json")]) == 0
    assert order == [("sweep", "tiny", [(32, 32)], [1]), "serve"]
    err = capsys.readouterr().err
    assert "serve: warmup {'skipped': False, 'buckets': [(32, 32, 1)]" in err
