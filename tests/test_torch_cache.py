"""The caching tier in the port against the JAX package, on TINY on the CPU.

Mirrors the classes of ``tests/test_cache.py``:

- keys: ``result_key``, ``embed_key`` and ``prefix_key`` give the JAX
  package's hex digests for the same inputs, and ignore or bind the same
  fields; ``prefix_boundary`` gives its answers;
- the bounded store and single-flight behave as the JAX package's;
- gate off and the armed first run give the same bytes;
- the embed cache hits both halves of a repeat, and a LoRA merge retires
  its entries (the engine's ``_model_epoch``/``_cond_epoch``, bumped as
  the JAX engine bumps them);
- a result hit is byte-exact with zero dispatches, concurrent repeats
  collapse to one generation, and a burst of hits leaves the dispatcher's
  metrics untouched;
- a prefix resume is byte-identical to the full denoise and within 1 uint8
  level of the JAX engine's image; the min-steps floor and the
  single-group rule hold;
- ``/internal/cache`` answers ``{"enabled": false}`` with the gate off and
  the JAX schema with it on, and after the same requests the port's
  summary has the JAX summary's keys and counts.

The engines run 4 steps in chunks of 2 with a prefix floor of 2 steps, so
that a prefix is captured at step 2 (the JAX test runs 8 steps in chunks
of 4); every request uses DPM++ 2M, whose history rides in the carry.
"""

import threading

import numpy as np
import pytest
import torch

import jax

from stable_diffusion_webui_distributed_tpu import cache as jax_cache
from stable_diffusion_webui_distributed_tpu.cache import (
    keys as jax_keys,
)
from stable_diffusion_webui_distributed_tpu.cache.store import (
    BoundedStore as JaxBoundedStore,
)
from stable_diffusion_webui_distributed_tpu.cache.store import (
    SingleFlight as JaxSingleFlight,
)
from stable_diffusion_webui_distributed_tpu.models.configs import TINY as JTINY
from stable_diffusion_webui_distributed_tpu.models.configs import (
    TINY_XL as JTINY_XL,
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
from stable_diffusion_webui_distributed_tpu.server.api import (
    ApiServer as JaxApiServer,
)
from stable_diffusion_webui_distributed_tpu.serving.bucketer import (
    ShapeBucketer as JaxBucketer,
)
from stable_diffusion_webui_distributed_tpu.serving.dispatcher import (
    ServingDispatcher as JaxDispatcher,
)
from stable_diffusion_webui_distributed_tpu_torch import bridge
from stable_diffusion_webui_distributed_tpu_torch import cache
from stable_diffusion_webui_distributed_tpu_torch.cache import (
    keys as cache_keys,
)
from stable_diffusion_webui_distributed_tpu_torch.cache import (
    prefix as cache_prefix,
)
from stable_diffusion_webui_distributed_tpu_torch.cache.store import (
    BoundedStore,
    SingleFlight,
)
from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
    TINY,
    TINY_XL,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import Engine
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
    b64png_to_array,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.stepcache import (
    prefix_boundary,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.interrupt import (
    GenerationState,
)
from stable_diffusion_webui_distributed_tpu_torch.server.api import ApiServer
from stable_diffusion_webui_distributed_tpu_torch.serving.bucketer import (
    ShapeBucketer,
)
from stable_diffusion_webui_distributed_tpu_torch.serving.dispatcher import (
    ServingDispatcher,
)
from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
    METRICS,
)
from test_pipeline import init_params

DEFAULTS = dict(prompt="a cow", steps=4, width=32, height=32, seed=7,
                sampler_name="DPM++ 2M")


def payload(**kw):
    return GenerationPayload(**{**DEFAULTS, **kw})


def jax_payload(**kw):
    return JaxPayload(**{**DEFAULTS, **kw})


@pytest.fixture(scope="module")
def params():
    return jax.device_get(jax.jit(init_params, static_argnums=0)(JTINY))


@pytest.fixture(scope="module")
def engine(params):
    return Engine(TINY, bridge.flax_to_torch(TINY, params), chunk_size=2,
                  state=GenerationState(), device="cpu")


@pytest.fixture(scope="module")
def jax_engine(params):
    return JaxEngine(JTINY, params, chunk_size=2, state=JaxState())


def dispatcher(engine):
    return ServingDispatcher(
        engine, bucketer=ShapeBucketer(shapes=[(32, 32)], batches=[1]),
        window=0.0)


def jax_dispatcher(engine):
    return JaxDispatcher(
        engine, bucketer=JaxBucketer(shapes=[(32, 32)], batches=[1]),
        window=0.0)


@pytest.fixture()
def cache_on(monkeypatch):
    monkeypatch.setenv("SDTPU_CACHE", "1")
    monkeypatch.setenv("SDTPU_CACHE_PREFIX_MIN_STEPS", "2")
    cache.clear_all()
    jax_cache.clear_all()
    yield
    cache.clear_all()
    jax_cache.clear_all()


# -- keys --------------------------------------------------------------------

FP = ("m", "fam", 0, 0, 0)

RESULT_CASES = [
    (dict(seed=3), FP, "txt2img", ""),
    (dict(seed=3, request_id="r-1"), FP, "txt2img", ""),
    (dict(seed=3), ("m", "fam", 1, 0, 0), "img2img", ""),
    (dict(seed=3, subseed=77, subseed_strength=0.5), FP, "txt2img", ""),
    (dict(seed=3, subseed=77), FP, "txt2img", "content-1"),
    (dict(seed=4, override_settings={"cfg_cutoff": 1.5},
          all_prompts=["a", "b"], batch_size=2), FP, "txt2img", ""),
]


@pytest.mark.parametrize("kw,fp,job,lora", RESULT_CASES)
def test_result_key_is_the_jax_digest(kw, fp, job, lora):
    assert cache_keys.result_key(payload(**kw), fp, job, lora=lora) == \
        jax_keys.result_key(jax_payload(**kw), fp, job, lora=lora)


@pytest.mark.parametrize("args", [
    ("a cow", 0, 1, FP, (), ""),
    ("blurry", 2, 3, ("tiny", "tiny", 4, 2, 1), ((77,), ()), ""),
    ("a (red:1.2) cow", 1, 1, FP, ((1, 2), (3,)), "te-content"),
    ("", 0, 1, FP, (), ""),
])
def test_embed_key_is_the_jax_digest(args):
    text, skip, chunks, fp, tower, lora = args
    assert cache_keys.embed_key(text, skip, chunks, fp, tower, lora) == \
        jax_keys.embed_key(text, skip, chunks, fp, tower, lora)


PREFIX_KW = dict(model_fp=FP, batch=1, width=32, height=32, steps=8,
                 cadence=1, sc_active=False, precision="bf16")


@pytest.mark.parametrize("kw,extra", [
    (dict(seed=3), {}),
    (dict(seed=3, denoising_strength=0.42, hr_scale=2.0,
          override_settings={"cfg_cutoff": 1.5}), {}),
    (dict(seed=3, override_settings={"deepcache": 2}),
     dict(cadence=2, sc_active=True)),
    (dict(seed=5), dict(precision="int8", lora="content")),
])
def test_prefix_key_is_the_jax_digest(kw, extra):
    kws = {**PREFIX_KW, **extra}
    assert cache_keys.prefix_key(payload(**kw), **kws) == \
        jax_keys.prefix_key(jax_payload(**kw), **kws)


@pytest.mark.parametrize("families", [(TINY, JTINY), (TINY_XL, JTINY_XL)])
def test_fingerprints_are_the_jax_tuples(families, engine, jax_engine):
    class Fake:
        def __init__(self, family):
            self.family = family
            self.model_name = "m"

    fam, jfam = families
    assert cache_keys.text_tower_fingerprint(Fake(fam)) == \
        jax_keys.text_tower_fingerprint(Fake(jfam))
    assert cache_keys.model_fingerprint(engine) == \
        jax_keys.model_fingerprint(jax_engine)


def test_result_key_canonical_under_field_order_and_defaults():
    a = payload(seed=3)
    b = GenerationPayload(seed=3, sampler_name="DPM++ 2M", height=32,
                          width=32, steps=4, prompt="a cow", cfg_scale=7.0,
                          n_iter=1)
    assert cache_keys.result_key(a, FP, "txt2img") == \
        cache_keys.result_key(b, FP, "txt2img")


def test_result_key_volatile_and_material_fields():
    k = cache_keys.result_key
    a = payload(seed=3, request_id="r-1")
    assert k(a, FP, "txt2img") == k(payload(seed=3, request_id="r-2"), FP,
                                    "txt2img")
    assert k(a, FP, "txt2img") != k(payload(seed=4), FP, "txt2img")
    assert k(a, FP, "txt2img") != k(a, FP, "img2img")
    assert k(a, FP, "txt2img") != k(a, ("m", "fam", 1, 0, 0), "txt2img")


def test_prefix_key_ignores_post_prefix_divergence():
    base = cache_keys.prefix_key(payload(seed=3), **PREFIX_KW)
    assert base == cache_keys.prefix_key(
        payload(seed=3, request_id="x", denoising_strength=0.42,
                hr_scale=2.0), **PREFIX_KW)
    assert base == cache_keys.prefix_key(
        payload(seed=3, override_settings={"cfg_cutoff": 1.5}), **PREFIX_KW)
    assert base != cache_keys.prefix_key(payload(seed=4), **PREFIX_KW)
    assert base != cache_keys.prefix_key(
        payload(seed=3, override_settings={"deepcache": 2}), **PREFIX_KW)
    for change in ({"sc_active": True}, {"precision": "int8"},
                   {"cadence": 2}):
        assert base != cache_keys.prefix_key(payload(seed=3),
                                             **{**PREFIX_KW, **change})


def test_prefix_boundary_rules():
    assert prefix_boundary(4, 1, 8, 4)
    assert not prefix_boundary(3, 1, 8, 4)      # below min_steps
    assert not prefix_boundary(5, 2, 8, 4)      # off-cadence
    assert prefix_boundary(6, 2, 8, 4)
    assert not prefix_boundary(6, 1, 5, 4)      # past the CFG cutoff


# -- bounded store + single flight: the JAX package's behaviour ---------------

STORES = [(BoundedStore, SingleFlight), (JaxBoundedStore, JaxSingleFlight)]


@pytest.mark.parametrize("store_cls", [s for s, _ in STORES])
def test_lru_eviction_under_byte_cap(store_cls):
    s = store_cls("t", max_bytes=100)
    assert s.put("a", 1, 40) and s.put("b", 2, 40)
    assert s.get("a") == 1          # refresh a: b is now LRU
    assert s.put("c", 3, 40)        # over cap -> evict b
    assert s.get("b") is None and s.get("a") == 1 and s.get("c") == 3
    assert s.stats() == {"entries": 2, "bytes": 80, "max_bytes": 100,
                         "hits": 3, "misses": 1, "puts": 3, "evictions": 1,
                         "hit_rate": 0.75}


@pytest.mark.parametrize("store_cls", [s for s, _ in STORES])
def test_oversized_entry_refused_and_peek_uncounted(store_cls):
    s = store_cls("t", max_bytes=10)
    assert not s.put("big", 1, 11)
    assert len(s) == 0 and s.stats()["puts"] == 0
    s.put("a", 1, 1)
    assert s.peek("a") == 1 and s.peek("zz") is None
    assert s.stats()["hits"] == 0 and s.stats()["misses"] == 0


@pytest.mark.parametrize("flight_cls", [f for _, f in STORES])
def test_single_flight_election_and_publish(flight_cls):
    sf = flight_cls()
    role1, f1 = sf.acquire("k")
    assert role1 == "leader"
    got = []

    def follow():
        role, f = sf.acquire("k")
        assert role == "wait"
        f.event.wait(5.0)
        got.append(f.value)

    ts = [threading.Thread(target=follow) for _ in range(3)]
    for t in ts:
        t.start()
    while sf.stats()["joined"] < 3:
        pass
    sf.publish("k", f1, "result")
    for t in ts:
        t.join(timeout=5.0)
        assert not t.is_alive()
    assert got == ["result"] * 3
    assert sf.stats() == {"led": 1, "joined": 3, "inflight": 0}


@pytest.mark.parametrize("flight_cls", [f for _, f in STORES])
def test_abandon_wakes_followers_for_reelection(flight_cls):
    sf = flight_cls()
    _role, f1 = sf.acquire("k")
    outcome = []

    def follow():
        role, f = sf.acquire("k")
        f.event.wait(5.0)
        outcome.append((role, f.value))

    t = threading.Thread(target=follow)
    t.start()
    while sf.stats()["joined"] < 1:
        pass
    sf.abandon("k", f1)
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert outcome == [("wait", None)]  # woken empty: the caller re-elects
    assert sf.acquire("k")[0] == "leader"


def test_leader_failure_lets_a_follower_generate(engine, cache_on,
                                                 monkeypatch):
    """A request whose generation raises abandons its flight; a waiting
    identical request elects itself and generates."""
    disp = dispatcher(engine)
    p = payload(seed=71, prompt="failing cow")
    real = disp._run
    calls = []

    def flaky(*args):
        calls.append(1)
        if len(calls) == 1:
            while cache.FLIGHTS.stats()["joined"] < 1:
                pass
            raise RuntimeError("leader failed")
        return real(*args)

    monkeypatch.setattr(disp, "_run", flaky)
    results, errors = [None, None], []

    def run(i):
        try:
            results[i] = disp.submit(p.model_copy())
        except RuntimeError as e:
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert len(errors) == 1 and len(calls) == 2
    assert sum(r is not None for r in results) == 1
    assert cache.FLIGHTS.stats() == {"led": 2, "joined": 1, "inflight": 0}


# -- gate off / first run ------------------------------------------------------

def test_gate_off_and_armed_first_run_match(engine, monkeypatch):
    monkeypatch.delenv("SDTPU_CACHE", raising=False)
    p = payload(seed=11, prompt="byte identity cow")
    off = dispatcher(engine).submit(p.model_copy())
    monkeypatch.setenv("SDTPU_CACHE", "1")
    cache.clear_all()
    try:
        on = dispatcher(engine).submit(p.model_copy())
    finally:
        cache.clear_all()
    assert off.images == on.images
    assert off.infotexts == on.infotexts and off.seeds == on.seeds


# -- embed dedupe ---------------------------------------------------------------

def test_second_request_hits_both_halves(engine, cache_on):
    disp = dispatcher(engine)
    # another seed: another result key, so the embed layer is what dedupes
    disp.submit(payload(seed=21, prompt="embed cow"))
    s1 = cache.embed_layer.summary()
    assert (s1["positive"]["misses"], s1["negative"]["misses"]) == (1, 1)
    assert s1["positive"]["hits"] == 0
    disp.submit(payload(seed=22, prompt="embed cow"))
    s2 = cache.embed_layer.summary()
    assert (s2["positive"]["hits"], s2["negative"]["hits"]) == (1, 1)
    assert s2["positive"]["misses"] == 1 and s2["bytes"] > 0
    assert cache.embed_layer.take_request_hits() == (0, 0)  # other thread


def test_cached_conditioning_is_the_fresh_encode(engine, cache_on):
    """A hit hands back the tensors the miss stored, equal to an encode
    with the gate off, and nothing writes into them."""
    p = payload(prompt="tensor cow")
    first = engine.run_on_device(engine.encode_prompts, p)
    again = engine.run_on_device(engine.encode_prompts, p)
    assert first[0][1] is again[0][1] and first[1][0] is again[1][0]
    snapshot = [t.clone() for t in (*first[0], *first[1])]
    engine.generate_range(p)
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("SDTPU_CACHE")
        engine._cond_cache.clear()
        fresh = engine.run_on_device(engine.encode_prompts, p)
    for a, b, c in zip((*first[0], *first[1]), snapshot,
                       (*fresh[0], *fresh[1])):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_lora_merge_retires_conditioning(engine, jax_engine, cache_on):
    """A merge bumps both epochs in both packages; the port's next encode
    of the same texts misses."""
    disp = dispatcher(engine)
    disp.submit(payload(seed=23, prompt="epoch cow"))
    before = (engine._model_epoch, engine._cond_epoch)
    jax_before = (jax_engine._model_epoch, jax_engine._cond_epoch)
    fp = cache_keys.model_fingerprint(engine)
    try:
        for eng in (engine, jax_engine):
            eng.set_loras([("absent", 1.0, 1.0)])
        assert (engine._model_epoch - before[0],
                engine._cond_epoch - before[1]) == (1, 1)
        assert (jax_engine._model_epoch - jax_before[0],
                jax_engine._cond_epoch - jax_before[1]) == (1, 1)
        assert cache_keys.model_fingerprint(engine) != fp
        disp.submit(payload(seed=24, prompt="epoch cow"))
        s = cache.embed_layer.summary()
        assert (s["positive"]["hits"], s["negative"]["hits"]) == (0, 0)
        assert (s["positive"]["misses"], s["negative"]["misses"]) == (2, 2)
    finally:
        for eng in (engine, jax_engine):
            eng.set_loras(())


def test_vae_swap_bumps_the_model_epoch(engine, params):
    before = (engine._model_epoch, engine._cond_epoch)
    sds = bridge.flax_to_torch(TINY, params)
    engine.set_vae({"vae": sds["vae"], "vae_encoder": sds["vae_encoder"]})
    engine.set_vae(None)
    assert (engine._model_epoch, engine._cond_epoch) == (before[0] + 2,
                                                         before[1])


# -- result dedupe --------------------------------------------------------------

def test_hit_is_byte_exact_with_zero_dispatches(engine, cache_on):
    disp = dispatcher(engine)
    p = payload(seed=31, prompt="dedupe cow")
    METRICS.clear()
    first = disp.submit(p.model_copy())
    assert METRICS.summary()["dispatches"] == 1
    second = disp.submit(p.model_copy())
    assert METRICS.summary()["dispatches"] == 1   # served, not run
    assert METRICS.summary()["requests"] == 1     # admission untouched
    assert second.images == first.images
    assert second.infotexts == first.infotexts
    assert second.images is not first.images      # a copy
    st = cache.result_store().stats()
    assert st["hits"] == 1 and st["puts"] == 1


def test_single_flight_collapses_concurrent_repeats(engine, cache_on):
    disp = dispatcher(engine)
    p = payload(seed=32, prompt="single flight cow")
    METRICS.clear()
    results, errors = [None] * 6, []

    def run(i):
        try:
            results[i] = disp.submit(p.model_copy())
        except Exception as e:  # noqa: BLE001 — surfaced by the assert
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors, errors
    assert METRICS.summary()["dispatches"] == 1  # one generation
    for r in results[1:]:
        assert r.images == results[0].images
    sf = cache.FLIGHTS.stats()
    assert sf["led"] == 1 and sf["inflight"] == 0


def test_distinct_seeds_never_share_an_entry(engine, cache_on):
    disp = dispatcher(engine)
    a = disp.submit(payload(seed=33, prompt="cache cow"))
    b = disp.submit(payload(seed=34, prompt="cache cow"))
    assert a.images != b.images and a.seeds != b.seeds
    assert cache.result_store().stats()["puts"] == 2


def test_dedupe_burst_leaves_dispatcher_metrics_untouched(engine, cache_on):
    disp = dispatcher(engine)
    p = payload(seed=51, prompt="eta cow")
    disp.submit(p.model_copy())  # generates and publishes
    before = METRICS.summary()  # requests, dispatches, queue wait
    for _ in range(5):  # a burst of repeats: all hits
        disp.submit(p.model_copy())
    assert METRICS.summary() == before
    assert cache.result_store().stats()["hits"] == 5


# -- denoise prefix sharing -----------------------------------------------------

def test_resume_is_byte_identical_to_full_denoise(engine, jax_engine,
                                                  monkeypatch):
    """A and B share their whole trajectory (``denoising_strength`` is
    inert on txt2img) under different result keys: B resumes from A's
    carry at step 2 and gives the bytes of a full run with the gate off,
    and the JAX engine's pixels within 1 level."""
    monkeypatch.delenv("SDTPU_CACHE", raising=False)
    p_b = payload(seed=41, prompt="prefix cow", denoising_strength=0.7)
    full = dispatcher(engine).submit(p_b.model_copy())

    monkeypatch.setenv("SDTPU_CACHE", "1")
    monkeypatch.setenv("SDTPU_CACHE_PREFIX_MIN_STEPS", "2")
    cache.clear_all()
    try:
        disp = dispatcher(engine)
        evals = []
        forward = engine.unet.forward
        monkeypatch.setattr(engine.unet, "forward", lambda *a, **k: (
            evals.append(1), forward(*a, **k))[1])
        disp.submit(payload(seed=41, prompt="prefix cow",
                            denoising_strength=0.4))
        assert cache_prefix.summary()["captured"] == 1
        assert len(evals) == 4  # DPM++ 2M: one UNet evaluation a step
        resumed = disp.submit(p_b.model_copy())
        assert len(evals) == 6  # resumed at step 2: steps 2 and 3
        assert cache_prefix.summary()["resumed"] == 1
        assert cache_prefix.take_resume_note() is None  # engine's thread
    finally:
        cache.clear_all()
    assert resumed.images == full.images
    assert resumed.infotexts == full.infotexts
    want = jax_engine.generate_range(jax_payload(seed=41, prompt="prefix cow"))
    diff = np.abs(b64png_to_array(resumed.images[0]).astype(np.int32)
                  - b64png_to_array(want.images[0]).astype(np.int32))
    assert diff.max() <= 1


def test_min_steps_floor_blocks_shallow_capture(engine, cache_on,
                                                monkeypatch):
    monkeypatch.setenv("SDTPU_CACHE_PREFIX_MIN_STEPS", "16")
    dispatcher(engine).submit(payload(seed=42, prompt="shallow cow"))
    assert cache_prefix.summary()["captured"] == 0


def test_multi_group_requests_are_not_prefix_keyed(engine, cache_on):
    assert cache_prefix.plan(
        engine, payload(seed=43, batch_size=2), batch=1, width=32,
        height=32, steps=4, end=4, cadence=1, sc_active=False,
        precision="bf16", cfg_stop=4) is None
    # a request of two groups of one runs two ranges of one latent row
    disp = dispatcher(engine)
    disp.submit(payload(seed=44, prompt="groups cow", n_iter=2))
    assert cache_prefix.summary()["captured"] == 0


# -- /internal/cache and the summary ----------------------------------------------

def test_route_and_gate_off_body(monkeypatch):
    monkeypatch.delenv("SDTPU_CACHE", raising=False)
    srv = ApiServer(object())
    assert ("GET", "/internal/cache") in srv.routes()
    assert srv.handle_cache() == {"enabled": False}


def schema(d):
    return {k: schema(v) if isinstance(v, dict) else type(v).__name__
            for k, v in d.items()}


def counts(d):
    """Every number of a summary but the result layer's bytes (the sizes
    of base64 PNGs whose pixels may differ by a level)."""
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out[k] = counts(v)
        elif not (k == "bytes" and "single_flight" in d):
            out[k] = v
    return out


def test_summary_matches_jax_after_the_same_requests(engine, jax_engine,
                                                     cache_on):
    """Two requests sharing a prompt, a repeat (a result hit) and a prefix
    pair, through both packages' dispatchers."""
    sequence = [dict(seed=61, prompt="summary cow"),
                dict(seed=62, prompt="summary cow"),
                dict(seed=61, prompt="summary cow"),
                dict(seed=62, prompt="summary cow", denoising_strength=0.3)]
    for kw in sequence:
        dispatcher(engine).submit(payload(**kw))
        jax_dispatcher(jax_engine).submit(jax_payload(**kw))
    port_body = ApiServer(object()).handle_cache()
    jax_body = JaxApiServer(object(), state=JaxState()).handle_cache()
    assert schema(port_body) == schema(jax_body)
    assert counts(port_body) == counts(jax_body)
    assert port_body["prefix"]["resumed"] == 1
    assert port_body["result"]["hits"] == 1
