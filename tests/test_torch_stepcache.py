"""The step cache in the port against the JAX package, on the CPU.

``pipeline/stepcache.py``'s bookkeeping (``bucket_cadence``, ``resolve``
from the environment and ``override_settings``, ``cutoff_step``,
``plan_schedule``, ``prefix_boundary``) equals the JAX package's over the
same inputs. The UNet's ``cache_mode`` ``"deep"`` and ``"reuse"`` calls
(TINY, and TINY_XL, whose top level has no attention) equal the JAX UNet's
in f32 within 1e-4 absolute (deep: its features run to 16, measured
1.6e-5) and 2e-5 (reuse, measured 1.5e-6); a deep call followed by a
reuse call gives the plain call's exact bits, as it does in the JAX
package (the same operations in the same order).

Whole engines on the same seeded weights (``chunk_size`` 4 in both):
txt2img at cadence 3 with a cutoff, Heun at cadence 2 with a cutoff (two
evaluations a step, one at the last), inpainting with a mask at cadence 3
(the pinning noise does not move), a ControlNet unit whose window covers
one of two chunks (that chunk runs plain and invalidates the cache), TINY_XL
at int8 and cadence 3: pixels within 1 level of the JAX engine's (the f32
step cache is exact up to summation order), 32 levels and 5 on average
where int8 is in (``test_torch_quant.py``). The engine's own evaluation
counts equal ``plan_schedule``'s. The JAX package's rules hold on the
port: an inactive step cache gives the plain bytes and graph kinds, cadence
3 with a cutoff keeps PSNR >= 20 dB and SSIM >= 0.5 against the plain run
(JAX ``tests/test_stepcache.py``), and an interrupted range does not touch
the next. With the stand-in capture backend, deep and plain evaluations
get separate graphs, and a new cadence or cutoff captures none.
"""

import functools

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

import quality
from stable_diffusion_webui_distributed_tpu.models import controlnet as jcn
from stable_diffusion_webui_distributed_tpu.models.configs import TINY as JTINY
from stable_diffusion_webui_distributed_tpu.models.configs import (
    TINY_XL as JTINY_XL,
)
from stable_diffusion_webui_distributed_tpu.models.unet import UNet as JaxUNet
from stable_diffusion_webui_distributed_tpu.models.unet import (
    deep_cache_shape as jax_deep_cache_shape,
)
from stable_diffusion_webui_distributed_tpu.pipeline import (
    stepcache as jstepcache,
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
from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
    TINY,
    TINY_XL,
)
from stable_diffusion_webui_distributed_tpu_torch.models.unet import (
    deep_cache_shape,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline import stepcache
from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import Engine
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
    array_to_b64png,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import graphs
from stable_diffusion_webui_distributed_tpu_torch.runtime.interrupt import (
    GenerationState,
)
from stable_diffusion_webui_distributed_tpu_torch.samplers import (
    kdiffusion as kd,
)
from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
    METRICS,
)
from test_adapters import make_ldm_controlnet
from test_torch_quant import (
    PIXELS,
    jax_apply,
    pixel_gap,
    seeded_params,
    unet_inputs,
    unet_pair,
)
from test_torch_warmup import Stub

PSNR_FLOOR_DB = 20.0
SSIM_FLOOR = 0.5
CN = "cn-test"


# -- the bookkeeping ---------------------------------------------------------

CADENCES = st.one_of(st.integers(-3, 20), st.sampled_from(
    ["3", "x", None, 2.7, "", [2]]))


@settings(max_examples=200, deadline=None)
@given(cadence=CADENCES)
def test_bucket_cadence_matches_jax(cadence):
    assert stepcache.bucket_cadence(cadence) == \
        jstepcache.bucket_cadence(cadence)
    assert stepcache.CADENCE_LADDER == jstepcache.CADENCE_LADDER


@pytest.mark.parametrize("env,override", [
    ({}, {}), ({"SDTPU_DEEPCACHE": "5"}, {}),
    ({"SDTPU_DEEPCACHE": "4", "SDTPU_CFG_CUTOFF": "1.5"}, {"deepcache": 2}),
    ({"SDTPU_CFG_CUTOFF": "junk"}, {"cfg_cutoff": "3.25"}),
    ({}, {"deepcache": "many", "cfg_cutoff": "none"}),
    ({"SDTPU_DEEPCACHE": "3"}, {"cfg_cutoff": -2.0}),
])
def test_resolve_matches_jax(monkeypatch, env, override):
    for name in ("SDTPU_DEEPCACHE", "SDTPU_CFG_CUTOFF"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    got = stepcache.resolve(GenerationPayload(override_settings=override))
    want = jstepcache.resolve(JaxPayload(override_settings=override))
    assert (got.cadence, got.cutoff_sigma, got.active) == \
        (want.cadence, want.cutoff_sigma, want.active)


@settings(max_examples=150, deadline=None)
@given(steps=st.integers(1, 40), cutoff=st.floats(-1.0, 20.0),
       sampler=st.sampled_from(["Euler a", "DPM++ 2M Karras", "DDIM",
                                "Heun"]))
def test_cutoff_step_matches_jax(steps, cutoff, sampler):
    sigmas = kd.build_sigmas(kd.resolve_sampler(sampler), _schedule(),
                             steps).numpy()
    assert stepcache.cutoff_step(sigmas, cutoff) == \
        jstepcache.cutoff_step(sigmas, cutoff)


@functools.lru_cache(maxsize=None)
def _schedule():
    from stable_diffusion_webui_distributed_tpu_torch.samplers import (
        schedules,
    )
    return schedules.sd_schedule()


CHUNKS = st.lists(st.tuples(st.integers(1, 5), st.booleans()), min_size=1,
                  max_size=6)


@settings(max_examples=200, deadline=None)
@given(chunks=CHUNKS, cadence=st.integers(1, 8), stop=st.integers(0, 30),
       evals=st.sampled_from([1, 2]), start=st.integers(0, 3))
def test_plan_schedule_and_prefix_boundary_match_jax(chunks, cadence, stop,
                                                     evals, start):
    spans, pos = [], start
    for length, cached in chunks:
        spans.append((pos, length, cached))
        pos += length
    assert stepcache.plan_schedule(spans, cadence, stop, evals, pos) == \
        jstepcache.plan_schedule(spans, cadence, stop, evals, pos)
    for p in range(pos + 2):
        for floor in (0, 2):
            assert stepcache.prefix_boundary(p, cadence, stop, floor) == \
                jstepcache.prefix_boundary(p, cadence, stop, floor)


# -- the UNet's cache modes ----------------------------------------------------

@pytest.fixture(scope="module")
def tiny_params():
    return {"tiny": seeded_params(JTINY, TINY),
            "tiny-xl": seeded_params(JTINY_XL, TINY_XL)}


@pytest.mark.parametrize("family", ["tiny", "tiny-xl"])
def test_deep_and_reuse_match_jax(tiny_params, family):
    jfam, params, unet = unet_pair(tiny_params, family)
    x, t, ctx, added = unet_inputs(jfam)
    jargs = [jnp.asarray(a) for a in (x, t, ctx)]
    targs = [torch.from_numpy(a) for a in (x, t, ctx)]
    kw = {}
    if added is not None:
        jargs.append(jnp.asarray(added))
        kw["added_cond"] = torch.from_numpy(added)
    ju = JaxUNet(jfam.unet)
    jdeep = jax_apply(ju, params["unet"], *jargs, cache_mode="deep")
    jreuse = jax_apply(ju, params["unet"], *jargs, cache=jnp.asarray(jdeep),
                       cache_mode="reuse")
    jplain = jax_apply(ju, params["unet"], *jargs)
    assert deep_cache_shape(jfam.unet, 2, 16, 16) == \
        jax_deep_cache_shape(jfam.unet, 2, 16, 16) == jdeep.shape
    with torch.no_grad():
        deep = unet(*targs, **kw, cache_mode="deep")
        reuse_of_jax = unet(*targs, **kw,
                            cache=torch.from_numpy(jdeep.copy()),
                            cache_mode="reuse").numpy()
        reuse = unet(*targs, **kw, cache=deep, cache_mode="reuse").numpy()
        plain = unet(*targs, **kw).numpy()
    np.testing.assert_allclose(deep.numpy(), jdeep, rtol=0, atol=1e-4)
    np.testing.assert_allclose(reuse_of_jax, jreuse, rtol=0, atol=2e-5)
    # deep then reuse is the plain call, in both packages
    assert np.array_equal(jreuse, jplain)
    assert np.array_equal(reuse, plain)
    with pytest.raises(ValueError, match="cached feature"):
        unet(*targs, **kw, cache_mode="reuse")


# -- whole engines ---------------------------------------------------------------

def _pattern(h, w):
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([(x * 9) % 256, (y * 7) % 256, ((x + y) * 4) % 256], -1)
    return img.astype(np.uint8)


_mask = np.zeros((32, 32, 3), np.uint8)
_mask[16:] = 255
BASE = dict(prompt="a cow", negative_prompt="blurry", steps=8, width=32,
            height=32, batch_size=2, seed=42)
REQUESTS = {
    "euler-a-c3-cutoff": dict(BASE, override_settings={
        "deepcache": 3, "cfg_cutoff": 2.0}),
    "heun-c2-cutoff": dict(BASE, sampler_name="Heun", steps=6,
                           override_settings={"deepcache": 2,
                                              "cfg_cutoff": 1.0}),
    "inpaint-c3": dict(BASE, init_images=[array_to_b64png(_pattern(32, 32))],
                       mask=array_to_b64png(_mask), mask_blur=2,
                       denoising_strength=0.9, batch_size=1,
                       override_settings={"deepcache": 3}),
    # the unit's window is the first chunk: it runs plain, the second
    # chunk refreshes on entry
    "controlnet-window-c3": dict(BASE, batch_size=1, alwayson_scripts={
        "controlnet": {"args": [{
            "enabled": True, "image": array_to_b64png(_pattern(48, 48)),
            "module": "none", "model": CN, "weight": 0.8,
            "guidance_start": 0.0, "guidance_end": 0.4}]}},
        override_settings={"deepcache": 3}),
}


@pytest.fixture(scope="module")
def cn_tree():
    return jax.device_get(jcn.convert_controlnet(
        make_ldm_controlnet(JTINY.unet), JTINY.unet))


@pytest.fixture(scope="module")
def engines(tiny_params, cn_tree):
    params = tiny_params["tiny"]
    sd = bridge.controlnet_flax_to_torch(cn_tree)
    return (JaxEngine(JTINY, params, chunk_size=4, state=JaxState(),
                      controlnet_provider=lambda n: cn_tree if n == CN
                      else None),
            Engine(TINY, bridge.flax_to_torch(TINY, params), chunk_size=4,
                   state=GenerationState(), device="cpu",
                   controlnet_provider=lambda n: sd if n == CN else None))


def run_both(engines, body):
    jax_e, port_e = engines
    call = "img2img" if body.get("init_images") else "txt2img"
    want = getattr(jax_e, call)(JaxPayload(**body))
    got = getattr(port_e, call)(GenerationPayload(**body))
    return got, want


def expected_evals(body, chunk_size=4):
    """``plan_schedule`` over the chunks the engine runs: a chunk with a
    unit active in it runs plain."""
    p = GenerationPayload(**body)
    spec = kd.resolve_sampler(p.sampler_name)
    sc = stepcache.resolve(p)
    steps = p.steps
    start = steps - int(min(p.denoising_strength, 0.999) * steps) \
        if p.init_images else 0
    units = (p.alwayson_scripts or {}).get("controlnet", {}).get("args", [])
    chunks = []
    for pos in range(start, steps, chunk_size):
        end = min(pos + chunk_size, steps)
        lo, hi = (pos + 0.5) / steps, (end - 0.5) / steps
        active = any(u["guidance_start"] <= hi and u["guidance_end"] >= lo
                     for u in units)
        chunks.append((pos, end - pos, not active))
    stop = stepcache.cutoff_step(
        kd.build_sigmas(spec, _schedule(), steps).numpy(), sc.cutoff_sigma)
    return stepcache.plan_schedule(chunks, sc.cadence, stop,
                                   spec.evals_per_step, steps)


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_engine_matches_jax_and_counts_its_schedule(engines, name):
    body = REQUESTS[name]
    got, want = run_both(engines, body)
    assert got.seeds == want.seeds and got.infotexts == want.infotexts
    worst, _ = pixel_gap(got.images, want.images)
    assert worst <= 1, worst
    evals = engines[1].last_step_evals
    assert evals == expected_evals(body)
    assert evals["refreshes"] > 0 and (
        evals["reuse_trunc_evals"] > 0) == ("cutoff" in name)
    if "controlnet" in name:
        assert evals["full_evals"] == 4


def test_sdxl_at_int8_and_cadence_3_matches_jax(tiny_params):
    params = tiny_params["tiny-xl"]
    jax_e = JaxEngine(JTINY_XL, params, chunk_size=4, state=JaxState())
    port_e = Engine(TINY_XL, bridge.flax_to_torch(TINY_XL, params),
                    chunk_size=4, state=GenerationState(), device="cpu")
    body = dict(BASE, precision="int8", override_settings={"deepcache": 3})
    want = jax_e.txt2img(JaxPayload(**body))
    got = port_e.txt2img(GenerationPayload(**body))
    assert got.seeds == want.seeds and got.infotexts == want.infotexts
    worst, mean = pixel_gap(got.images, want.images)
    assert worst <= PIXELS["int8"][0] and mean <= PIXELS["int8"][1]
    assert port_e.last_step_evals == expected_evals(body)


# -- the JAX package's rules, on the port -----------------------------------------

@pytest.fixture(scope="module")
def stub_engine(tiny_params):
    """A port engine whose graph cache runs the stand-in capture backend,
    and its plain run."""
    e = Engine(TINY, bridge.flax_to_torch(TINY, tiny_params["tiny"]),
               chunk_size=4, state=GenerationState(), device="cpu")
    e._graphs = graphs.GraphCache(capture=Stub())
    METRICS.clear()
    return e, e.txt2img(GenerationPayload(**BASE))


def test_inactive_cache_is_the_plain_path(stub_engine):
    engine, plain = stub_engine
    kinds = dict(METRICS.summary()["compiles"])
    assert kinds == {"unet": 1}
    again = engine.txt2img(GenerationPayload(
        **BASE, override_settings={"deepcache": 1, "cfg_cutoff": 0.0},
        precision="bf16"))
    assert again.images == plain.images
    assert engine.last_step_evals is None
    assert METRICS.summary()["compiles"] == kinds


def test_cadence_with_cutoff_keeps_the_floors(stub_engine):
    engine, plain = stub_engine
    r = engine.txt2img(GenerationPayload(
        **BASE, override_settings={"deepcache": 3, "cfg_cutoff": 2.0}))
    db = quality.mean_psnr(r.images, plain.images)
    assert PSNR_FLOOR_DB <= db < quality.IDENTICAL_DB, db
    assert quality.mean_ssim(r.images, plain.images) >= SSIM_FLOOR


def test_deep_and_plain_get_separate_graphs_and_knobs_capture_none(
        stub_engine):
    engine, _ = stub_engine
    engine.txt2img(GenerationPayload(
        **BASE, override_settings={"deepcache": 2, "cfg_cutoff": 2.0}))
    kinds = dict(METRICS.summary()["compiles"])
    # plain, and each kind of the cached path: deep and reuse, with CFG
    # and truncated
    assert kinds == {"unet": 1, "deep": 1, "deep-trunc": 1, "reuse": 1,
                     "reuse-trunc": 1}
    n = len(engine._graphs)
    for ov in ({"deepcache": 3, "cfg_cutoff": 1.0},
               {"deepcache": 8, "cfg_cutoff": 5.0}, {"deepcache": 4}):
        engine.txt2img(GenerationPayload(**BASE, override_settings=ov))
    assert METRICS.summary()["compiles"] == kinds
    assert len(engine._graphs) == n


def test_interrupt_then_rerun_matches(tiny_params):
    """A range starts with an invalid cache: an interrupted cached run
    leaves nothing for the next (JAX ``test_stepcache.py``)."""
    state = GenerationState()
    engine = Engine(TINY, bridge.flax_to_torch(TINY, tiny_params["tiny"]),
                    chunk_size=2, state=state, device="cpu")
    ov = {"deepcache": 8, "cfg_cutoff": 0.0}  # one refresh per range
    ref = engine.txt2img(GenerationPayload(**BASE, override_settings=ov))
    armed = {"on": True}
    state.add_listener(
        lambda prog: state.flag.interrupt() if armed["on"] else None)
    partial = engine.txt2img(GenerationPayload(**BASE, override_settings=ov))
    assert len(partial.images) == 2
    assert state.progress.sampling_step < 8
    armed["on"] = False
    again = engine.txt2img(GenerationPayload(**BASE, override_settings=ov))
    assert again.images == ref.images

