"""The port's serving dispatcher against the JAX package's, on TINY on the
CPU.

Three concurrent requests of three heights, (64,64), (64,48) and (48,32),
on one 64x64 ragged bucket (``SDTPU_RAGGED=1``) coalesce into ONE dispatch
in both packages. Each image comes back cropped to its requested size with
``Size: WxH`` in its infotext, and matches the JAX dispatcher's image of the
same request within 1 uint8 level (the two sum in different orders), with
equal seeds and infotext. Inside the port, each coalesced image equals the
same request run alone through the dispatcher within 1 uint8 level, with
equal seeds and infotext. The JAX package holds that pair byte-identical on
the CPU; torch's CPU convolutions and matrix products block their sums by
batch size, so a row's last bits depend on the batch it ran in (measured:
at most 1 level, on under 0.1% of the pixels). Both packages get explicit
small ladders; the default would pad TINY up to 512x512.

A non-ragged group pads its batch up the batch ladder and drops the extra
rows (pad-and-drop); a cancelled member gets an empty result and leaves the
others untouched; the server answers through the dispatcher and still
answers 422 for what the port does not run.
"""

import json
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax

from stable_diffusion_webui_distributed_tpu.models.configs import TINY as JTINY
from stable_diffusion_webui_distributed_tpu.pipeline.engine import (
    Engine as JaxEngine,
)
from stable_diffusion_webui_distributed_tpu.pipeline.payload import (
    GenerationPayload as JaxPayload,
)
from stable_diffusion_webui_distributed_tpu.runtime.interrupt import (
    GenerationState as JaxState,
)
from stable_diffusion_webui_distributed_tpu.serving.bucketer import (
    ShapeBucketer as JaxBucketer,
)
from stable_diffusion_webui_distributed_tpu.serving.dispatcher import (
    ServingDispatcher as JaxDispatcher,
)
from stable_diffusion_webui_distributed_tpu.serving.metrics import (
    METRICS as JAX_METRICS,
)
from stable_diffusion_webui_distributed_tpu_torch import bridge
from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
    TINY,
    TINY_INPAINT,
)
from stable_diffusion_webui_distributed_tpu_torch.ops import (
    flash_attention as fa,
)
from stable_diffusion_webui_distributed_tpu_torch.ops import (
    ragged_attention as ra,
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

SHAPES = [(64, 64), (64, 48), (48, 32)]


def bodies():
    # the first prompt runs past 75 tokens, so the rows' context lengths
    # differ (154 against 77)
    prompts = [" ".join(["tall cow"] * 40), "ragged cow 1", "ragged cow 2"]
    return [dict(prompt=p, negative_prompt="blurry", steps=4, width=w,
                 height=h, seed=200 + i, subseed=9 + i,
                 sampler_name="Euler a")
            for i, (p, (w, h)) in enumerate(zip(prompts, SHAPES))]


def concurrently(submit, payloads):
    results, errors = [None] * len(payloads), []

    def run(i, p):
        try:
            results[i] = submit(p)
        except Exception as e:  # noqa: BLE001 — surfaced by the assert
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i, p))
               for i, p in enumerate(payloads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        assert not t.is_alive()
    assert not errors, errors
    return results


def pixels(b64):
    return b64png_to_array(b64).astype(np.int32)


@pytest.fixture(scope="module")
def params():
    return jax.device_get(jax.jit(init_params, static_argnums=0)(JTINY))


@pytest.fixture(scope="module")
def engine(params):
    return Engine(TINY, bridge.flax_to_torch(TINY, params), chunk_size=4,
                  state=GenerationState(), device="cpu")


@pytest.fixture(scope="module")
def ragged_runs(params, engine):
    """The three requests coalesced in the port and in the JAX package,
    with each package's dispatch metrics and the port's kernel launches
    during its run."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SDTPU_RAGGED", "1")
        port = ServingDispatcher(
            engine, bucketer=ShapeBucketer(shapes=[(64, 64)],
                                           batches=[1, 2, 4]), window=0.6)
        METRICS.clear()
        before = fa.flash_attention.launches + ra.ragged_attention.launches
        got = concurrently(port.submit,
                           [GenerationPayload(**b) for b in bodies()])
        port_metrics = METRICS.summary()
        launches = (fa.flash_attention.launches
                    + ra.ragged_attention.launches - before)
        jax_engine = JaxEngine(JTINY, params, chunk_size=4,
                               state=JaxState())
        ref = JaxDispatcher(
            jax_engine, bucketer=JaxBucketer(shapes=[(64, 64)],
                                             batches=[1, 2, 4]), window=0.6)
        JAX_METRICS.clear()
        want = concurrently(ref.submit,
                            [JaxPayload(**b) for b in bodies()])
        jax_metrics = JAX_METRICS.summary()
    return got, port_metrics, want, jax_metrics, launches


def test_mixed_heights_coalesce_into_one_dispatch(ragged_runs):
    _, port_metrics, _, jax_metrics, _ = ragged_runs
    for s in (port_metrics, jax_metrics):
        assert s["dispatches"] == 1
        assert s["coalesced_dispatches"] == 1
        assert s["requests"] == 3
    assert port_metrics["coalesced_requests"] == 3
    assert port_metrics["bucket_hits"] == 1  # 64x64 is the bucket itself
    assert port_metrics["bucket_misses"] == 2


def test_each_image_is_cropped_to_its_size(ragged_runs):
    got = ragged_runs[0]
    for r, (w, h) in zip(got, SHAPES):
        assert pixels(r.images[0]).shape == (h, w, 3)
        assert f"Size: {w}x{h}" in r.infotexts[0]
        assert pixels(r.images[0]).std() > 1.0


def test_ragged_group_matches_jax_dispatcher(ragged_runs):
    got, _, want, _, _ = ragged_runs
    for g, w in zip(got, want):
        assert g.seeds == w.seeds
        assert g.subseeds == w.subseeds
        assert g.infotexts == w.infotexts
        pg, pw = pixels(g.images[0]), pixels(w.images[0])
        assert pg.shape == pw.shape
        assert np.abs(pg - pw).max() <= 1


def test_ragged_group_equals_solo(engine, ragged_runs, monkeypatch):
    """Each coalesced image is the image of its request run alone (batch 1,
    still ragged at the 64x64 bucket) within 1 uint8 level: torch's CPU
    kernels give a row other last bits at another batch size."""
    monkeypatch.setenv("SDTPU_RAGGED", "1")
    solo = ServingDispatcher(
        engine, bucketer=ShapeBucketer(shapes=[(64, 64)], batches=[1, 2, 4]),
        window=0.0)
    for got, body in zip(ragged_runs[0], bodies()):
        want = solo.submit(GenerationPayload(**body))
        assert got.seeds == want.seeds
        assert got.infotexts == want.infotexts
        diff = np.abs(pixels(got.images[0]) - pixels(want.images[0]))
        assert diff.max() <= 1 and diff.mean() < 0.01


def test_non_ragged_group_pads_and_drops(engine, monkeypatch):
    """Two 32x32 requests coalesce; the batch of 2 runs at the ladder's 4
    (the last row repeated) and the two extra images are dropped. Each
    image equals its request run alone, within 1 uint8 level (another batch
    size), and carries its own seed and infotext."""
    monkeypatch.delenv("SDTPU_RAGGED", raising=False)
    disp = ServingDispatcher(
        engine, bucketer=ShapeBucketer(shapes=[(32, 32)], batches=[4]),
        window=0.5)
    batches = []
    denoise = engine._denoise

    def spy(payload, x, *args, **kwargs):
        batches.append((x.shape[0], kwargs.get("ragged")))
        return denoise(payload, x, *args, **kwargs)

    monkeypatch.setattr(engine, "_denoise", spy)
    payloads = [GenerationPayload(prompt=f"cow {i}", steps=3, width=32,
                                  height=32, seed=50 + i) for i in range(2)]
    METRICS.clear()
    got = concurrently(disp.submit, payloads)
    assert batches == [(4, None)]
    s = METRICS.summary()
    assert (s["dispatches"], s["coalesced_requests"]) == (1, 2)
    for r, p in zip(got, payloads):
        want = engine.generate_range(p)
        assert r.seeds == want.seeds == [p.seed]
        assert r.infotexts == want.infotexts
        assert len(r.images) == 1
        assert np.abs(pixels(r.images[0])
                      - pixels(want.images[0])).max() <= 1


def test_cancelled_member_gets_an_empty_result(engine, monkeypatch):
    monkeypatch.delenv("SDTPU_RAGGED", raising=False)
    disp = ServingDispatcher(
        engine, bucketer=ShapeBucketer(shapes=[(32, 32)], batches=[2]),
        window=0.5)
    payloads = [GenerationPayload(prompt="a cow", steps=2, width=32,
                                  height=32, seed=60 + i,
                                  request_id=f"req-{i}") for i in range(2)]
    results = [None, None]

    def run(i):
        results[i] = disp.submit(payloads[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 5
    while not disp.cancel("req-1"):
        assert time.monotonic() < deadline
        time.sleep(0.005)
    for t in threads:
        t.join(timeout=600)
        assert not t.is_alive()
    assert results[1].images == [] and results[1].parameters["cancelled"]
    assert len(results[0].images) == 1 and results[0].seeds == [60]
    assert not disp.cancel("req-1")  # finished tickets are forgotten


def call(port, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def test_server_answers_through_the_dispatcher(engine, monkeypatch):
    monkeypatch.delenv("SDTPU_RAGGED", raising=False)
    monkeypatch.setenv("SDTPU_BUCKET_LADDER", "32x32")
    server = ApiServer(engine, port=0).start()
    try:
        assert isinstance(server.dispatcher, ServingDispatcher)
        body = {"prompt": "a cow", "steps": 2, "width": 32, "height": 24,
                "seed": 9}
        METRICS.clear()
        status, resp = call(server.port, "/sdapi/v1/txt2img", body)
        assert status == 200
        assert METRICS.summary()["dispatches"] == 1
        assert pixels(resp["images"][0]).shape == (24, 32, 3)  # cropped
        assert "Size: 32x24" in json.loads(resp["info"])["infotexts"][0]
        # the cost levers are served, each dispatch labelled with its
        # resolved precision
        for extra in ({"override_settings": {"deepcache": 2}},
                      {"precision": "int8"}):
            status, resp = call(server.port, "/sdapi/v1/txt2img",
                                {**body, **extra})
            assert status == 200
            assert pixels(resp["images"][0]).shape == (24, 32, 3)
        assert METRICS.summary()["precision"] == {
            "bf16": {"dispatches": 2, "requests": 2},
            "int8": {"dispatches": 1, "requests": 1}}
        # per-image prompts run solo: one dispatch of one request
        before = METRICS.summary()
        status, resp = call(server.port, "/sdapi/v1/txt2img",
                            {**body, "all_prompts": ["a", "b"],
                             "batch_size": 2})
        assert status == 200 and len(resp["images"]) == 2
        assert json.loads(resp["info"])["all_prompts"] == ["a", "b"]
        after = METRICS.summary()
        assert after["dispatches"] == before["dispatches"] + 1
        assert after["coalesced_requests"] == \
            before["coalesced_requests"] + 1
        assert after["coalesced_dispatches"] == before["coalesced_dispatches"]
    finally:
        server.stop()


def test_merged_lora_request_runs_solo(engine, monkeypatch):
    """A request whose adapters are merged into the weights shares no
    batch (as in the JAX package); an unknown adapter is skipped, so its
    image is the tagless request's."""
    monkeypatch.delenv("SDTPU_RAGGED", raising=False)
    monkeypatch.delenv("SDTPU_LORA_TRACED", raising=False)
    disp = ServingDispatcher(
        engine, bucketer=ShapeBucketer(shapes=[(32, 32)], batches=[1, 2, 4]),
        window=0.3)
    payloads = [GenerationPayload(prompt=p, steps=2, width=32, height=32,
                                  seed=90)
                for p in ("a <lora:x:1> cow", "a cow")]
    assert [disp._coalescable(p) for p in payloads] == [False, True]
    METRICS.clear()
    got = concurrently(disp.submit, payloads)
    assert METRICS.summary()["dispatches"] == 2
    assert got[0].images == got[1].images
    assert "<lora:x:1>" in got[0].infotexts[0]


def test_adaptive_requests_run_solo(engine, monkeypatch):
    """DPM adaptive reads one error over its whole batch, so two
    concurrent adaptive requests run as two dispatches (as in the JAX
    package), each giving its own image as if run alone; a concurrent
    Euler a request still takes its own."""
    monkeypatch.delenv("SDTPU_RAGGED", raising=False)
    disp = ServingDispatcher(
        engine, bucketer=ShapeBucketer(shapes=[(32, 32)], batches=[1, 2, 4]),
        window=0.3)
    payloads = [GenerationPayload(prompt=f"cow {i}", steps=3, width=32,
                                  height=32, seed=70 + i,
                                  sampler_name=name)
                for i, name in enumerate(["DPM adaptive", "DPM adaptive",
                                          "Euler a"])]
    assert [disp._coalescable(p) for p in payloads] == [False, False, True]
    METRICS.clear()
    got = concurrently(disp.submit, payloads)
    assert METRICS.summary()["dispatches"] == 3
    for r, p in zip(got[:2], payloads):
        want = engine.generate_range(p)
        assert r.seeds == want.seeds == [p.seed]
        assert r.images == want.images
        assert r.infotexts == want.infotexts


def _unit_scripts():
    hint = np.zeros((64, 64, 3), np.uint8)
    hint[16:48, 16:48] = 255
    return {"controlnet": {"args": [{"enabled": True, "module": "canny",
                                     "image": array_to_b64png(hint),
                                     "model": "cn"}]}}


@pytest.mark.parametrize("kind", ["controlnet", "inpainting-family",
                                  "img2img"])
def test_controlnet_and_inpainting_work_bypass_coalescing(kind,
                                                          monkeypatch):
    """ControlNet units and an inpainting family's extra input channels
    ride no coalesced batch, and img2img bypasses the bucketer (as in the
    JAX package): two concurrent such requests run as two dispatches,
    each giving the image it gives alone."""
    monkeypatch.delenv("SDTPU_RAGGED", raising=False)
    family = TINY_INPAINT if kind == "inpainting-family" else TINY
    cn = bridge.init_seeded_controlnet(family, 1, device="cpu")
    engine = Engine(family, bridge.init_seeded(family, 0, device="cpu"),
                    chunk_size=4, state=GenerationState(), device="cpu",
                    controlnet_provider=lambda name: cn)
    disp = ServingDispatcher(
        engine, bucketer=ShapeBucketer(shapes=[(32, 32)], batches=[1, 2, 4]),
        window=0.3)
    extra = {"controlnet": {"alwayson_scripts": _unit_scripts()},
             "inpainting-family": {},
             "img2img": {"init_images": [_unit_scripts()["controlnet"]
                                         ["args"][0]["image"]]}}[kind]
    payloads = [GenerationPayload(prompt=f"cow {i}", steps=2, width=32,
                                  height=32, seed=80 + i, **extra)
                for i in range(2)]
    assert not any(disp._coalescable(p) for p in payloads)
    METRICS.clear()
    got = concurrently(disp.submit, payloads)
    summary = METRICS.summary()
    assert summary["dispatches"] == 2
    assert summary["bucket_bypasses"] == (2 if kind == "img2img" else 0)
    for r, p in zip(got, payloads):
        want = engine.generate_range(p)
        assert r.seeds == want.seeds == [p.seed]
        assert r.images == want.images


def test_serving_off_calls_the_engine_directly(engine, monkeypatch):
    monkeypatch.setenv("SDTPU_SERVING", "0")
    server = ApiServer(engine, port=0).start()
    try:
        assert server.dispatcher is None
        METRICS.clear()
        status, resp = call(server.port, "/sdapi/v1/txt2img",
                            {"prompt": "a cow", "steps": 2, "width": 32,
                             "height": 32, "seed": 9})
        assert status == 200 and len(resp["images"]) == 1
        assert METRICS.summary()["dispatches"] == 0
    finally:
        server.stop()


def test_cpu_dispatch_launches_no_kernel(ragged_runs):
    assert ragged_runs[-1] == 0


def test_many_concurrent_requests_each_get_their_own_images(engine,
                                                            monkeypatch):
    """More submitting threads than cores, a short switch interval: every
    request comes back with exactly its own seed and one image, no group
    exceeds the batch ladder, and the metrics count every request once."""
    monkeypatch.delenv("SDTPU_RAGGED", raising=False)
    disp = ServingDispatcher(
        engine, bucketer=ShapeBucketer(shapes=[(32, 32)], batches=[1, 2, 4]),
        window=0.05)
    sizes = []
    denoise = engine._denoise

    def spy(payload, x, *args, **kwargs):
        sizes.append(x.shape[0])
        return denoise(payload, x, *args, **kwargs)

    monkeypatch.setattr(engine, "_denoise", spy)
    payloads = [GenerationPayload(prompt="a cow", steps=1, width=32,
                                  height=32, seed=1000 + i, subseed=1)
                for i in range(12)]
    METRICS.clear()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        got = concurrently(disp.submit, payloads)
    finally:
        sys.setswitchinterval(interval)
    for r, p in zip(got, payloads):
        assert r.seeds == [p.seed] and len(r.images) == 1
    s = METRICS.summary()
    assert s["requests"] == s["coalesced_requests"] == 12
    assert s["dispatches"] == len(sizes) >= 3
    assert all(n <= 4 for n in sizes)
    assert not disp._groups and not disp._tickets
