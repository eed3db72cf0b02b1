"""SDXL under ragged dispatch in the port against the JAX package, on the
CPU.

TINY_XL carries the JAX package's Flax weights across. In f32:

- a ragged solo request (the engine's ragged path, a 32x32 bucket holding
  32x24 images) gives the JAX engine's seeds and infotext and pixels
  within 1 uint8 level;
- two requests of two heights sent together to the port's server
  (``SDTPU_RAGGED=1``, a 32x32 ladder) run as one dispatch, answer 200 at
  their sizes, and give the JAX dispatcher's seeds, infotext and pixels
  within 1 level;
- the added conditioning's time ids are the bucket's size in both
  packages, not the request's true size (the bucketer wrote the bucket
  into the payload), compared exactly;
- a group of three requests on a batch ladder of 4 builds the JAX
  dispatcher's inputs: each member's pooled row and the pad-and-drop row
  (the last member's again), and the three length vectors, exactly.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax

from stable_diffusion_webui_distributed_tpu.models.configs import (
    TINY_XL as JTINY_XL,
)
from stable_diffusion_webui_distributed_tpu.pipeline import (
    engine as jax_engine_mod,
)
from stable_diffusion_webui_distributed_tpu.pipeline.payload import (
    GenerationPayload as JaxPayload,
)
from stable_diffusion_webui_distributed_tpu.runtime.interrupt import (
    GenerationState as JaxState,
)
from stable_diffusion_webui_distributed_tpu.serving import (
    dispatcher as jax_dispatcher_mod,
)
from stable_diffusion_webui_distributed_tpu.serving.bucketer import (
    ShapeBucketer as JaxBucketer,
)
from stable_diffusion_webui_distributed_tpu.serving.metrics import (
    METRICS as JAX_METRICS,
)
from stable_diffusion_webui_distributed_tpu_torch import bridge
from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
    TINY_XL,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline import (
    engine as engine_mod,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
    b64png_to_array,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.interrupt import (
    GenerationState,
)
from stable_diffusion_webui_distributed_tpu_torch.server.api import ApiServer
from stable_diffusion_webui_distributed_tpu_torch.serving import (
    dispatcher as dispatcher_mod,
)
from stable_diffusion_webui_distributed_tpu_torch.serving.bucketer import (
    ShapeBucketer,
)
from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
    METRICS,
)
from test_pipeline import init_params

BUCKET = (32, 32)
#: the base model's six time ids at the bucket: original size, crop, target
BUCKET_IDS = [32.0, 32.0, 0.0, 0.0, 32.0, 32.0]
BASE = dict(negative_prompt="blurry", steps=4, width=32, cfg_scale=5.0,
            sampler_name="Euler a")
SOLO = dict(BASE, prompt="a (red:1.2) cow", height=32, batch_size=2,
            seed=9, override_settings={"ragged_true_wh": [32, 24]})
# the two requests of the server case: two heights, two prompts (so the
# members' pooled rows differ), each its own seed
GROUP = [dict(BASE, prompt="a red cow", height=24, seed=30),
         dict(BASE, prompt="a (blue:1.4) horse", height=32, seed=31)]


def pixels(b64):
    return b64png_to_array(b64).astype(np.int32)


@pytest.fixture(scope="module")
def params():
    return jax.device_get(jax.jit(init_params, static_argnums=0)(JTINY_XL))


@pytest.fixture(scope="module")
def engines(params):
    port = engine_mod.Engine(TINY_XL, bridge.flax_to_torch(TINY_XL, params),
                             chunk_size=4, state=GenerationState(),
                             device="cpu")
    ref = jax_engine_mod.Engine(JTINY_XL, params, chunk_size=4,
                                state=JaxState())
    return port, ref


def time_ids_spy(mp, module, to_numpy):
    """Record the time ids every ``make_added_cond`` call of ``module``'s
    engine gets, as numpy arrays."""
    seen = []
    real = module.make_added_cond

    def spy(pooled, time_ids, dim):
        seen.append(to_numpy(time_ids))
        return real(pooled, time_ids, dim)

    mp.setattr(module, "make_added_cond", spy)
    return seen


def spies(mp):
    return (time_ids_spy(mp, engine_mod, lambda t: t.numpy().copy()),
            time_ids_spy(mp, jax_engine_mod, np.asarray))


@pytest.fixture(scope="module")
def solo_runs(engines):
    port, ref = engines
    with pytest.MonkeyPatch.context() as mp:
        port_ids, jax_ids = spies(mp)
        latents = []
        decode = port._decode_u8

        def keep(lat, width, height):
            latents.append(lat.clone())
            return decode(lat, width, height)

        mp.setattr(port, "_decode_u8", keep)
        got = port.generate_range(GenerationPayload(**SOLO))
        want = ref.generate_range(JaxPayload(**SOLO))
    return got, want, port_ids, jax_ids, latents


def test_ragged_solo_matches_jax(solo_runs):
    got, want, _, _, (lat,) = solo_runs
    # the ragged path ran: the latent rows past the true 24 pixels are 0
    assert lat.shape == (2, 16, 16, 4)
    assert torch.all(lat[:, 12:] == 0) and lat[:, :12].std() > 0.1
    assert got.seeds == want.seeds == [9, 10]
    assert got.infotexts == want.infotexts
    for a, b in zip(got.images, want.images):
        pa, pb = pixels(a), pixels(b)
        assert pa.shape == pb.shape == (32, 32, 3)
        assert np.abs(pa - pb).max() <= 1


def test_ragged_solo_time_ids_are_the_bucket(solo_runs):
    _, _, port_ids, jax_ids = solo_runs[:4]
    assert len(port_ids) == len(jax_ids) == 2  # uncond and cond rows
    for a, b in zip(port_ids, jax_ids):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, [BUCKET_IDS] * len(a))


@pytest.fixture(scope="module")
def group_runs(engines):
    """The two requests sent together to the port's server and to the JAX
    dispatcher, with each package's dispatch counts and time ids."""
    port, ref = engines
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SDTPU_RAGGED", "1")
        mp.setenv("SDTPU_BUCKET_LADDER", "32x32")
        mp.setenv("SDTPU_BATCH_LADDER", "1,2")
        mp.setenv("SDTPU_COALESCE_WINDOW", "0.5")
        port_ids, jax_ids = spies(mp)
        server = ApiServer(port, port=0).start()
        try:
            METRICS.clear()
            got = concurrently(lambda body: post(server.port, body), GROUP)
            port_metrics = METRICS.summary()
        finally:
            server.stop()
        disp = jax_dispatcher_mod.ServingDispatcher(
            ref, bucketer=JaxBucketer(shapes=[BUCKET], batches=[1, 2]),
            window=0.5)
        JAX_METRICS.clear()
        want = concurrently(lambda body: disp.submit(JaxPayload(**body)),
                            GROUP)
        jax_metrics = JAX_METRICS.summary()
    return got, port_metrics, want, jax_metrics, port_ids, jax_ids


def post(port: int, body: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/sdapi/v1/txt2img",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        assert resp.status == 200
        return json.loads(resp.read())


def concurrently(fn, bodies):
    results, errors = [None] * len(bodies), []

    def run(i):
        try:
            results[i] = fn(bodies[i])
        except Exception as e:  # noqa: BLE001 — surfaced by the assert
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        assert not t.is_alive()
    assert not errors, errors
    return results


def test_server_runs_ragged_sdxl_as_one_dispatch(group_runs):
    got, port_metrics, _, jax_metrics = group_runs[:4]
    for s in (port_metrics, jax_metrics):
        assert (s["dispatches"], s["coalesced_dispatches"]) == (1, 1)
    assert port_metrics["coalesced_requests"] == 2
    for resp, body in zip(got, GROUP):
        info = json.loads(resp["info"])
        assert info["all_seeds"] == [body["seed"]]
        assert f"Size: 32x{body['height']}" in info["infotexts"][0]
        assert pixels(resp["images"][0]).shape == (body["height"], 32, 3)


def test_ragged_group_matches_jax(group_runs):
    got, _, want = group_runs[:3]
    for resp, w in zip(got, want):
        info = json.loads(resp["info"])
        assert info["all_seeds"] == w.seeds
        assert info["infotexts"] == w.infotexts
        pg, pw = pixels(resp["images"][0]), pixels(w.images[0])
        assert pg.shape == pw.shape
        assert np.abs(pg - pw).max() <= 1


def test_ragged_group_time_ids_are_the_bucket(group_runs):
    port_ids, jax_ids = group_runs[4:]
    assert len(port_ids) == len(jax_ids) == 2
    for a, b in zip(port_ids, jax_ids):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, [BUCKET_IDS] * len(a))


def test_group_inputs_pad_and_drop_match_jax(engines, monkeypatch):
    """Three requests (heights 16, 24, 32; 2 and 1 context chunks) on a
    batch ladder of 4: the fourth row repeats the last member's pooled
    row, true rows and context lengths, in both packages."""
    monkeypatch.setenv("SDTPU_RAGGED", "1")
    bodies = [dict(BASE, prompt=" ".join(["tall cow"] * 40), height=16,
                   seed=40),
              dict(BASE, prompt="a red cow", height=24, seed=41),
              dict(BASE, prompt="a (blue:1.4) horse", height=32, seed=42)]
    for i, body in enumerate(bodies):
        body["subseed"] = 50 + i  # what submit's fix_seed would draw
    built = []
    for mod, make, eng, bucketer in (
            (dispatcher_mod, GenerationPayload, engines[0], ShapeBucketer),
            (jax_dispatcher_mod, JaxPayload, engines[1], JaxBucketer)):
        disp = mod.ServingDispatcher(
            eng, bucketer=bucketer(shapes=[BUCKET], batches=[1, 2, 4]),
            window=0.0)
        runs = [disp.bucketer.bucket_payload(make(**b), ragged=True)[0]
                for b in bodies]
        group = mod._Group(disp._group_key(runs[0]))
        group.tickets = [mod.Ticket(make(**b), run, "txt2img", True, str(i))
                         for i, (b, run) in enumerate(zip(bodies, runs))]
        built.append(disp._group_build_inputs(group))
    got, want = built
    assert got["b_raw"] == want["b_raw"] == 3
    pooled = got["pooled"][1].numpy()
    assert pooled.shape[0] == 4
    np.testing.assert_array_equal(pooled[3], pooled[2])
    assert not np.array_equal(pooled[0], pooled[1])
    np.testing.assert_allclose(pooled, np.asarray(want["pooled"][1]),
                               rtol=2e-5, atol=2e-5)
    for a, b in zip(got["ragged"], want["ragged"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rows, ctx_u, ctx_c = (v.tolist() for v in got["ragged"])
    assert rows == [8, 12, 16, 16]
    assert ctx_u == [77] * 4
    assert ctx_c == [154, 77, 77, 77]
    torch.testing.assert_close(got["x"][3], got["x"][2])
