"""The port's scenario runners (``sim/scenarios.py``) on a TINY engine
through its dispatcher, on the CPU.

- steady and flash burst at 64x64, 4 steps (bucket 64x64, batch 2), over
  a two-request recorded mix (6 and 8 requests): every
  request is scored, every scorecard key is there, no image is merged
  twice, the burst scores its SLO rows and burn into
  ``sdtpu_sim_slo_burn``, the last run is recorded for ``/internal/sim``,
  and each image is within 2 uint8 levels of the JAX engine's image of
  its seed through the JAX dispatcher (``chip_smoke.py``'s batch-row
  agreement);
- the capacity sweep at 32x32, 2 steps, over a two-request mix: all three
  candidates ranked, every image delivered once, and the solo candidate
  coalesces nothing.
"""

import os

import numpy as np
import pytest

import jax

from stable_diffusion_webui_distributed_tpu.models.configs import TINY as JTINY
from stable_diffusion_webui_distributed_tpu.obs import journal as jax_journal
from stable_diffusion_webui_distributed_tpu.pipeline.engine import (
    Engine as JaxEngine,
)
from stable_diffusion_webui_distributed_tpu.pipeline.payload import (
    GenerationPayload as JaxPayload,
)
from stable_diffusion_webui_distributed_tpu.pipeline.payload import (
    b64png_to_array as jax_b64png_to_array,
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
from stable_diffusion_webui_distributed_tpu.sim import score as jax_score
from stable_diffusion_webui_distributed_tpu_torch import bridge, sim
from stable_diffusion_webui_distributed_tpu_torch.models.configs import TINY
from stable_diffusion_webui_distributed_tpu_torch.obs import journal
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    prometheus as obs_prom,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import Engine
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    b64png_to_array,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.interrupt import (
    GenerationState,
)
from stable_diffusion_webui_distributed_tpu_torch.serving.bucketer import (
    ShapeBucketer,
)
from stable_diffusion_webui_distributed_tpu_torch.serving.dispatcher import (
    ServingDispatcher,
)
from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
    METRICS,
)
from stable_diffusion_webui_distributed_tpu_torch.sim import scenarios
from test_pipeline import init_params

SIZE, STEPS, SLO_S = 64, 4, 10.0


@pytest.fixture()
def sim_env(monkeypatch):
    for k in ("SDTPU_SIM", "SDTPU_JOURNAL", "SDTPU_PERF"):
        monkeypatch.setenv(k, "1")
    journal.JOURNAL.clear()
    jax_journal.JOURNAL.clear()
    obs_prom.clear_histograms()
    yield
    journal.JOURNAL.clear()
    jax_journal.JOURNAL.clear()
    obs_prom.clear_histograms()
    sim.clear_last_run()


@pytest.fixture(scope="module")
def params():
    """TINY's parameter tree filled from a seeded numpy stream (a traced
    shape costs a second where compiling ``init_params`` costs twenty)."""
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda: init_params(JTINY))
    return jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.05).astype(s.dtype),
        shapes)


@pytest.fixture(scope="module")
def jax_images(params):
    """The JAX engine's image of each recorded seed, through its
    dispatcher at the scenarios' bucket (one batch-2 compile)."""
    engine = JaxEngine(JTINY, params, chunk_size=2, state=JaxState())
    disp = JaxDispatcher(engine, bucketer=JaxBucketer(
        shapes=[(SIZE, SIZE)], batches=[2]), window=0.0)
    out = {}
    for i in range(2):
        r = disp.submit(JaxPayload(
            prompt=f"scenario base mix {i}",
            negative_prompt="blurry, low quality", steps=STEPS,
            width=SIZE, height=SIZE, seed=400 + i, sampler_name="Euler a"))
        out[400 + i] = jax_b64png_to_array(r.images[0])
    return out


@pytest.fixture(scope="module")
def engine(params):
    return Engine(TINY, bridge.flax_to_torch(TINY, params), chunk_size=2,
                  state=GenerationState(), device="cpu")


def _check_images(capture, plan_seeds, jax_images):
    for rid, result in capture["results"].items():
        if not result.images:
            continue
        px = b64png_to_array(result.images[0])
        ref = jax_images[plan_seeds[rid]]
        diff = np.abs(px.astype(np.int32) - ref.astype(np.int32))
        assert diff.mean() <= 2.0, (rid, diff.mean())


def test_steady_and_burst_on_tiny(sim_env, engine, jax_images):
    bucketer = ShapeBucketer(shapes=[(SIZE, SIZE)], batches=[2])
    recorder = ServingDispatcher(engine, bucketer=bucketer, window=0.0)
    rec = {}
    mix = scenarios.record_mix(recorder, SIZE, STEPS, n=2, capture=rec)
    assert [p["seed"] for p, _ in mix] == [400, 401]
    assert [p["request_id"] for p, _ in mix] == ["record-000", "record-001"]
    assert mix[0][1] == 0.0 and mix[1][1] > 0.0
    _check_images(rec, {"record-000": 400, "record-001": 401}, jax_images)
    keys = set(jax_score.score_run([]))
    fleet_env = os.environ.get("SDTPU_FLEET")
    for name, run in (("steady", scenarios.steady),
                      ("flash_burst", scenarios.flash_burst)):
        METRICS.clear()
        cap = {}
        card = run(engine, bucketer, mix, 0, SLO_S, capture=cap)
        assert keys <= set(card)
        statuses = {row["completed"] + row["failed"] + row["throttled"]
                    == row["requests"] for row in card["classes"].values()}
        assert statuses == {True}
        assert card["double_merged_images"] == 0
        assert sim.last_run()["name"] == name
        seeds = {e["request_id"]: e["attrs"]["payload"]["seed"]
                 for e in cap["events"] if e["event"] == "received"}
        _check_images(cap, seeds, jax_images)
        if name == "steady":
            assert card["requests"] == 6
            assert card["delivered_images"] == card["expected_images"] == 6
            assert METRICS.summary()["dispatches"] >= 3
        else:
            assert card["requests"] == 8
            assert set(card["classes"]) <= {"interactive", "batch"}
            assert card["slo"] and card["worst_slo_burn"] is not None
            assert obs_prom.sim_slo_burn() == card["worst_slo_burn"]
    assert sim.summary()["last_run"]["name"] == "flash_burst"
    assert os.environ.get("SDTPU_FLEET") == fleet_env


def test_sweep_on_tiny(sim_env, engine):
    size = 32
    bucketer = ShapeBucketer(shapes=[(size, size)], batches=[2])
    recorder = ServingDispatcher(engine, bucketer=bucketer, window=0.0)
    mix = scenarios.record_mix(recorder, size, 2, n=2)
    cap = {}
    out = scenarios.sweep(engine, mix, 0, size, SLO_S, capture=cap)
    assert sorted(r["name"] for r in out["ranked"]) == sorted(
        scenarios.SWEEP_CONFIGS)
    assert [r["rank"] for r in out["ranked"]] == [1, 2, 3]
    assert out["recommendation"] == out["ranked"][0]["name"]
    for name, card in out["runs"].items():
        assert card["requests"] == 4
        assert card["delivered_images"] == card["expected_images"] == 4
        assert card["double_merged_images"] == 0
        assert len(cap[name]["results"]) == 4
    groups = scenarios.coalesced(cap["solo_b1"]["events"])
    assert groups == {}
