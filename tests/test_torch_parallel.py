"""The port's engine on a mesh against the JAX package's and the port's own
meshless engine, on TINY on the CPU.

- **The engine, against JAX on the same mesh spec**: ``dp=4,tp=2`` at
  batch 4 (JAX ``tests/test_pipeline.py`` ``TestMeshEngine``; JAX on the
  conftest's eight virtual CPU devices, the port on a virtual mesh of
  eight ``cpu`` entries): within 1 uint8 level of the JAX package's images
  and of the port's meshless images, the tolerance of
  ``tests/test_torch_engine.py``. A JAX engine on a mesh compiles for some
  15 s here, so each file holds a share and stays under a minute alone:
  the odd batch 3 in ``tests/test_torch_parallel_odd.py``; ``sp=4``, the
  batch-major arguments, the registry and the CLI in
  ``tests/test_torch_parallel_rows.py``; the graphs and the tower in
  ``tests/test_torch_parallel_graphs.py``; the stage pipeline in
  ``tests/test_torch_stage_pipeline.py``;
- under ``tp=2`` the int8 precisions and traced LoRA are refused, and the
  fleet gate's admission never degrades a request to int8 there.

The weights are TINY's parameter trees filled from a seeded numpy stream
(shapes from ``jax.eval_shape``); both packages take the same trees.
"""

import numpy as np
import pytest

import jax

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
from stable_diffusion_webui_distributed_tpu_torch import bridge
from stable_diffusion_webui_distributed_tpu_torch.fleet.admission import (
    FleetRejected,
)
from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
    TINY,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import Engine
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
    Unsupported,
    array_to_b64png,
    b64png_to_array,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.interrupt import (
    GenerationState,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.mesh import (
    build_mesh,
)
from stable_diffusion_webui_distributed_tpu_torch.scheduler.eta import (
    EtaCalibration,
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
from test_pipeline import init_params
from test_torch_lora import make_adapter

CN, LORA = "mesh-cn", "mesh-lora"
BASE = dict(prompt="mesh cow", negative_prompt="blurry", steps=3, width=32,
            height=32, seed=21, sampler_name="Euler a")


def cpus(n):
    return ["cpu"] * n


def seeded(family, seed):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: init_params(family))
    return jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.05).astype(s.dtype),
        shapes)


def pixels(result):
    return np.stack([b64png_to_array(b).astype(np.int32)
                     for b in result.images])


def assert_within_one(got, want):
    assert got.seeds == want.seeds
    a, b = pixels(got), pixels(want)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 1


@pytest.fixture(autouse=True)
def gates_off(monkeypatch):
    for name in ("SDTPU_STAGE_GRAPH", "SDTPU_STAGE_DEPTH", "SDTPU_CACHE",
                 "SDTPU_RAGGED", "SDTPU_FLEET", "SDTPU_STAGE_CN_DEVICES",
                 "SDTPU_LORA_TRACED", "SDTPU_COORDINATOR"):
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def params():
    return seeded(JTINY, 0)


@pytest.fixture(scope="module")
def providers():
    cn = bridge.init_seeded_controlnet(TINY, 1, device="cpu")
    adapter = make_adapter(TINY, rank=4, seed=3)
    return dict(controlnet_provider=lambda n: cn if n == CN else None,
                lora_provider=lambda n: adapter if n == LORA else None)


def port_engine(params, providers, spec=None, devices=None):
    return Engine(TINY, bridge.flax_to_torch(TINY, params), chunk_size=3,
                  state=GenerationState(), **providers,
                  **({"device": "cpu"} if spec is None else
                     {"mesh": build_mesh(spec, devices or cpus(8))}))


@pytest.fixture(scope="module")
def plain(params, providers):
    return port_engine(params, providers)


def _hint():
    y, x = np.mgrid[0:32, 0:32]
    return array_to_b64png(np.stack([x * 8, y * 8, (x + y) * 4],
                                    axis=-1).astype(np.uint8))


# -- the engine against JAX on the same mesh -------------------------------------

#: the JAX package's mesh cases (JAX ``tests/test_pipeline.py``
#: ``TestMeshEngine``); each compiles a JAX engine for some 15 s on this
#: CPU, so the odd batch runs in ``tests/test_torch_parallel_odd.py`` and
#: ``sp=4`` in ``tests/test_torch_parallel_rows.py``
ENGINE_CASES = {"dp=4,tp=2 batch 4": ("dp=4,tp=2", 4),
                "odd batch 3 on dp=4,tp=2": ("dp=4,tp=2", 3),
                "sp=4 batch 2": ("sp=4", 2)}


def engine_case(case, plain, mesh_engines):
    """The port's images on the case's mesh against the JAX package's on
    the same mesh spec and the port's meshless ones."""
    spec, batch = ENGINE_CASES[case]
    port, jax_engine = mesh_engines(spec)
    body = {**BASE, "batch_size": batch}
    got = port.txt2img(GenerationPayload(**body))
    assert len(got.images) == batch
    assert_within_one(got, jax_engine.txt2img(JaxPayload(**body)))
    assert_within_one(got, plain.txt2img(GenerationPayload(**body)))
    return port


@pytest.fixture(scope="module")
def mesh_engines(params, providers):
    """Both packages' engines per mesh spec, built at first use."""
    built = {}

    def get(spec):
        if spec not in built:
            built[spec] = (
                port_engine(params, providers, spec),
                JaxEngine(JTINY, params, chunk_size=3, state=JaxState(),
                          mesh=jmesh.build_mesh(spec)))
        return built[spec]

    return get


@pytest.mark.parametrize("case", list(ENGINE_CASES)[:1])
def test_engine_on_a_mesh_matches_jax_and_the_meshless_port(
        case, plain, mesh_engines):
    engine_case(case, plain, mesh_engines)


@pytest.mark.parametrize("body", [
    {"precision": "int8"}, {"precision": "int8+conv"},
    {"prompt": f"mesh cow <lora:{LORA}:0.8>"}])
def test_int8_and_traced_lora_are_refused_under_tp(body, params, providers,
                                                   monkeypatch):
    monkeypatch.setenv("SDTPU_LORA_TRACED", "1")
    tp2 = port_engine(params, providers, "tp=2")
    with pytest.raises(Unsupported, match="ROADMAP item 14"):
        tp2.txt2img(GenerationPayload(**{**BASE, **body}))


def test_fleet_admission_offers_no_int8_rung_under_tp(plain, params,
                                                      providers,
                                                      monkeypatch):
    monkeypatch.setenv("SDTPU_FLEET", "1")
    monkeypatch.setenv("SDTPU_QUOTA_IPM", "60")
    monkeypatch.setenv("SDTPU_QUOTA_BURST", "1")
    # 20 steps at 32x32 predict 0.039 s: an SLO of 0.01 s fits only the
    # last rung, int8 + cadence 3 + the few-step budget of 12 (0.0082 s)
    body = {**BASE, "steps": 20, "slo_s": 0.01}
    tp2 = port_engine(params, providers, "tp=2")
    verdicts = []
    for engine in (plain, tp2):
        METRICS.clear()
        disp = ServingDispatcher(engine, bucketer=ShapeBucketer(
            shapes=[(32, 32)], batches=[1]), window=0.0)
        disp.set_calibration(EtaCalibration(avg_ipm=6.0,
                                            eta_percent_error=[0.0]))
        try:
            got = disp.submit(GenerationPayload(**body))
            verdicts.append(got.parameters["override_settings"]["precision"])
        except FleetRejected as e:
            verdicts.append(e.reason)
            # a refused request did no work: its quota token came back
            assert disp.quotas.summary()["tenants"]["default"] == 1.0
    # meshless, int8 serves it; on tp=2 it is rejected (429), not
    # degraded to int8 and then refused (422)
    assert verdicts == ["int8", "slo"]
