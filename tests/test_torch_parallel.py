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
- under ``tp=2`` the int8 precisions and traced LoRA are served through
  ``POST /sdapi/v1/txt2img`` (200), each image within its bound of the
  meshless port's (``SERVED``), and the fleet gate's admission offers the
  int8 rung there as it does meshless (the JAX admission has no other
  rule). The same requests on ``dp=4,tp=2`` against the JAX engine are in
  ``tests/test_torch_parallel_int8.py``, ``_int8_conv.py`` and
  ``_lora.py``, a JAX compile each.

The weights are TINY's parameter trees filled from a seeded numpy stream
(shapes from ``jax.eval_shape``); both packages take the same trees.
"""

import json
import urllib.error
import urllib.request

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
from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
    TINY,
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
from stable_diffusion_webui_distributed_tpu_torch.runtime.mesh import (
    build_mesh,
)
from stable_diffusion_webui_distributed_tpu_torch.scheduler.eta import (
    EtaCalibration,
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


#: what a ``tp`` engine serves beyond bf16, and each image's bound against
#: the JAX engine's and the meshless port's, (max, mean) uint8 levels: the
#: int8 precisions' of ``tests/test_torch_quant.py`` (``PIXELS``: code
#: flips at rounding edges add up over the steps) and traced LoRA's 1
#: level of ``tests/test_torch_lora_traced.py``
SERVED = {"int8": ({"precision": "int8"}, (32, 5.0)),
          "int8+conv": ({"precision": "int8+conv"}, (80, 12.0)),
          "traced LoRA": ({"prompt": f"mesh cow <lora:{LORA}:0.8>"},
                          (1, 1.0))}


def assert_within(images, want, bound):
    a = np.stack([b64png_to_array(b).astype(np.int32) for b in images])
    b = pixels(want)
    assert a.shape == b.shape
    gap = np.abs(a - b)
    assert gap.max() <= bound[0] and gap.mean() <= bound[1], \
        (int(gap.max()), float(gap.mean()))


def serve(engine, body):
    """``POST /sdapi/v1/txt2img`` of ``body`` to a server over ``engine``
    (its serving dispatcher on a 32x32 ladder): ``(status, response)``."""
    server = ApiServer(engine, port=0).start()
    req = urllib.request.Request(
        f"http://127.0.0.1:{server.port}/sdapi/v1/txt2img",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())
    finally:
        server.stop()


def served_case(case, engine, wants, monkeypatch, batch=1):
    """``SERVED[case]`` at ``batch`` served by ``engine`` (200), its
    images within the case's bound of each result in ``wants``; traced
    LoRA takes the traced path (no merge)."""
    extra, bound = SERVED[case]
    monkeypatch.setenv("SDTPU_BUCKET_LADDER", "32x32")
    METRICS.clear()
    merges = engine._lora_merge_total
    status, resp = serve(engine, {**BASE, **extra, "batch_size": batch})
    assert status == 200, resp
    assert len(resp["images"]) == batch
    if "precision" in extra:
        assert extra["precision"] in METRICS.summary()["precision"]
    else:
        assert engine._traced_lora is not None
        assert engine._lora_merge_total == merges and not engine._pristine
    for want in wants:
        assert_within(resp["images"], want, bound)


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


@pytest.fixture(scope="module")
def tp2(params, providers):
    return port_engine(params, providers, "tp=2")


@pytest.mark.parametrize("case", list(SERVED))
def test_int8_and_traced_lora_are_served_under_tp(case, plain, tp2,
                                                  monkeypatch):
    monkeypatch.setenv("SDTPU_LORA_TRACED", "1")
    extra, _ = SERVED[case]
    want = plain.txt2img(GenerationPayload(**{**BASE, **extra}))
    served_case(case, tp2, [want], monkeypatch)


def test_fleet_admission_offers_the_int8_rung_under_tp(plain, tp2,
                                                       monkeypatch):
    monkeypatch.setenv("SDTPU_FLEET", "1")
    monkeypatch.setenv("SDTPU_QUOTA_IPM", "60")
    monkeypatch.setenv("SDTPU_QUOTA_BURST", "1")
    # 20 steps at 32x32 predict 0.039 s: an SLO of 0.01 s fits only the
    # last rung, int8 + cadence 3 + the few-step budget of 12 (0.0082 s)
    body = {**BASE, "steps": 20, "slo_s": 0.01}
    verdicts = []
    for engine in (plain, tp2):
        METRICS.clear()
        disp = ServingDispatcher(engine, bucketer=ShapeBucketer(
            shapes=[(32, 32)], batches=[1]), window=0.0)
        disp.set_calibration(EtaCalibration(avg_ipm=6.0,
                                            eta_percent_error=[0.0]))
        got = disp.submit(GenerationPayload(**body))
        verdicts.append(got.parameters["override_settings"]["precision"])
        assert len(got.images) == 1
        assert METRICS.summary()["precision"] == {
            "int8": {"dispatches": 1, "requests": 1}}
    # degraded to int8 and served at int8 on both, as the JAX admission
    # degrades it on any mesh
    assert verdicts == ["int8", "int8"]
