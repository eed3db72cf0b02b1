"""A fleet of the port on TINY on the CPU, against the JAX engine.

The port's ``World`` over a master ``LocalBackend(engine A)`` and an
``HTTPBackend`` to a port ``ApiServer`` whose World serves ``engine B``
(both engines in f32 on the same Flax weights) must answer a 3-image
request with the JAX engine's seeds and infotexts, each infotext ending in
its worker's label, and pixels within 1 uint8 level (the two packages sum
in different orders, and each worker runs its range as a batch of its own
size). After the remote is stopped, its range is requeued on the master and
gives the first run's PNG bytes. Across the wire both ways: the JAX
package's ``HTTPBackend`` drives the port's server, and the port's drives
the JAX package's ``ApiServer`` over a JAX World, with seeds and infotexts
intact. Every server here serves a World, so no dispatcher pads TINY up to
its 512x512 ladder. An img2img request with a ControlNet unit is split the
same way: the remote node lists ``controlnet`` in its script info, so the
master forwards the unit, and each image is within 1 level of the JAX
engine's with the same unit.
"""

import jax
import numpy as np
import pytest

from stable_diffusion_webui_distributed_tpu.models.configs import TINY as JTINY
from stable_diffusion_webui_distributed_tpu.models.controlnet import (
    convert_controlnet,
)
from stable_diffusion_webui_distributed_tpu.pipeline.engine import (
    Engine as JaxEngine,
)
from stable_diffusion_webui_distributed_tpu.pipeline.payload import (
    GenerationPayload as JPayload,
)
from stable_diffusion_webui_distributed_tpu.runtime import config as jconfig
from stable_diffusion_webui_distributed_tpu.scheduler import worker as jworker
from stable_diffusion_webui_distributed_tpu.scheduler import world as jworld
from stable_diffusion_webui_distributed_tpu.server.api import (
    ApiServer as JaxApiServer,
)
from stable_diffusion_webui_distributed_tpu_torch import bridge
from stable_diffusion_webui_distributed_tpu_torch.models.configs import TINY
from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import Engine
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
    array_to_b64png,
    b64png_to_array,
)
from stable_diffusion_webui_distributed_tpu_torch.scheduler.worker import (
    HTTPBackend,
    LocalBackend,
    State,
    WorkerNode,
)
from stable_diffusion_webui_distributed_tpu_torch.scheduler.world import World
from stable_diffusion_webui_distributed_tpu_torch.server.api import ApiServer
from test_adapters import make_ldm_controlnet
from test_pipeline import init_params

REQUEST = dict(prompt="a cow (jumping:1.2)", negative_prompt="blurry",
               steps=3, width=64, height=64, batch_size=3, seed=42,
               subseed=7)
IPM = 60.0  # preset speeds: no benchmark runs in these tests
CN = "cn-fleet"


def _pattern(h, w):
    y, x = np.mgrid[0:h, 0:w]
    return np.stack([(x * 5) % 256, (y * 3) % 256, (x * y) % 256],
                    -1).astype(np.uint8)


IMG2IMG_CN = dict(REQUEST, denoising_strength=0.6,
                  init_images=[array_to_b64png(_pattern(64, 64))],
                  alwayson_scripts={"controlnet": {"args": [{
                      "enabled": True, "module": "canny", "model": CN,
                      "image": array_to_b64png(_pattern(48, 48))}]}})


@pytest.fixture(scope="module")
def params():
    return jax.device_get(jax.jit(init_params, static_argnums=0)(JTINY))


@pytest.fixture(scope="module")
def jax_engine(params):
    return JaxEngine(JTINY, params)


@pytest.fixture(scope="module")
def reference(jax_engine):
    return jax_engine.txt2img(JPayload(**REQUEST))


@pytest.fixture(scope="module")
def cn_tree():
    return jax.device_get(convert_controlnet(make_ldm_controlnet(JTINY.unet),
                                             JTINY.unet))


@pytest.fixture(scope="module")
def engines(params, cn_tree):
    sd = bridge.flax_to_torch(TINY, params)
    cn = bridge.controlnet_flax_to_torch(cn_tree)

    def provider(name):
        return cn if name == CN else None

    return (Engine(TINY, sd, chunk_size=2, device="cpu",
                   controlnet_provider=provider),
            Engine(TINY, sd, chunk_size=2, device="cpu",
                   controlnet_provider=provider))


def master_world(engine) -> World:
    world = World()
    world.add_worker(WorkerNode("master", LocalBackend(engine), master=True,
                                avg_ipm=IPM))
    return world


@pytest.fixture
def remote(engines):
    srv = ApiServer(master_world(engines[1]), port=0).start()
    yield srv
    srv.stop()


def fleet(engine, port: int) -> World:
    world = master_world(engine)
    world.add_worker(WorkerNode("remote", HTTPBackend("127.0.0.1", port),
                                avg_ipm=IPM))
    return world


def pixels(images):
    return [b64png_to_array(b).astype(np.int32) for b in images]


def assert_matches_reference(result, reference, labels, served_by=None):
    """Seeds, labels and infotexts as the JAX engine's plus the labels;
    ``served_by[i]``: the label the remote node's own World gave image i
    (a remote node is a fleet of its own and labels its images too)."""
    served_by = served_by or [None] * len(labels)
    assert result.seeds == reference.seeds == [42, 43, 44]
    assert result.subseeds == reference.subseeds
    assert result.worker_labels == labels
    assert result.infotexts == [
        t + "".join(f", Worker Label: {x}" for x in (inner, lab) if x)
        for t, lab, inner in zip(reference.infotexts, labels, served_by)]
    for got, want in zip(pixels(result.images), pixels(reference.images)):
        assert got.shape == want.shape == (64, 64, 3)
        assert np.abs(got - want).max() <= 1


def test_fleet_matches_the_jax_engine(engines, remote, reference):
    world = fleet(engines[0], remote.port)
    # synced to the remote first: the one model the remote node serves
    world.current_model = engines[1].model_name
    result = world.execute(GenerationPayload(**REQUEST))
    assert_matches_reference(result, reference,
                             ["master", "master", "remote"],
                             [None, None, "master"])
    assert [(j.worker.label, j.batch_size, j.start_index)
            for j in world.jobs] == [("master", 2, 0), ("remote", 1, 2)]
    assert remote.options["sd_model_checkpoint"] == "tiny"
    assert all(w.current_state() == State.IDLE for w in world.workers)


def test_requeue_after_the_remote_stops_gives_the_same_images(
        engines, remote, reference):
    world = fleet(engines[0], remote.port)
    first = world.execute(GenerationPayload(**REQUEST))
    remote.stop()
    again = world.execute(GenerationPayload(**REQUEST))
    assert again.images == first.images
    assert again.seeds == first.seeds
    assert again.worker_labels == ["master"] * 3
    assert world.get_worker("remote").current_state() == State.UNAVAILABLE
    assert world.get_worker("remote").health.summary()[
        "requeued_images"] == 1
    assert_matches_reference(again, reference, ["master"] * 3)


def test_img2img_controlnet_split_keeps_the_units(params, cn_tree, engines,
                                                  remote):
    world = fleet(engines[0], remote.port)
    node = world.get_worker("remote")
    assert node.reachable() and node.supported_scripts == [
        "controlnet", "prompt matrix", "prompts from file or textbox",
        "x/y/z plot"]
    payload = GenerationPayload(**IMG2IMG_CN)
    assert node.filter_payload_scripts(payload) is payload  # nothing cut
    result = world.execute(payload)
    want = JaxEngine(JTINY, params, controlnet_provider=lambda n: (
        cn_tree if n == CN else None)).img2img(JPayload(**IMG2IMG_CN))
    assert_matches_reference(result, want, ["master", "master", "remote"],
                             [None, None, "master"])
    # the unit ran on both workers: without it every image is another
    plain = engines[0].img2img(GenerationPayload(**{
        k: v for k, v in IMG2IMG_CN.items() if k != "alwayson_scripts"}))
    for got, other in zip(pixels(result.images), pixels(plain.images)):
        assert np.abs(got - other).mean() > 1.0


def test_jax_http_backend_drives_the_port_server(remote, reference):
    world = jworld.World(jconfig.ConfigModel())
    world.add_worker(jworker.WorkerNode(
        "port", jworker.HTTPBackend("127.0.0.1", remote.port),
        avg_ipm=IPM))
    result = world.execute(JPayload(**REQUEST))
    assert_matches_reference(result, reference, ["port"] * 3,
                             ["master"] * 3)


def test_port_http_backend_drives_the_jax_server(jax_engine, reference):
    jax_world = jworld.World(jconfig.ConfigModel())
    jax_world.add_worker(jworker.WorkerNode(
        "master", jworker.LocalBackend(jax_engine), master=True,
        avg_ipm=IPM))
    srv = JaxApiServer(jax_world, port=0).start()
    try:
        world = World()
        world.add_worker(WorkerNode(
            "jax", HTTPBackend("127.0.0.1", srv.port), avg_ipm=IPM))
        result = world.execute(GenerationPayload(**REQUEST))
    finally:
        srv.stop()
    assert_matches_reference(result, reference, ["jax"] * 3,
                             ["master"] * 3)
    # the JAX node ran the reference's own batch
    for got, want in zip(pixels(result.images), pixels(reference.images)):
        assert np.array_equal(got, want)
