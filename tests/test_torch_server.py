"""The port's sdapi-v1 server and CLI, over a TINY engine on the CPU.

``ApiServer(port=0)`` must answer ``POST /sdapi/v1/txt2img`` over HTTP with
the engine's own images, seeds and infotexts in webui's response shape, list
the JAX package's 18 samplers, and answer 422 for what the slice does not
run.
Over a bare engine the server puts its serving dispatcher in front of it;
its shape ladder is set to the requests' 32x32 here (the default would pad
them up to 512x512). Over a ``World`` it serves the fleet without the
dispatcher, and answers the routes a master's ``HTTPBackend`` and the CLI
call on a node (memory, options, models, scripts, restart, workers,
benchmark) in webui's shapes, optionally behind Basic auth. The CLI's
``workers`` and ``status`` commands work on a config file without a GPU;
the commands that build an engine raise without one.
"""

import base64
import json
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from stable_diffusion_webui_distributed_tpu.samplers.kdiffusion import (
    SAMPLERS as JAX_SAMPLERS,
)
from stable_diffusion_webui_distributed_tpu_torch import bridge, cli
from stable_diffusion_webui_distributed_tpu_torch.models.configs import TINY
from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import Engine
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
    Unsupported,
    array_to_b64png,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import (
    config as config_mod,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.interrupt import (
    GenerationState,
)
from stable_diffusion_webui_distributed_tpu_torch.scheduler.worker import (
    HTTPBackend,
    LocalBackend,
    State,
    StubBackend,
    WorkerNode,
)
from stable_diffusion_webui_distributed_tpu_torch.scheduler.world import World
from stable_diffusion_webui_distributed_tpu_torch.server.api import (
    MODEL_LIST_TIMEOUT,
    ApiServer,
)

BODY = {"prompt": "a cow", "negative_prompt": "ugly", "steps": 3,
        "width": 32, "height": 32, "seed": 5, "subseed": 9, "batch_size": 2}


@pytest.fixture(scope="module")
def engine():
    return Engine(TINY, bridge.init_seeded(TINY, 0, device="cpu"),
                  state=GenerationState(), device="cpu")


@pytest.fixture(scope="module")
def server(engine):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SDTPU_BUCKET_LADDER", "32x32")
        srv = ApiServer(engine, port=0).start()
    yield srv
    srv.stop()


def call(server, path, body=None, headers=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{server.port}{path}", data=data,
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def test_port_zero_binds_a_free_port(server):
    assert server.port > 0
    assert server.dispatcher is not None  # a bare engine keeps it


def test_txt2img_answers_with_the_engines_images(engine, server):
    status, resp = call(server, "/sdapi/v1/txt2img", BODY)
    assert status == 200
    want = engine.txt2img(GenerationPayload(**BODY))
    assert resp["images"] == want.images
    info = json.loads(resp["info"])
    assert info["all_seeds"] == want.seeds == [5, 6]
    assert info["all_subseeds"] == want.subseeds == [9, 10]
    assert info["infotexts"] == want.infotexts
    assert info["seed"] == 5
    assert resp["parameters"]["prompt"] == "a cow"


def _init_image():
    import numpy as np

    y, x = np.mgrid[0:32, 0:32]
    return array_to_b64png(np.stack([x * 8, y * 8, (x + y) * 4], -1)
                           .astype(np.uint8))


@pytest.mark.parametrize("source", ["server", "world_server"])
def test_img2img_without_init_images_answers_422(request, source):
    srv = request.getfixturevalue(source)
    status, resp = call(srv, "/sdapi/v1/img2img", BODY)
    assert status == 422 and "init_images" in resp["detail"]


def test_img2img_answers_with_the_engines_images(engine, server):
    body = {**BODY, "init_images": [_init_image()],
            "denoising_strength": 0.5}
    status, resp = call(server, "/sdapi/v1/img2img", body)
    assert status == 200
    want = engine.img2img(GenerationPayload(**body))
    assert resp["images"] == want.images
    info = json.loads(resp["info"])
    assert info["all_seeds"] == want.seeds == [5, 6]
    assert info["infotexts"] == want.infotexts
    assert "Denoising strength: 0.5" in info["infotexts"][0]


def test_world_answers_img2img(fleet_engine, world_server):
    body = {**BODY, "init_images": [_init_image()], "batch_size": 1}
    status, resp = call(world_server, "/sdapi/v1/img2img", body)
    assert status == 200
    want = fleet_engine.img2img(GenerationPayload(**body))
    assert resp["images"] == want.images


def test_samplers_lists_what_the_port_runs(server):
    status, resp = call(server, "/sdapi/v1/samplers")
    assert status == 200
    assert [s["name"] for s in resp] == list(JAX_SAMPLERS)
    assert len(resp) == 18


@pytest.mark.parametrize("extra", [
    {"override_settings": {"deepcache": 2}},
    {"override_settings": {"cfg_cutoff": 0.5}},
    {"steps": "many"},
])
def test_unported_or_invalid_requests_answer_422(server, extra):
    status, resp = call(server, "/sdapi/v1/txt2img", {**BODY, **extra})
    assert status == 422
    assert resp["detail"]


def test_lora_requests_are_served(server):
    """A ``<lora:...>`` tag answers 200; an adapter the engine cannot find
    is skipped, so the images are the tagless ones, and the infotext keeps
    the tag."""
    status, plain = call(server, "/sdapi/v1/txt2img", BODY)
    assert status == 200
    status, resp = call(server, "/sdapi/v1/txt2img",
                        {**BODY, "prompt": "a <lora:x:1> cow"})
    assert status == 200
    assert resp["images"] == plain["images"]
    assert "<lora:x:1>" in json.loads(resp["info"])["infotexts"][0]
    # no registry behind this server: a rescan has nothing to do
    assert call(server, "/sdapi/v1/refresh-loras", {}) == (200, {})


def test_unknown_route_answers_404(server):
    status, _ = call(server, "/sdapi/v1/extra-single-image", BODY)
    assert status == 404


def test_progress_reports_the_last_run(server):
    call(server, "/sdapi/v1/txt2img", {**BODY, "batch_size": 1})
    status, resp = call(server, "/sdapi/v1/progress")
    assert status == 200
    assert resp["state"]["sampling_steps"] == 3
    assert resp["state"]["sampling_step"] == 3


def test_cli_serve_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["serve", "--family", "tiny", "--port", "0"])


def test_cli_parser():
    args = cli.build_parser().parse_args(
        ["serve", "--family", "sd15", "--port", "7860"])
    assert (args.family, args.port, args.device) == ("sd15", 7860, None)
    args = cli.build_parser().parse_args(
        ["serve", "--seed", "3", "--distributed-config", "f.json",
         "--thin-client", "--api-auth-user", "u"])
    assert (args.seed, args.distributed_config, args.thin_client,
            args.api_auth_user, args.listen) == (3, "f.json", True, "u",
                                                 "127.0.0.1")


# -- a World source ----------------------------------------------------------

@pytest.fixture(scope="module")
def fleet_engine():
    # a World resets the process-wide interrupt state, so its engine
    # shares it
    return Engine(TINY, bridge.init_seeded(TINY, 0, device="cpu"),
                  device="cpu")


@pytest.fixture(scope="module")
def world_server(fleet_engine):
    world = World()
    world.add_worker(WorkerNode("master", LocalBackend(fleet_engine),
                                master=True, avg_ipm=60.0))
    srv = ApiServer(world, port=0).start()
    yield srv
    srv.stop()


@pytest.fixture
def stub_fleet():
    """A World of two stub remotes, one not yet benchmarked, served."""
    world = World()
    world.add_worker(WorkerNode("r1", StubBackend(), avg_ipm=5.0))
    world.add_worker(WorkerNode(
        "r2", HTTPBackend("10.9.9.9", 7861, user="u", password="secret")))
    world.workers[1].backend = StubBackend()
    srv = ApiServer(world, port=0).start()
    yield srv
    srv.stop()


def test_world_source_answers_txt2img_without_a_dispatcher(
        fleet_engine, world_server):
    assert world_server.dispatcher is None
    status, resp = call(world_server, "/sdapi/v1/txt2img", BODY)
    assert status == 200
    want = fleet_engine.txt2img(GenerationPayload(**BODY))
    assert resp["images"] == want.images
    info = json.loads(resp["info"])
    assert info["all_seeds"] == want.seeds == [5, 6]
    assert info["infotexts"] == [t + ", Worker Label: master"
                                 for t in want.infotexts]


@pytest.mark.parametrize("extra", [
    {"override_settings": {"cfg_cutoff": 0.5}},
    {"precision": "int8"},
])
def test_world_refuses_unported_requests_before_fan_out(world_server, extra):
    master = world_server.source.master()
    before = master.health.summary()["requests"]
    status, resp = call(world_server, "/sdapi/v1/txt2img", {**BODY, **extra})
    assert status == 422 and resp["detail"]
    assert master.current_state() == State.IDLE
    assert master.health.summary()["requests"] == before


def test_world_serves_lora_requests(world_server, fleet_engine):
    body = {**BODY, "prompt": "a <lora:x:1> cow"}
    status, resp = call(world_server, "/sdapi/v1/txt2img", body)
    assert status == 200
    want = fleet_engine.txt2img(GenerationPayload(**BODY))
    assert resp["images"] == want.images
    assert "<lora:x:1>" in json.loads(resp["info"])["infotexts"][0]


def test_memory_route_has_webuis_shape(world_server):
    status, resp = call(world_server, "/sdapi/v1/memory")
    assert status == 200
    assert set(resp["ram"]) == {"free", "used", "total"}
    assert resp["ram"]["total"] > 0
    # a CPU engine has no card: webui's cuda section reads zeros
    assert resp["cuda"]["system"] == {"free": 0, "used": 0, "total": 0}


def test_options_record_the_model_and_sync_the_remotes(stub_fleet):
    # a World without a local engine serves the models its workers list
    status, resp = call(stub_fleet, "/sdapi/v1/options",
                        {"sd_model_checkpoint": "stub-model",
                         "sd_vae": "Automatic",
                         "distributed_job_timeout": 9,
                         "step_scaling": True})
    assert status == 200 and resp == {}
    world = stub_fleet.source
    assert world.current_model == "stub-model" and world.current_vae == ""
    assert [w.backend.options for w in world.workers] == \
        [{"model": "stub-model", "vae": ""}] * 2
    assert (world.job_timeout, world.step_scaling) == (9.0, True)
    status, opts = call(stub_fleet, "/sdapi/v1/options")
    assert opts["sd_model_checkpoint"] == "stub-model"
    assert opts["sd_vae"] == "Automatic"
    status, models = call(stub_fleet, "/sdapi/v1/sd-models")
    assert [m["model_name"] for m in models] == ["stub-model"]
    assert set(models[0]) == {"title", "model_name", "filename", "hash",
                              "sha256"}


def test_options_do_not_wait_on_a_stalled_or_unavailable_worker(stub_fleet):
    """A World without a local engine asks its workers for their models
    all at once, skips one the last ping found down, and waits no longer
    than MODEL_LIST_TIMEOUT for one that does not answer."""
    world = stub_fleet.source
    release = threading.Event()
    asked = []

    def stalled():
        asked.append("r1")
        release.wait(30)
        return ["stub-model"]

    def down():
        asked.append("r3")
        return ["other-model"]

    world.workers[0].backend.available_models = stalled
    world.add_worker(WorkerNode("r3", StubBackend()))
    world.workers[2].backend.available_models = down
    world.workers[2].set_state(State.UNAVAILABLE)
    try:
        t0 = time.monotonic()
        status, _ = call(stub_fleet, "/sdapi/v1/options",
                         {"sd_model_checkpoint": "stub-model"})
        took = time.monotonic() - t0
        assert status == 200
        status, resp = call(stub_fleet, "/sdapi/v1/options",
                            {"sd_model_checkpoint": "other-model"})
        assert status == 422 and resp["detail"]
    finally:
        release.set()
    assert took < MODEL_LIST_TIMEOUT + 5.0
    assert "r3" not in asked


@pytest.mark.parametrize("body", [
    {"sd_model_checkpoint": "sdxl-base"},
    {"sd_vae": "vae-ft-mse-840000.safetensors"},
    {"sd_model_checkpoint": "tiny", "sd_vae": "kl-f8-anime.ckpt",
     "CLIP_stop_at_last_layers": 2},
])
def test_options_refuse_a_model_the_node_cannot_serve(world_server,
                                                     fleet_engine, body):
    """Without a checkpoint registry a node switches to no other model and
    loads no standalone VAE: such a request answers 422 and changes
    nothing, neither the options nor the engine nor the fleet."""
    world = world_server.source
    before = call(world_server, "/sdapi/v1/options")[1]
    fleet_before = (world.current_model, world.current_vae)
    status, resp = call(world_server, "/sdapi/v1/options", body)
    assert status == 422 and resp["detail"]
    assert call(world_server, "/sdapi/v1/options")[1] == before
    assert fleet_engine.model_name == "tiny"
    assert (world.current_model, world.current_vae) == fleet_before
    status, models = call(world_server, "/sdapi/v1/sd-models")
    assert [m["model_name"] for m in models] == ["tiny"]
    status, resp = call(world_server, "/sdapi/v1/options",
                        {"sd_model_checkpoint": "tiny", "sd_vae": "None"})
    assert status == 200


def test_local_backend_refuses_another_model(fleet_engine):
    backend = LocalBackend(fleet_engine)
    backend.load_options("tiny", "")
    for model, vae in (("sd15", ""), ("tiny", "vae.pt")):
        with pytest.raises(Unsupported):
            backend.load_options(model, vae)
    assert fleet_engine.model_name == "tiny"


def test_script_info_lists_what_the_port_runs(world_server):
    status, scripts = call(world_server, "/sdapi/v1/script-info")
    assert status == 200
    assert [s["name"] for s in scripts] == [
        "controlnet", "prompt matrix", "prompts from file or textbox",
        "x/y/z plot"]
    assert scripts[0]["is_alwayson"] and scripts[0]["is_img2img"]
    assert not any(s["is_alwayson"] for s in scripts[1:])
    master = world_server.source.master()
    assert master.backend.script_info() == ["controlnet"]


def test_internal_workers_rows(stub_fleet):
    status, rows = call(stub_fleet, "/internal/workers")
    assert status == 200
    assert [r["label"] for r in rows] == ["r1", "r2"]
    assert rows[0]["state"] == "IDLE" and rows[0]["avg_ipm"] == 5.0
    assert set(rows[0]["health"]) >= {"requests", "failures", "error_rate",
                                      "requeued_images", "transitions"}
    assert "password" not in json.dumps(rows)


def test_internal_benchmark_runs_a_sweep(stub_fleet):
    status, resp = call(stub_fleet, "/internal/benchmark",
                        {"rebenchmark": False})
    assert status == 200 and resp["started"] is True
    r2 = stub_fleet.source.get_worker("r2")
    deadline = time.monotonic() + 30
    while not r2.cal.benchmarked and time.monotonic() < deadline:
        time.sleep(0.05)
    assert r2.cal.benchmarked
    assert len(r2.backend.requests) == 5  # 2 warm-up + 3 recorded
    assert stub_fleet.source.get_worker("r1").cal.avg_ipm == 5.0


def test_internal_benchmark_needs_a_fleet(server):
    status, resp = call(server, "/internal/benchmark", {})
    assert status == 400
    assert call(server, "/internal/workers") == (200, [])


def test_basic_auth(fleet_engine):
    srv = ApiServer(fleet_engine, port=0, user="u", password="p").start()
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/sdapi/v1/samplers", timeout=30)
        assert err.value.code == 401
        assert err.value.headers["WWW-Authenticate"] == "Basic"
        token = base64.b64encode(b"u:p").decode()
        status, _ = call(srv, "/sdapi/v1/samplers",
                         headers={"Authorization": f"Basic {token}"})
        assert status == 200
        # a master's backend carries the credentials on every call
        assert HTTPBackend("127.0.0.1", srv.port, user="u",
                           password="p").reachable()
        assert not HTTPBackend("127.0.0.1", srv.port).reachable()
    finally:
        srv.stop()


def test_server_restart_flags_the_process_and_stops_serving(fleet_engine):
    srv = ApiServer(World(), port=0).start()
    port = srv.port
    assert call(srv, "/sdapi/v1/server-restart", {}) == (200, {})
    assert srv.restart_requested
    deadline = time.monotonic() + 10
    while srv._httpd is not None and time.monotonic() < deadline:
        time.sleep(0.05)
    assert srv._httpd is None
    assert not HTTPBackend("127.0.0.1", port, timeout=1.0).reachable()


# -- the CLI -----------------------------------------------------------------

def run_cli(capsys, *argv):
    rc = cli.main(list(argv))
    return rc, capsys.readouterr().out


def test_cli_workers_add_list_set_remove(tmp_path, capsys):
    path = str(tmp_path / "fleet.json")
    cfg = ("--distributed-config", path)
    assert run_cli(capsys, "workers", "add", "--label", "r1", "--address",
                   "10.0.0.2", "--api-port", "7861", "--tls", *cfg)[0] == 0
    assert run_cli(capsys, "workers", "add", "--label", "r2", *cfg)[0] == 0
    rc, out = run_cli(capsys, "workers", "list", *cfg)
    assert rc == 0
    assert out.split()[:3] == ["r1", "10.0.0.2:7861", "tls"]
    assert "r2" in out
    rc, out = run_cli(capsys, "workers", "set", "--label", "r1",
                      "--pixel-cap", "1048576", "--model-override", "sd15",
                      "--disable", *cfg)
    assert rc == 0 and "disabled=True" in out
    loaded = config_mod.load_config(path)
    r1 = loaded.workers[0]["r1"]
    assert (r1.pixel_cap, r1.model_override, r1.disabled, r1.tls) == \
        (1048576, "sd15", True, True)
    assert run_cli(capsys, "workers", "remove", "--label", "r2", *cfg) == \
        (0, "removed 1 worker(s)\n")
    assert [list(e) for e in config_mod.load_config(path).workers] == \
        [["r1"]]
    assert run_cli(capsys, "workers", "set", "--label", "nope", *cfg)[0] == 1
    assert run_cli(capsys, "workers", "add", *cfg)[0] == 2


def test_cli_status_needs_no_gpu(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "fleet.json")
    config_mod.save_config(config_mod.ConfigModel(workers=[
        {"master": config_mod.WorkerModel(master=True, avg_ipm=81.5)},
        {"r1": config_mod.WorkerModel(address="10.0.0.2", avg_ipm=40.0)},
        {"r2": config_mod.WorkerModel(disabled=True)},
    ]), path)
    rc, out = run_cli(capsys, "status", "--distributed-config", path)
    assert rc == 0
    lines = out.splitlines()
    assert lines[0] == f"config: {path}"
    assert lines[1].split() == ["master", "(local)", "81.50", "ipm",
                                "[master]"]
    assert lines[2].split() == ["r1", "IDLE", "40.00", "ipm"]
    assert lines[3].split() == ["r2", "DISABLED", "not", "benchmarked"]


@pytest.mark.parametrize("argv", [
    ["generate", "--prompt", "a cow", "--family", "tiny"],
    ["benchmark", "--family", "tiny"],
])
def test_cli_engine_commands_raise_without_a_gpu(tmp_path, monkeypatch,
                                                 argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "fleet.json")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv + ["--distributed-config", path])
    assert not (tmp_path / "fleet.json").exists()
