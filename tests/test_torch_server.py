"""The port's sdapi-v1 server and CLI, over a TINY engine on the CPU.

``ApiServer(port=0)`` must answer ``POST /sdapi/v1/txt2img`` over HTTP with
the engine's own images, seeds and infotexts in webui's response shape, list
the samplers the port runs, and answer 422 for what the slice does not run.
The server puts its serving dispatcher in front of the engine; its shape
ladder is set to the requests' 32x32 here (the default would pad them up to
512x512).
"""

import json
import urllib.error
import urllib.request

import pytest
import torch

from stable_diffusion_webui_distributed_tpu_torch import bridge, cli
from stable_diffusion_webui_distributed_tpu_torch.models.configs import TINY
from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import Engine
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.interrupt import (
    GenerationState,
)
from stable_diffusion_webui_distributed_tpu_torch.server.api import ApiServer

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


def call(server, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{server.port}{path}", data=data,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def test_port_zero_binds_a_free_port(server):
    assert server.port > 0


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


def test_samplers_lists_what_the_port_runs(server):
    status, resp = call(server, "/sdapi/v1/samplers")
    assert status == 200
    assert [s["name"] for s in resp] == ["Euler a", "Euler", "DDIM",
                                         "Euler a Karras", "Euler Karras"]


@pytest.mark.parametrize("extra", [
    {"sampler_name": "DPM++ 2M"},
    {"sampler_name": "DPM adaptive"},
    {"prompt": "a <lora:x:1> cow"},
    {"styles": ["cinematic"]},
    {"steps": "many"},
])
def test_unported_or_invalid_requests_answer_422(server, extra):
    status, resp = call(server, "/sdapi/v1/txt2img", {**BODY, **extra})
    assert status == 422
    assert resp["detail"]


def test_unknown_route_answers_404(server):
    status, _ = call(server, "/sdapi/v1/img2img", BODY)
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
