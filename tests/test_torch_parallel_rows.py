"""The port's engine on a mesh, continued (``tests/test_torch_parallel.py``
holds the shared fixtures), on TINY on the CPU.

- ``sp=4`` at batch 2 against the JAX engine on the same mesh spec and the
  meshless port, within 1 uint8 level: self-attention rides the ring;
- **batch-major arguments** under ``dp=2`` (ControlNet residuals, ragged
  lengths, traced-LoRA row factors) against the meshless engine;
- **registry and CLI**: ``ModelRegistry(mesh=)`` hands the mesh on, and
  ``cli serve --mesh`` and the config's ``mesh_axes`` build the same mesh;
  under a coordinator ``cli generate`` joins a one-process group, writes
  its images and leaves it (two processes:
  ``tests/test_torch_multihost_cli.py``);
- the graphs and the tower: ``tests/test_torch_parallel_graphs.py``.
"""

import json
import os
import socket

import pytest
import torch.distributed as dist

from stable_diffusion_webui_distributed_tpu_torch import cli
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.registry import (
    ModelRegistry,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import (
    config as config_mod,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import (
    mesh as mesh_mod,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.interrupt import (
    GenerationState,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.mesh import (
    build_mesh,
)
from test_registry import write_tiny_checkpoint
from test_torch_parallel import (  # noqa: F401 — fixtures
    BASE,
    CN,
    LORA,
    _hint,
    assert_within_one,
    cpus,
    engine_case,
    gates_off,
    mesh_engines,
    params,
    plain,
    port_engine,
    providers,
)


def test_sp_engine_rides_the_ring_and_matches_jax(plain, mesh_engines):
    port = engine_case("sp=4 batch 2", plain, mesh_engines)
    assert all(a.ring is not None for a in port.unet.modules()
               if type(a).__name__ == "Attention")


# -- batch-major arguments --------------------------------------------------------

ROWS_CASES = {
    "controlnet residuals": {"alwayson_scripts": {"controlnet": {"args": [
        {"image": _hint(), "module": "none", "model": CN, "weight": 0.8}]}}},
    "ragged lengths": {"override_settings": {"ragged_true_wh": [32, 24]}},
    "traced LoRA rows": {"prompt": f"mesh cow <lora:{LORA}:0.8>"},
}


@pytest.mark.parametrize("case", list(ROWS_CASES))
def test_batch_major_arguments_split_over_dp(case, plain, params, providers,
                                             monkeypatch):
    if case == "traced LoRA rows":
        monkeypatch.setenv("SDTPU_LORA_TRACED", "1")
    dp2 = port_engine(params, providers, "dp=2")
    body = {**BASE, "batch_size": 2, "seed": 33, **ROWS_CASES[case]}
    got = dp2.txt2img(GenerationPayload(**body))
    assert_within_one(got, plain.txt2img(GenerationPayload(**body)))
    if case == "traced LoRA rows":
        assert dp2._traced_lora is not None


# -- registry and CLI ---------------------------------------------------------------

def test_registry_hands_its_mesh_to_every_engine(tmp_path):
    d = str(tmp_path / "models")
    write_tiny_checkpoint(d)
    m = build_mesh("dp=2,tp=2", cpus(4))
    reg = ModelRegistry(d, mesh=m, state=GenerationState())
    assert reg.device == m.home()
    engine = reg.activate("tinymodel")
    assert engine.mesh is m and engine.device == m.home()
    assert reg.secondary_engine("tinymodel") is engine


def test_cli_mesh_and_config_mesh_axes_build_one_mesh(tmp_path,
                                                      monkeypatch):
    monkeypatch.chdir(tmp_path)
    # four visible "cards"
    monkeypatch.setattr(mesh_mod, "_visible_devices", lambda: cpus(4))
    empty = str(tmp_path / "none")
    meshes = []
    for flag, axes in ((["--mesh", "dp=2,sp=2"], {}),
                       ([], {"dp": 2, "sp": 2})):
        cfg = str(tmp_path / f"cfg{len(meshes)}.json")
        with open(cfg, "w") as f:
            json.dump({"mesh_axes": axes}, f)
        args = cli.build_parser().parse_args(
            ["serve", "--family", "tiny", "--device", "cpu",
             "--model-dir", empty, "--distributed-config", cfg, *flag])
        _, registry = cli._build_world(args)
        assert registry.engine.mesh is registry.mesh
        meshes.append(registry.mesh)
    assert meshes[0].shape == meshes[1].shape == {"dp": 2, "tp": 1, "sp": 2}
    assert meshes[0].devices.tolist() == meshes[1].devices.tolist()
    # a coordinator: cli generate joins a one-process group, writes its
    # images and leaves the group
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("SDTPU_COORDINATOR", f"127.0.0.1:{port}")
    monkeypatch.setenv("SDTPU_NUM_PROCESSES", "1")
    monkeypatch.setenv("SDTPU_PROCESS_ID", "0")
    cfg = str(tmp_path / "cfg-gen.json")
    config_mod.save_config(config_mod.ConfigModel(workers=[{
        "master": config_mod.WorkerModel(master=True, avg_ipm=60.0)}]), cfg)
    out = str(tmp_path / "out")
    assert cli.main(["generate", "--prompt", "x", "--device", "cpu",
                     "--family", "tiny", "--size", "32x32", "--steps", "2",
                     "-n", "2", "--image-seed", "5", "--model-dir", empty,
                     "--distributed-config", cfg, "--outdir", out]) == 0
    assert sorted(os.listdir(out)) == ["5-00.png", "6-01.png"]
    assert not dist.is_initialized()
