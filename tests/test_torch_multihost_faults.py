"""The per-rank branches of a mesh across processes (``dp`` over the
ranks, ROADMAP queue 3, items 3a and 3b), against the one-process port on
the same global spec, on TINY on the CPU.

One pair of ranks (``tests/torch_multihost_rank.py``) runs the global
``dp=4,tp=2`` over four ``cpu`` entries a rank, as
``tests/test_torch_multihost.py`` does, on an engine of a ``ModelRegistry``
over a model directory (a copy per rank: a registry writes its cache
there) that holds a base and a refiner checkpoint, a ControlNet, a LoRA
and an ESRGAN upscaler, then on a TINY_INPAINT engine. Every case gives
both ranks the images, seeds and infotexts of the one-process port over
eight ``cpu`` entries, byte for byte:

- **3a**: DPM adaptive with its attempt backstop forced to 4 attempts
  (``samplers/kdiffusion.py`` ``sample_dpm_adaptive``'s ``max_attempts``,
  patched in each rank and here). Each rank runs its replicas' rows, as
  one process splits them over ``dp``, and its step controller reads the
  error of the whole batch, its rows' part gathered from both ranks; the
  ", DPM adaptive: incomplete" mark crosses the group with the pixels;
- **3b**: per-image prompts (``all_prompts``: each rank's rows of the
  group's conditioning), one ControlNet unit, int8 and traced LoRA; the
  hires pass, the refiner handoff and inpainting are
  ``tests/test_torch_multihost_faults_hires.py`` (a pair of its own keeps
  each file under a minute).
"""

import functools
import os
import shutil

import numpy as np
import pytest
from safetensors.numpy import save_file

from stable_diffusion_webui_distributed_tpu_torch.models.configs import TINY
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
    array_to_b64png,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.registry import (
    ModelRegistry,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.interrupt import (
    GenerationState,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.mesh import (
    build_mesh,
)
from stable_diffusion_webui_distributed_tpu_torch.samplers import kdiffusion
from test_adapters import make_ldm_controlnet
from test_esrgan import make_rrdb_sd
from test_registry import write_tiny_checkpoint
from test_torch_lora import make_adapter
from test_torch_multihost_mesh import SPEC, run_ranks
from test_torch_parallel import BASE, LORA, gates_off  # noqa: F401

#: DPM adaptive's attempt backstop in the 3a case: too few to reach
#: sigma_min at 32x32
MAX_ATTEMPTS = 4
CN, UPSCALER = "canny-tiny", "tiny-esrgan"


def _hint():
    hint = np.zeros((32, 32, 3), np.uint8)
    hint[8:24, 8:24] = 255
    return array_to_b64png(hint)


ADAPTIVE = {"adaptive backstop": (
    "txt2img", {**BASE, "batch_size": 4, "seed": 70,
                "sampler_name": "DPM adaptive"})}
HIRES = {"enable_hr": True, "hr_scale": 2.0, "denoising_strength": 0.6}
CASES = {
    "per-image prompts": ("txt2img", {
        **BASE, "batch_size": 4, "seed": 71,
        "all_prompts": ["a red barn", "a hen", "a cow in a field", "dusk"]}),
    "ControlNet unit": ("txt2img", {
        **BASE, "batch_size": 4, "seed": 72, "alwayson_scripts": {
            "controlnet": {"args": [{"image": _hint(), "module": "canny",
                                     "model": CN, "weight": 1.0}]}}}),
    "int8": ("txt2img", {**BASE, "batch_size": 4, "seed": 73,
                         "precision": "int8"}),
    "traced LoRA": ("txt2img", {**BASE, "batch_size": 4, "seed": 74,
                                "prompt": f"mesh cow <lora:{LORA}:0.8>"}),
}
#: the cases of ``tests/test_torch_multihost_faults_hires.py``
HIRES_CASES = {
    "hires latent": ("txt2img", {**BASE, **HIRES, "batch_size": 4,
                                 "seed": 75}),
    "hires image-space": ("txt2img", {**BASE, **HIRES, "batch_size": 4,
                                      "seed": 76, "hr_upscaler": UPSCALER}),
    "refiner": ("txt2img", {**BASE, "batch_size": 4, "seed": 77,
                            "refiner_checkpoint": "ref",
                            "refiner_switch_at": 0.5}),
}
def write_models(d: str) -> str:
    """A model directory: checkpoints ``base`` and ``ref``, a ControlNet,
    a LoRA and an ESRGAN upscaler."""
    for name in ("base", "ref"):
        write_tiny_checkpoint(d, name)
    files = {"ControlNet": (CN, {k: v * 8.0 for k, v in
                                 make_ldm_controlnet(TINY.unet).items()}),
             "Lora": (LORA, make_adapter(TINY, rank=4, seed=3)),
             "ESRGAN": (UPSCALER, make_rrdb_sd())}
    for sub, (name, sd) in files.items():
        os.makedirs(os.path.join(d, sub))
        save_file(sd, os.path.join(d, sub, f"{name}.safetensors"))
    return d


def copies(d: str, tags):
    """A copy of model directory ``d`` beside it for each of ``tags`` (a
    registry writes its cache there)."""
    return [shutil.copytree(d, f"{d}-{tag}") for tag in tags]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return write_models(str(tmp_path_factory.mktemp("faults") / "models"))


def run_pair(tmp, models, runs):
    """Both ranks' results of ``runs``: ``(name, cases, extra)`` on the
    registry's ``base`` engine over a copy of ``models`` each, or, with
    ``weights`` in ``extra``, on an engine of those weights."""
    registry = copies(models, [f"{tmp.name}-rank0", f"{tmp.name}-rank1"])
    outs = run_ranks(tmp, "runs", runs=[
        {"name": name, "mesh": SPEC, "local": 4,
         **({} if "weights" in extra else
            {"registry": registry, "model": "base"}), **extra,
         "cases": [[n, k, b] for n, (k, b) in cases.items()]}
        for name, cases, extra in runs])
    for out in outs:
        assert "error" not in out, out.get("error")
    return outs


@pytest.fixture(scope="module")
def ranks(models, tmp_path_factory):
    return run_pair(tmp_path_factory.mktemp("faults-ranks"), models, [
        ("3a", ADAPTIVE, {"max_attempts": MAX_ATTEMPTS}),
        ("3b", CASES, {"env": {"SDTPU_LORA_TRACED": "1"}})])


@pytest.fixture(scope="module")
def one_process(models):
    """The one-process port's engine of checkpoint ``base`` on the same
    global spec, of a registry over another copy of the model
    directory."""
    registry = ModelRegistry(copies(models, ["one"])[0], device="cpu",
                             state=GenerationState(),
                             mesh=build_mesh(SPEC, ["cpu"] * 8))
    return registry.activate("base")


def check(ranks, run, case, want):
    for out in ranks:
        got = out[run][case]
        assert got["images"] == want.images
        assert got["seeds"] == want.seeds
        assert got["infotexts"] == want.infotexts


def test_adaptive_backstop_marks_every_ranks_infotexts(ranks, one_process,
                                                       monkeypatch):
    monkeypatch.setattr(kdiffusion, "sample_dpm_adaptive", functools.partial(
        kdiffusion.sample_dpm_adaptive, max_attempts=MAX_ATTEMPTS))
    kind, body = ADAPTIVE["adaptive backstop"]
    want = one_process.txt2img(GenerationPayload(**body))
    assert len(want.infotexts) == 4
    assert all(t.endswith(", DPM adaptive: incomplete")
               for t in want.infotexts)
    check(ranks, "3a", "adaptive backstop", want)


@pytest.mark.parametrize("case", list(CASES))
def test_both_ranks_return_the_one_process_images(case, ranks, one_process,
                                                  monkeypatch):
    monkeypatch.setenv("SDTPU_LORA_TRACED", "1")
    kind, body = CASES[case]
    want = one_process.txt2img(GenerationPayload(**body))
    assert len(want.images) == 4
    check(ranks, "3b", case, want)
