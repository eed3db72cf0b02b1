"""The port's checkpoint registry against the JAX package's, on the CPU.

Synthetic single-file checkpoints (``tests/test_registry.py``'s
``write_tiny_checkpoint`` and the ``make_ldm_*`` writers) go into a model
directory. The port's ``ModelRegistry`` (``device="cpu"``, F32) activates
them and generates; the JAX package's registry activates a copy of the
same files. Images must agree within 1 uint8 level per pixel, seeds and
infotexts exactly, as in ``tests/test_torch_engine.py``. Also: the family
sidecar against the JAX choice, the converted-params cache (byte-identical
PNGs from a second registry; a touched source or sidecar is stale; a
corrupt cache converts again), standalone VAEs (an override changes the
bytes, "Automatic" restores them exactly, it stays across a switch), a
model switch through ``POST /sdapi/v1/options`` on a World built as ``cli
serve`` builds it (the previous engine freed, ``sd-models``,
``refresh-checkpoints``, 422 for an unknown name), a refiner and a
ControlNet named by file, and the device rule.
"""

import gc
import json
import os
import shutil
import threading
import urllib.error
import urllib.request
import weakref

import numpy as np
import pytest
import torch

from stable_diffusion_webui_distributed_tpu.models.configs import (
    TINY_REFINER as JTINY_REFINER,
    TINY_XL as JTINY_XL,
)
from stable_diffusion_webui_distributed_tpu.pipeline.payload import (
    GenerationPayload as JaxPayload,
)
from stable_diffusion_webui_distributed_tpu.pipeline.registry import (
    ModelRegistry as JaxRegistry,
)
from stable_diffusion_webui_distributed_tpu.runtime import dtypes as jdtypes
from stable_diffusion_webui_distributed_tpu.runtime.interrupt import (
    GenerationState as JaxState,
)
from stable_diffusion_webui_distributed_tpu_torch import cli
from stable_diffusion_webui_distributed_tpu_torch.models import convert
from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
    TINY,
    TINY_REFINER,
    TINY_XL,
)
from stable_diffusion_webui_distributed_tpu_torch.models.controlnet import (
    convert_controlnet,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import Engine
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
    Unsupported,
    array_to_b64png,
    b64png_to_array,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.registry import (
    ModelRegistry,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import (
    config as config_mod,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import dtypes
from stable_diffusion_webui_distributed_tpu_torch.runtime.interrupt import (
    GenerationState,
)
from stable_diffusion_webui_distributed_tpu_torch.scheduler.worker import (
    LocalBackend,
)
from stable_diffusion_webui_distributed_tpu_torch.server.api import ApiServer
from test_adapters import make_ldm_controlnet
from test_models import (
    make_ldm_clip_hf,
    make_ldm_clip_openai,
    make_ldm_unet,
    make_ldm_vae,
)
from test_registry import write_tiny_checkpoint

BODY = dict(prompt="a cow (jumping:1.2)", negative_prompt="blurry", steps=3,
            width=32, height=32, seed=7, subseed=2, batch_size=2)
XL_BODY = dict(prompt="a red fox", steps=4, width=32, height=32, seed=11,
               subseed=1, batch_size=1, sampler_name="Euler a")


def pixels(b64):
    return b64png_to_array(b64).astype(np.int32)


def assert_matches_jax(got, want, label=""):
    """Seeds equal, infotexts equal (the port's World appending its worker
    label), pixels within 1 uint8 level."""
    assert got.seeds == want.seeds
    assert got.infotexts == [t + label for t in want.infotexts]
    assert len(got.images) == len(want.images)
    for a, b in zip(got.images, want.images):
        pa, pb = pixels(a), pixels(b)
        assert pa.shape == pb.shape
        assert np.abs(pa - pb).max() <= 1
        assert pa.std() > 1.0


def write_ldm(model_dir, name, sd, family):
    from safetensors.numpy import save_file

    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, f"{name}.safetensors")
    save_file(sd, path)
    with open(path + ".json", "w") as f:
        json.dump({"family": family}, f)
    return path


def write_bare_vae(model_dir, name="alt"):
    from safetensors.numpy import save_file

    bare = {k[len("first_stage_model."):]: v * 1.5
            for k, v in make_ldm_vae(TINY.vae).items()}
    os.makedirs(os.path.join(model_dir, "VAE"), exist_ok=True)
    save_file(bare, os.path.join(model_dir, "VAE", f"{name}.safetensors"))


def mirror(src_dir, dst_dir):
    """A copy of the model directory's files (mtimes kept), for the JAX
    registry, whose cache must not meet the port's."""
    shutil.copytree(src_dir, dst_dir, dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns(".sdtpu-cache"))
    return dst_dir


def port_registry(model_dir):
    return ModelRegistry(model_dir, device="cpu", state=GenerationState())


def jax_registry(model_dir):
    return JaxRegistry(model_dir, policy=jdtypes.F32, state=JaxState())


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """Two TINY checkpoints with family sidecars, one without, and a
    standalone VAE."""
    d = str(tmp_path_factory.mktemp("models"))
    write_tiny_checkpoint(d, "amodel")
    write_tiny_checkpoint(d, "bmodel")
    path = write_tiny_checkpoint(d, "nosidecar")
    os.remove(path + ".json")
    write_bare_vae(d)
    return d


@pytest.fixture(scope="module")
def jax_dir(model_dir, tmp_path_factory):
    return mirror(model_dir, str(tmp_path_factory.mktemp("jax-models")))


@pytest.fixture(scope="module")
def jax_runs(jax_dir):
    """The JAX registry's images of each checkpoint, with and without the
    standalone VAE."""
    reg = jax_registry(jax_dir)
    out = {}
    for name in ("amodel", "bmodel"):
        engine = reg.activate(name)
        out[name] = engine.txt2img(JaxPayload(**BODY))
        assert reg.set_vae("alt")
        out[name, "alt"] = engine.txt2img(JaxPayload(**BODY))
        assert reg.set_vae("Automatic")
    return out


@pytest.fixture(scope="module")
def port_a(model_dir):
    reg = port_registry(model_dir)
    engine = reg.activate("amodel")
    return reg, engine, engine.txt2img(GenerationPayload(**BODY))


# -- activation, the family, the cache ----------------------------------------

def test_registry_engine_matches_jax(port_a, jax_runs):
    reg, engine, got = port_a
    assert reg.current_name == "amodel" and engine.model_name == "amodel"
    assert engine.family.name == "tiny"
    assert set(reg.available()) == {"amodel", "bmodel", "nosidecar"}
    assert list(reg.available_vaes()) == ["alt"]
    assert_matches_jax(got, jax_runs["amodel"])


@pytest.mark.parametrize("sidecar", ["tiny", "none", "malformed", "empty"])
def test_family_follows_the_sidecar_as_jax(tmp_path, sidecar):
    path = write_tiny_checkpoint(str(tmp_path), "m")
    if sidecar == "none":
        os.remove(path + ".json")
    elif sidecar == "malformed":
        with open(path + ".json", "w") as f:
            f.write("{not json")
    elif sidecar == "empty":
        with open(path + ".json", "w") as f:
            json.dump({"family": ""}, f)
    want = JaxRegistry._family_for(path, convert_np(path))
    got = ModelRegistry._family_for(path, convert.read_state_dict(path))
    assert got == want == ("tiny" if sidecar == "tiny" else "sd15")


def convert_np(path):
    from safetensors.numpy import load_file

    return load_file(path)


def test_without_a_sidecar_both_refuse_the_tiny_weights(model_dir, jax_dir):
    """Without a sidecar the keys say SD1.5, whose blocks a TINY checkpoint
    lacks: both registries refuse. The port names every absent key; the
    JAX package's zero stand-in for an absent key fails its q/k/v fusion
    first (an ``AxisError``)."""
    with pytest.raises(Exception):
        jax_registry(jax_dir).activate("nosidecar")
    reg = port_registry(model_dir)
    with pytest.raises(convert.MissingKeys):
        reg.activate("nosidecar")
    assert reg.engine is None


def test_cache_restores_byte_identical(port_a, model_dir):
    _, _, first = port_a
    cache = os.path.join(model_dir, ".sdtpu-cache", "amodel")
    with open(os.path.join(cache, "meta.json")) as f:
        meta = json.load(f)
    assert meta["family"] == "tiny"
    assert meta["src_mtime"] == os.path.getmtime(
        os.path.join(model_dir, "amodel.safetensors"))
    reg = port_registry(model_dir)
    path = reg.checkpoint_path("amodel")
    family, params = reg._load_param_cache("amodel", path)
    assert family.name == "tiny"
    src = convert.load_checkpoint(path, TINY)
    for comp in src:
        assert set(params[comp]) == set(src[comp])
        assert all(torch.equal(params[comp][k], v)
                   for k, v in src[comp].items())
    again = reg.activate("amodel").txt2img(GenerationPayload(**BODY))
    assert again.images == first.images
    assert again.infotexts == first.infotexts


@pytest.mark.parametrize("touch", ["source", "sidecar"])
def test_touched_file_makes_the_cache_stale(tmp_path, touch):
    d = str(tmp_path)
    path = write_tiny_checkpoint(d, "m")
    reg = port_registry(d)
    reg.activate("m")
    assert reg._load_param_cache("m", path) is not None
    target = path if touch == "source" else path + ".json"
    os.utime(target, (os.path.getmtime(target) + 10,) * 2)
    assert port_registry(d)._load_param_cache("m", path) is None


@pytest.mark.parametrize("damage", ["params", "meta"])
def test_corrupt_cache_converts_again(tmp_path, damage, caplog):
    d = str(tmp_path)
    path = write_tiny_checkpoint(d, "m")
    first = port_registry(d).activate("m").txt2img(
        GenerationPayload(**BODY))
    cache = os.path.join(d, ".sdtpu-cache", "m")
    victim = os.path.join(cache, "params.pt" if damage == "params"
                          else "meta.json")
    with open(victim, "wb") as f:
        f.write(b"\0garbage")
    reg = port_registry(d)
    assert reg._load_param_cache("m", path) is None
    again = reg.activate("m").txt2img(GenerationPayload(**BODY))
    assert again.images == first.images
    assert reg._load_param_cache("m", path) is not None  # written anew


# -- standalone VAEs ----------------------------------------------------------

def test_vae_override_and_restore(port_a, jax_runs):
    reg, engine, base = port_a
    p = GenerationPayload(**BODY)
    assert reg.set_vae("alt")
    swapped = engine.txt2img(p)
    assert swapped.images != base.images
    assert_matches_jax(swapped, jax_runs["amodel", "alt"])
    assert reg.set_vae("alt.safetensors")  # webui's file name
    assert engine.txt2img(p).images == swapped.images
    assert reg.set_vae("Automatic")
    assert engine.txt2img(p).images == base.images
    assert not reg.set_vae("nonexistent")
    assert engine.txt2img(p).images == base.images


def test_vae_override_clears_the_inpainting_conditioning(port_a):
    _, engine, _ = port_a
    engine._blank_cond_cache[(1, 32, 32)] = torch.zeros(1)
    engine.set_vae(None)  # nothing applied: a no-op
    assert (1, 32, 32) in engine._blank_cond_cache
    vae = convert.convert_vae(
        {k: torch.from_numpy(v) for k, v in make_ldm_vae(TINY.vae).items()},
        TINY.vae)
    engine.set_vae({"vae": vae["decoder"], "vae_encoder": vae["encoder"]})
    assert engine._blank_cond_cache == {}
    engine.set_vae(None)
    assert engine._checkpoint_vae is None


# -- the LocalBackend ---------------------------------------------------------

def test_local_backend_follows_the_registry(model_dir, port_a):
    _, _, a_run = port_a
    reg = port_registry(model_dir)
    reg.activate("amodel")
    backend = LocalBackend(registry=reg)
    assert backend.available_models() == ["amodel", "bmodel", "nosidecar"]
    engine_a = backend.engine
    a1 = backend.generate(GenerationPayload(**BODY), 0, 1)
    assert a1.images == a_run.images[:1]
    # a switch that lands while a range runs: the range finishes on the
    # engine it started on, the next one runs on the new engine
    orig = engine_a.generate_range

    def switching(payload, *args, **kwargs):
        backend.load_options("bmodel", "")
        return orig(payload, *args, **kwargs)

    engine_a.generate_range = switching
    assert backend.generate(GenerationPayload(**BODY), 0, 1).images == \
        a1.images
    assert backend.engine is reg.engine and reg.current_name == "bmodel"
    b1 = backend.generate(GenerationPayload(**BODY), 0, 1)
    want_b = reg.engine.generate_range(GenerationPayload(**BODY), 0, 1)
    assert b1.images == want_b.images
    for model, vae in (("nope", ""), ("bmodel", "nope.pt")):
        with pytest.raises(Unsupported):
            backend.load_options(model, vae)
    assert reg.current_name == "bmodel"


# -- a model switch through the server ----------------------------------------

def call(port, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture
def served(model_dir, tmp_path):
    """``cli serve``'s World and registry over a copy of the model
    directory, served on a free port (the master's speed preset in its
    config: benchmarking TINY at 512x512 on the CPU would not fit)."""
    d = mirror(model_dir, str(tmp_path / "models"))
    cfg_path = str(tmp_path / "fleet.json")
    config_mod.save_config(config_mod.ConfigModel(workers=[
        {"master": config_mod.WorkerModel(master=True, avg_ipm=60.0)}]),
        cfg_path)
    args = cli.build_parser().parse_args(
        ["serve", "--model-dir", d, "--device", "cpu",
         "--distributed-config", cfg_path])
    world, registry = cli._build_world(args)
    server = ApiServer(world, registry=registry, port=0).start()
    yield server, world, registry, d
    server.stop()


def generate(port, body):
    status, resp = call(port, "/sdapi/v1/txt2img", body)
    assert status == 200, resp
    info = json.loads(resp["info"])
    return resp["images"], info["all_seeds"], info["infotexts"]


def test_options_switch_matches_jax(served, jax_runs):
    server, world, registry, d = served
    assert registry.current_name == "amodel"  # the first checkpoint
    assert world.master().backend.registry is registry
    status, models = call(server.port, "/sdapi/v1/sd-models")
    assert status == 200
    assert [m["model_name"] for m in models] == ["amodel", "bmodel",
                                                 "nosidecar"]
    assert models[0]["filename"] == os.path.join(d, "amodel.safetensors")
    assert models[0]["hash"] is None and models[0]["sha256"] is None
    old_unet = weakref.ref(registry.engine.unet)

    status, _ = call(server.port, "/sdapi/v1/options",
                     {"sd_model_checkpoint": "bmodel"})
    assert status == 200
    assert registry.current_name == "bmodel"
    assert call(server.port, "/sdapi/v1/options")[1][
        "sd_model_checkpoint"] == "bmodel"
    gc.collect()
    assert old_unet() is None  # the previous engine is gone
    images, seeds, infos = generate(server.port, BODY)
    want = jax_runs["bmodel"]
    assert seeds == want.seeds
    assert infos == [t + ", Worker Label: master" for t in want.infotexts]
    assert all("Model: bmodel" in t for t in infos)
    for a, b in zip(images, want.images):
        assert np.abs(pixels(a) - pixels(b)).max() <= 1


def test_unknown_names_answer_422_and_change_nothing(served):
    server, world, registry, _ = served
    engine = registry.engine
    before = call(server.port, "/sdapi/v1/options")[1]
    for body in ({"sd_model_checkpoint": "nope"},
                 {"sd_vae": "nope.safetensors"},
                 {"sd_model_checkpoint": "bmodel", "sd_vae": "nope"}):
        status, resp = call(server.port, "/sdapi/v1/options", body)
        assert status == 422 and resp["detail"]
    assert call(server.port, "/sdapi/v1/options")[1] == before
    assert registry.engine is engine and registry.current_name == "amodel"
    assert world.current_model == "amodel"


def test_refresh_checkpoints_finds_a_new_file(served):
    server, _, registry, d = served
    write_tiny_checkpoint(d, "cmodel")
    assert "cmodel" not in registry.available()
    assert call(server.port, "/sdapi/v1/refresh-checkpoints", {}) == (200, {})
    names = [m["model_name"] for m in call(server.port,
                                           "/sdapi/v1/sd-models")[1]]
    assert "cmodel" in names
    status, _ = call(server.port, "/sdapi/v1/options",
                     {"sd_model_checkpoint": "cmodel.safetensors"})
    assert status == 200 and registry.current_name == "cmodel.safetensors"
    assert registry.engine.model_name == "cmodel.safetensors"


def test_vae_stays_across_a_switch(served, jax_runs):
    server, _, registry, _ = served
    assert call(server.port, "/sdapi/v1/options",
                {"sd_vae": "alt"})[0] == 200
    a_alt = generate(server.port, BODY)[0]
    for a, b in zip(a_alt, jax_runs["amodel", "alt"].images):
        assert np.abs(pixels(a) - pixels(b)).max() <= 1
    assert call(server.port, "/sdapi/v1/options",
                {"sd_model_checkpoint": "bmodel"})[0] == 200
    assert registry._active_vae == "alt"
    b_alt = generate(server.port, BODY)[0]
    for a, b in zip(b_alt, jax_runs["bmodel", "alt"].images):
        assert np.abs(pixels(a) - pixels(b)).max() <= 1
    assert call(server.port, "/sdapi/v1/options",
                {"sd_vae": "Automatic"})[0] == 200
    b_own = generate(server.port, BODY)[0]
    for a, b in zip(b_own, jax_runs["bmodel"].images):
        assert np.abs(pixels(a) - pixels(b)).max() <= 1


# -- a refiner and a ControlNet named by file ----------------------------------

@pytest.fixture(scope="module")
def xl_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("xl-models"))
    sd = make_ldm_clip_hf(
        JTINY_XL.text_encoder,
        prefix="conditioner.embedders.0.transformer.text_model")
    sd.update(make_ldm_clip_openai(JTINY_XL.text_encoder_2))
    sd.update(make_ldm_unet(JTINY_XL.unet))
    sd.update(make_ldm_vae(JTINY_XL.vae))
    write_ldm(d, "xlbase", sd, "tiny-xl")
    ref = make_ldm_clip_openai(JTINY_REFINER.text_encoder,
                               prefix="conditioner.embedders.0.model")
    ref.update(make_ldm_unet(JTINY_REFINER.unet))
    ref.update(make_ldm_vae(JTINY_REFINER.vae))
    write_ldm(d, "xlref", ref, "tiny-refiner")
    return d


def test_refiner_named_in_the_request(xl_dir, tmp_path):
    body = dict(XL_BODY, refiner_checkpoint="xlref", refiner_switch_at=0.5)
    reg = port_registry(xl_dir)
    got = reg.activate("xlbase").txt2img(GenerationPayload(**body))
    assert list(reg._secondary) == ["xlref"]
    plain = reg.engine.txt2img(GenerationPayload(**XL_BODY))
    assert got.images != plain.images  # the refiner ran
    # the same weights handed over programmatically
    kw = dict(policy=dtypes.F32, state=GenerationState(), device="cpu")
    refiner = Engine(TINY_REFINER, convert.load_checkpoint(
        reg.checkpoint_path("xlref"), TINY_REFINER), model_name="xlref", **kw)
    base = Engine(TINY_XL, convert.load_checkpoint(
        reg.checkpoint_path("xlbase"), TINY_XL), model_name="xlbase",
        engine_provider=lambda n: refiner if n == "xlref" else None, **kw)
    assert base.txt2img(GenerationPayload(**body)).images == got.images
    jreg = jax_registry(mirror(xl_dir, str(tmp_path / "jax")))
    want = jreg.activate("xlbase").txt2img(JaxPayload(**body))
    assert_matches_jax(got, want)
    # the refiner checkpoint activated becomes the primary, not a copy
    promoted = reg._secondary["xlref"]
    assert reg.activate("xlref") is promoted and reg._secondary == {}


def test_controlnet_named_by_its_file(tmp_path):
    from safetensors.numpy import save_file

    d = str(tmp_path)
    write_tiny_checkpoint(d, "m")
    os.makedirs(os.path.join(d, "ControlNet"))
    sd = make_ldm_controlnet(TINY.unet)
    save_file({k: v * 8.0 for k, v in sd.items()},
              os.path.join(d, "ControlNet", "canny-tiny.safetensors"))
    # a bare-layout copy names the same weights
    save_file({k[len("control_model."):]: v * 8.0 for k, v in sd.items()},
              os.path.join(d, "ControlNet", "bare.safetensors"))
    reg = port_registry(d)
    engine = reg.activate("m")
    assert sorted(reg.available_controlnets()) == ["bare", "canny-tiny"]
    hint = np.zeros((32, 32, 3), np.uint8)
    hint[8:24, 8:24] = 255

    def body(model):
        return GenerationPayload(**dict(BODY, alwayson_scripts={
            "controlnet": {"args": [{"image": array_to_b64png(hint),
                                     "module": "canny", "model": model,
                                     "weight": 1.0}]}}))

    got = engine.txt2img(body("canny-tiny"))
    plain = engine.txt2img(GenerationPayload(**BODY))
    assert got.images != plain.images  # the unit ran
    assert engine.txt2img(body("bare")).images == got.images
    cn = convert_controlnet({k: torch.from_numpy(v * 8.0)
                             for k, v in sd.items()}, TINY.unet)
    handed = Engine(TINY, convert.load_checkpoint(reg.checkpoint_path("m"),
                                                  TINY),
                    model_name="m", policy=dtypes.F32,
                    state=GenerationState(), device="cpu",
                    controlnet_provider=lambda n: cn)
    assert handed.txt2img(body("canny-tiny")).images == got.images


# -- the device rule -----------------------------------------------------------

def test_no_device_named_and_no_gpu_raises(model_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    reg = ModelRegistry(model_dir)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        reg.activate("amodel")
    assert reg.engine is None and reg.current_name == ""
    with pytest.raises(KeyError):
        reg.activate("nope")


def test_concurrent_switch_waits_for_the_request(served):
    """A switch posted while a fleet request runs waits for it: the request
    keeps its engine, and no two engines are built at once."""
    server, _, registry, _ = served
    started, release = threading.Event(), threading.Event()
    engine_a = registry.engine
    orig = engine_a.generate_range

    def slow(payload, *args, **kwargs):
        started.set()
        release.wait(30)
        return orig(payload, *args, **kwargs)

    engine_a.generate_range = slow
    out = {}
    t = threading.Thread(target=lambda: out.update(
        r=generate(server.port, BODY)))
    t.start()
    assert started.wait(30)
    switch = threading.Thread(target=lambda: out.update(
        s=call(server.port, "/sdapi/v1/options",
               {"sd_model_checkpoint": "bmodel"})))
    switch.start()
    switch.join(0.5)
    assert switch.is_alive() and registry.current_name == "amodel"
    release.set()
    t.join(60)
    switch.join(60)
    assert out["s"][0] == 200 and registry.current_name == "bmodel"
    assert len(out["r"][0]) == BODY["batch_size"]
