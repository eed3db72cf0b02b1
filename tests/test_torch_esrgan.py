"""The port's RRDBNet upscalers, resize kernels and upscaler registry
against the JAX package's.

``RRDBNet`` runs the weights of ``make_rrdb_sd`` (tiny nf/gc/nb, both key
layouts) against ``rrdbnet_apply`` on the JAX package's converted tree,
through ``bridge.esrgan_flax_to_torch`` and through the port's own
``convert_esrgan``; ``make_upscaler`` hits a fractional target as the JAX
one does; each resize kernel's weights equal ``jax.image.resize``'s; the
registry resolves webui's display names as the JAX registry does and reads
``.safetensors`` and ``.pth`` files. Entry points named no device raise
when no GPU is present.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from safetensors.numpy import save_file

from stable_diffusion_webui_distributed_tpu.models import esrgan as jesrgan
from stable_diffusion_webui_distributed_tpu.pipeline import (
    engine as jengine,
)
from stable_diffusion_webui_distributed_tpu_torch import bridge
from stable_diffusion_webui_distributed_tpu_torch.models import esrgan
from stable_diffusion_webui_distributed_tpu_torch.pipeline import image
from stable_diffusion_webui_distributed_tpu_torch.pipeline.registry import (
    ModelRegistry,
)
from test_esrgan import make_rrdb_sd

ATOL = 1e-4  # RRDBNet against rrdbnet_apply
WEIGHT_ATOL = 1e-5  # resize weights against jax.image.resize's


def _sd(seed, old_arch=False):
    """``make_rrdb_sd`` drawn from its own seed (the JAX tests' module
    generator is put back afterwards)."""
    import test_esrgan

    saved, test_esrgan.RNG = test_esrgan.RNG, np.random.default_rng(seed)
    try:
        return make_rrdb_sd(old_arch=old_arch)
    finally:
        test_esrgan.RNG = saved


def _img(shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("old_arch", [False, True], ids=["new", "old"])
@pytest.mark.parametrize("route", ["bridge", "convert"])
def test_rrdbnet_matches_rrdbnet_apply(old_arch, route):
    sd = _sd(3, old_arch)
    tree = jax.device_get(jesrgan.convert_esrgan(sd))
    img = _img((2, 8, 6, 3))
    want = np.asarray(jesrgan.rrdbnet_apply(tree, img))
    port_sd = (bridge.esrgan_flax_to_torch(tree) if route == "bridge"
               else esrgan.convert_esrgan(sd))
    model = esrgan.esrgan_module(port_sd, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(img)).numpy()
    assert got.shape == (2, 32, 24, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_both_layouts_give_the_same_network():
    img = torch.from_numpy(_img((1, 6, 6, 3)))
    new = esrgan.esrgan_module(esrgan.convert_esrgan(_sd(5)), device="cpu")
    old = esrgan.esrgan_module(esrgan.convert_esrgan(_sd(5, True)),
                               device="cpu")
    with torch.no_grad():
        assert torch.equal(new(img), old(img))


def test_pixel_unshuffle_input_rejected():
    sd = _sd(1)
    sd["conv_first.weight"] = np.zeros((8, 12, 3, 3), np.float32)
    with pytest.raises(ValueError, match="12 channels"):
        esrgan.convert_esrgan(sd)


def test_upscaler_hits_exact_fractional_target():
    sd = _sd(7)
    img = _img((2, 8, 8, 3), 1)
    want = np.asarray(jesrgan.make_upscaler(jesrgan.convert_esrgan(sd))(
        img, 20, 12))
    up = esrgan.make_upscaler(esrgan.esrgan_module(esrgan.convert_esrgan(sd),
                                                   device="cpu"))
    got = up(torch.from_numpy(img), 20, 12).numpy()
    assert got.shape == (2, 12, 20, 3)
    assert got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert np.array_equal(up(torch.from_numpy(img), 20, 12).numpy(), got)


def test_upscaler_applies_the_model_until_the_target():
    """A x16 target takes the x4 model twice and no resize."""
    model = esrgan.esrgan_module(esrgan.convert_esrgan(_sd(2)), device="cpu")
    img = torch.from_numpy(_img((1, 2, 2, 3), 2))
    got = esrgan.make_upscaler(model)(img, 32, 32)
    with torch.no_grad():
        twice = torch.clamp(model(torch.clamp(model(img), 0, 1)), 0, 1)
    assert torch.equal(got, twice)


def test_pth_file_loads_like_safetensors(tmp_path):
    sd = _sd(9)
    st = tmp_path / "a.safetensors"
    save_file(sd, str(st))
    pth = tmp_path / "b.pth"
    torch.save({"params_ema": {k: torch.from_numpy(v) for k, v in sd.items()}},
               str(pth))
    a = esrgan.load_esrgan(str(st), device="cpu")
    b = esrgan.load_esrgan(str(pth), device="cpu")
    img = torch.from_numpy(_img((1, 4, 4, 3), 3))
    with torch.no_grad():
        assert torch.equal(a(img), b(img))


def test_load_without_device_raises_when_no_gpu(tmp_path, monkeypatch):
    path = tmp_path / "a.safetensors"
    save_file(_sd(4), str(path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        esrgan.load_esrgan(str(path))
    os.makedirs(tmp_path / "models" / "ESRGAN")
    save_file(_sd(4), str(tmp_path / "models" / "ESRGAN" / "x.safetensors"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelRegistry(str(tmp_path / "models")).upscaler_provider("x")


# -- the registry's upscaler half ----------------------------------------------

def test_registry_resolves_display_names(tmp_path):
    """The JAX package's cases (``tests/test_esrgan.py``): a display name
    finds its file, an unknown one nothing, and an exact canonical match
    beats containment."""
    model_dir = tmp_path / "models"
    os.makedirs(model_dir / "ESRGAN")
    save_file(_sd(1), str(model_dir / "ESRGAN" / "Tiny_x4plus.safetensors"))
    reg = ModelRegistry(str(model_dir), device="cpu")
    assert list(reg.available_upscalers()) == ["Tiny_x4plus"]
    assert reg.upscaler_provider("tiny x4plus") is not None
    assert reg.upscaler_provider("No Such Upscaler") is None
    assert reg.upscaler_provider("") is None

    save_file(_sd(1), str(model_dir / "ESRGAN"
                          / "Tiny_x4plus_anime_6B.safetensors"))
    reg2 = ModelRegistry(str(model_dir), device="cpu")
    want = reg2.available_upscalers()["Tiny_x4plus_anime_6B"]
    assert reg2._resolve_upscaler_path("Tiny 4x+ Anime6B") == want
    assert reg2._resolve_upscaler_path("tiny x4plus") == \
        reg2.available_upscalers()["Tiny_x4plus"]


def test_registry_scans_every_upscaler_directory(tmp_path):
    model_dir = tmp_path / "models"
    for sub in ("ESRGAN", "RealESRGAN", "upscalers", "Lora"):
        os.makedirs(model_dir / sub)
    save_file(_sd(1), str(model_dir / "ESRGAN" / "a.safetensors"))
    save_file(_sd(1), str(model_dir / "RealESRGAN" / "RealESRGAN_x4plus"
                          ".safetensors"))
    torch.save({k: torch.from_numpy(v) for k, v in _sd(1).items()},
               str(model_dir / "upscalers" / "c.pth"))
    (model_dir / "upscalers" / "notes.txt").write_text("not a model")
    reg = ModelRegistry(str(model_dir), device="cpu")
    assert sorted(reg.available_upscalers()) == ["RealESRGAN_x4plus", "a",
                                                 "c"]
    # webui's display name of RealESRGAN_x4plus
    assert reg._resolve_upscaler_path("R-ESRGAN 4x+") == \
        reg.available_upscalers()["RealESRGAN_x4plus"]
    assert reg.upscaler_provider("c") is not None


def test_refresh_loras_rescans_the_upscalers(tmp_path):
    """``POST /sdapi/v1/refresh-loras`` rescans through ``refresh()``, as
    the JAX package's one ``handle_refresh`` does: a file added since the
    registry was made resolves afterwards."""
    from test_torch_hires import call

    from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
        TINY,
    )
    from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import (
        Engine,
    )
    from stable_diffusion_webui_distributed_tpu_torch.server.api import (
        ApiServer,
    )

    model_dir = tmp_path / "models"
    os.makedirs(model_dir / "ESRGAN")
    reg = ModelRegistry(str(model_dir), device="cpu")
    engine = Engine(TINY, bridge.init_seeded(TINY, 0, device="cpu"),
                    device="cpu", upscaler_provider=reg.upscaler_provider)
    save_file(_sd(1), str(model_dir / "ESRGAN" / "late.safetensors"))
    assert reg.upscaler_provider("late") is None
    server = ApiServer(engine, port=0, registry=reg).start()
    try:
        status, _ = call(server.port, "/sdapi/v1/refresh-loras", {})
    finally:
        server.stop()
    assert status == 200
    assert list(reg.available_upscalers()) == ["late"]
    assert reg.upscaler_provider("late") is not None


def test_registry_caches_per_name_until_refresh(tmp_path, caplog):
    model_dir = tmp_path / "models"
    os.makedirs(model_dir / "ESRGAN")
    save_file(_sd(1), str(model_dir / "ESRGAN" / "good.safetensors"))
    (model_dir / "ESRGAN" / "bad.safetensors").write_bytes(b"\0" * 16)
    reg = ModelRegistry(str(model_dir), device="cpu")
    first = reg.upscaler_provider("good")
    assert reg.upscaler_provider("good") is first
    # a file that fails to load is logged and gives None (latent fallback)
    assert reg.upscaler_provider("bad") is None
    assert any("failed to load" in r.getMessage() for r in caplog.records)
    reg.refresh()
    assert reg.upscaler_provider("good") is not first


# -- the resize kernels ----------------------------------------------------------

METHODS = ("linear", "cubic", "lanczos3", "nearest")
SIZES = {"up": (16, 32), "down": (32, 16), "fractional-up": (8, 12),
         "fractional-down": (12, 5), "x8/3": (48, 128)}
WEIGHT_CASES = [(m, *SIZES[s]) for m in METHODS for s in SIZES] + [
    # the ESRGAN path's shrink at config #5: 4096 -> 2048, lanczos3
    ("lanczos3", 4096, 2048)]


@pytest.mark.parametrize("method,src,dst", WEIGHT_CASES,
                         ids=[f"{m}-{a}-{b}" for m, a, b in WEIGHT_CASES])
def test_resize_weights_match_jax(method, src, dst):
    """Row i of ``jax.image.resize(eye(src), (src, dst))`` is source sample
    i's weight in each output sample."""
    want = np.asarray(jax.image.resize(jnp.eye(src, dtype=jnp.float32),
                                       (src, dst), method))
    got = image.weights(src, dst, method)
    assert got.shape == (src, dst) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=WEIGHT_ATOL)


@pytest.mark.parametrize("method", METHODS)
def test_resize_matches_jax_on_both_sides(method):
    img = np.random.default_rng(4).standard_normal((2, 8, 8, 4)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(img), (2, 13, 10, 4),
                                       method))
    np.testing.assert_allclose(image.resize(img, (2, 13, 10, 4), method),
                               want, rtol=0, atol=WEIGHT_ATOL)
    got = image.resize_device(torch.from_numpy(img), 13, 10, method)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=WEIGHT_ATOL)


@pytest.mark.parametrize("name", [None, "Latent", "Latent (antialiased)",
                                  "Latent (nearest)",
                                  "Latent (nearest-exact)",
                                  "Latent (bicubic)", "R-ESRGAN 4x+",
                                  "Lanczos"])
def test_latent_resize_method_matches_jax(name):
    assert image.latent_resize_method(name) == \
        jengine._latent_resize_method(name)
