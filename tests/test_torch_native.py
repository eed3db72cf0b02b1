"""The port's native PNG encoder (``runtime/native.py`` and its own
``native/png_encoder.cpp``) against the JAX package's, on the CPU.

- RGB and RGBA arrays of several sizes: the port's ``encode_png`` gives
  the JAX ``native.encode_png`` bytes exactly (both built with ``g++`` and
  zlib), at each compression level, and PIL decodes them to the input;
- ``None`` for what is not an (H, W, 3|4) uint8 array;
- ``pipeline/payload.py`` ``array_to_b64png`` goes through the native
  encoder (its bytes, counted) and round-trips through ``b64png_to_array``;
- the library is named by the hash of its source, flags and compiler, in
  ``_build/``; where it cannot be built, ``encode_png`` returns None, the
  compiler's error is logged once at warning level, and the payload
  helper falls back to PIL and counts the fallback.
"""

import base64
import io
import logging

import numpy as np
import pytest
from PIL import Image

from stable_diffusion_webui_distributed_tpu.runtime import (
    native as jax_native,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    array_to_b64png,
    b64png_to_array,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import native

RNG = np.random.default_rng(11)


@pytest.mark.parametrize("shape", [(48, 64, 3), (16, 16, 4), (1, 1, 3),
                                   (97, 33, 4), (512, 512, 3)])
def test_bytes_match_jax(shape):
    img = RNG.integers(0, 256, shape, np.uint8)
    data = native.encode_png(img)
    assert data is not None
    assert data == jax_native.encode_png(img)
    decoded = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(decoded, img)


@pytest.mark.parametrize("level", [0, 1, 9])
def test_compression_levels_match_jax(level):
    img = (np.arange(64 * 80 * 3) % 251).astype(np.uint8).reshape(64, 80, 3)
    data = native.encode_png(img, compression_level=level)
    assert data == jax_native.encode_png(img, compression_level=level)
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(data))), img)


def test_non_contiguous_input():
    img = RNG.integers(0, 256, (32, 64, 3), np.uint8)[:, ::2]
    data = native.encode_png(img)
    assert data == jax_native.encode_png(img)
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(data))), img)


@pytest.mark.parametrize("img", [
    np.zeros((4, 4), np.uint8),
    np.zeros((4, 4, 3), np.float32),
    np.zeros((4, 4, 2), np.uint8),
    np.zeros((2, 4, 4, 3), np.uint8),
], ids=["2d", "float", "two_channels", "4d"])
def test_invalid_inputs_return_none(img):
    assert native.encode_png(img) is None
    assert jax_native.encode_png(img) is None


def test_payload_helper_goes_native_and_round_trips():
    img = RNG.integers(0, 256, (32, 32, 3), np.uint8)
    before = native.stats()
    b64 = array_to_b64png(img)
    after = native.stats()
    assert base64.b64decode(b64) == native.encode_png(img)
    assert after["native"] == before["native"] + 1
    assert after["fallback"] == before["fallback"]
    np.testing.assert_array_equal(b64png_to_array(b64), img)
    # a grayscale mask is not the encoder's: PIL, counted
    mask = (RNG.random((8, 8)) > 0.5).astype(np.uint8) * 255
    np.testing.assert_array_equal(
        b64png_to_array(array_to_b64png(mask))[..., 0], mask)
    assert native.stats()["fallback"] == after["fallback"] + 1


def test_library_named_by_source_flags_and_compiler(monkeypatch):
    path = native.library_path()
    assert path.parent == native.BUILD_DIR
    assert path.name.startswith("png_encoder-") and path.suffix == ".so"
    assert native.available() and path.exists()
    monkeypatch.setattr(native, "_FLAGS", ("-O2", "-shared", "-fPIC"))
    assert native.library_path() != path
    monkeypatch.undo()
    monkeypatch.setattr(native, "gxx_version", lambda: "another g++")
    assert native.library_path() != path


def test_unbuildable_encoder_warns_once_and_falls_back(monkeypatch, tmp_path,
                                                      caplog):
    bad = tmp_path / "png_encoder.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_failed", False)
    img = RNG.integers(0, 256, (8, 8, 3), np.uint8)
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        assert native.encode_png(img) is None
        assert native.encode_png(img) is None
        before = native.stats()["fallback"]
        b64 = array_to_b64png(img)
    warnings = [r for r in caplog.records if r.levelno == logging.WARNING
                and r.name == native.__name__]
    assert len(warnings) == 1
    assert "g++ failed" in warnings[0].getMessage()
    assert not native.available()
    assert native.stats()["fallback"] == before + 1
    np.testing.assert_array_equal(b64png_to_array(b64), img)
    assert not list((tmp_path / "_build").glob("*.so"))
