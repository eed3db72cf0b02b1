"""Weights across the packages: ``bridge.flax_to_torch`` and
``bridge.init_seeded``.

The Flax tree that ``test_pipeline.init_params`` builds must load into the
port's CLIP, UNet and VAE decoder and encoder with ``strict=True``, with each tensor in
the port's layout. ``init_seeded`` must give the same names and shapes, drawn
with the statistics of Flax's default initialisers.
"""

import math

import numpy as np
import pytest
import torch

import jax

from stable_diffusion_webui_distributed_tpu.models.configs import TINY as JTINY
from stable_diffusion_webui_distributed_tpu_torch import bridge
from stable_diffusion_webui_distributed_tpu_torch.models.configs import TINY
from test_pipeline import init_params


@pytest.fixture(scope="module")
def flax_params():
    return jax.device_get(jax.jit(init_params, static_argnums=0)(JTINY))


@pytest.fixture(scope="module")
def converted(flax_params):
    return bridge.flax_to_torch(TINY, flax_params)


@pytest.fixture(scope="module")
def seeded():
    return bridge.init_seeded(TINY, seed=0, device="cpu")


@pytest.mark.parametrize("component", ["text_encoder", "unet", "vae",
                                       "vae_encoder"])
def test_flax_tree_loads_strict(converted, component):
    module = bridge.build_modules(TINY)[component]
    missing, unexpected = module.load_state_dict(converted[component],
                                                 strict=True)
    assert not missing and not unexpected


def test_layouts_transposed(flax_params, converted):
    unet = flax_params["unet"]
    dense = np.asarray(unet["down_0_attn_0"]["block_0"]["attn1"]["qkv"]
                       ["kernel"])
    conv = np.asarray(unet["conv_in"]["kernel"])
    sd = converted["unet"]
    np.testing.assert_array_equal(
        sd["down_0_attn_0.block_0.attn1.qkv.weight"].numpy(), dense.T)
    np.testing.assert_array_equal(sd["conv_in.weight"].numpy(),
                                  conv.transpose(3, 2, 0, 1))
    gn = np.asarray(unet["down_0_res_0"]["norm1"]["gn"]["scale"])
    np.testing.assert_array_equal(sd["down_0_res_0.norm1.gn.weight"].numpy(),
                                  gn)


@pytest.mark.parametrize("component", ["text_encoder", "unet", "vae",
                                       "vae_encoder"])
def test_seeded_names_and_shapes(converted, seeded, component):
    want = {n: tuple(t.shape) for n, t in converted[component].items()}
    got = {n: tuple(t.shape) for n, t in seeded[component].items()}
    assert got == want
    assert all(t.dtype == torch.float32 for t in seeded[component].values())


def test_seeded_is_reproducible():
    a = bridge.init_seeded(TINY, seed=3, device="cpu")["unet"]
    b = bridge.init_seeded(TINY, seed=3, device="cpu")["unet"]
    c = bridge.init_seeded(TINY, seed=4, device="cpu")["unet"]
    name = "down_0_res_0.conv1.weight"
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a[name], c[name])


def _std_ratio(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.std(a) / np.std(b))


def test_seeded_statistics_match_flax(converted, seeded):
    """Each family of tensors is drawn as Flax draws it: zero biases, unit
    norm scales, lecun-normal kernels (std 1/sqrt(fan_in), truncated at two
    standard deviations), the token embedding at 1/sqrt(width) and the
    position embedding at 0.01. Per-tensor std within 15% wherever a tensor
    holds enough values to say so."""
    checked = 0
    for comp in ("text_encoder", "unet", "vae", "vae_encoder"):
        for name, flax_t in converted[comp].items():
            ours = seeded[comp][name].numpy()
            theirs = flax_t.numpy()
            if name.endswith("bias"):
                assert not ours.any(), name
                continue
            if np.all(theirs == 1.0):  # a norm scale
                assert np.all(ours == 1.0), name
                continue
            if ours.size >= 2048:
                assert abs(_std_ratio(ours, theirs) - 1.0) < 0.15, name
                if ours.ndim >= 2 and "embedding" not in name:
                    fan_in = math.prod(ours.shape[1:])
                    assert np.abs(ours).max() <= 2.0 / math.sqrt(fan_in) \
                        / 0.8796 + 1e-6, name
                checked += 1
    assert checked > 20
