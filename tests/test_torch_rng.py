"""The port's threefry noise against the JAX package's (runtime/rng.py).

Keys and random bits must be exactly JAX's; normals go through XLA's f32
erfinv polynomial copied into torch and must match within 1e-6 absolute
(log1p and the polynomial round differently in the last bit). Sub-range rows
must equal the whole-batch rows exactly inside the port.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stable_diffusion_webui_distributed_tpu.runtime import rng as jrng
from stable_diffusion_webui_distributed_tpu.samplers.kdiffusion import (
    _step_noise,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import rng

NOISE_ATOL = 1e-6


def jax_key_data(keys) -> np.ndarray:
    return np.asarray(jax.random.key_data(keys)).astype(np.int64)


@pytest.mark.parametrize("seed,shape", [(0, (16,)), (7, (4, 5, 3)),
                                        (2**32 - 1, (8, 8, 4))])
def test_threefry_bits_exact(seed, shape):
    want = np.asarray(jax.random.bits(jax.random.key(seed), shape))
    key = torch.tensor([[0, seed]], dtype=torch.int64)  # key(seed) = (0, seed)
    got = rng.random_bits(key, int(np.prod(shape)))[0].numpy()
    np.testing.assert_array_equal(got, want.reshape(-1).astype(np.int64))


@pytest.mark.parametrize("seed,start,batch,pin", [
    (0, 0, 3, False), (1234, 5, 4, False), (2**32 - 2, 0, 4, False),
    (99, 3, 2, True)])
def test_batch_keys_exact(seed, start, batch, pin):
    want = jax_key_data(jrng.batch_keys(seed, start, batch, pin_index=pin))
    got = rng.batch_keys(seed, start, batch, pin_index=pin).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("data", [0, 1, 19, 1_000_000])
def test_fold_in_exact(data):
    keys = jrng.batch_keys(42, 0, 2)
    want = jax_key_data(jax.vmap(lambda k: jax.random.fold_in(k, data))(keys))
    got = rng.fold_in(rng.batch_keys(42, 0, 2), data).numpy()
    np.testing.assert_array_equal(got, want)


NOISE_CASES = {
    "plain": dict(seed=42, subseed=3, subseed_strength=0.0, start_index=0,
                  batch_size=3, shape=(8, 8, 4)),
    "offset": dict(seed=42, subseed=3, subseed_strength=0.0, start_index=5,
                   batch_size=2, shape=(16, 8, 4)),
    "uint32-wrap": dict(seed=2**32 - 2, subseed=0, subseed_strength=0.0,
                        start_index=0, batch_size=4, shape=(64, 64, 4)),
    "subseed-slerp": dict(seed=42, subseed=3, subseed_strength=0.3,
                          start_index=2, batch_size=2, shape=(8, 8, 4)),
    "seed-resize-up": dict(seed=9, subseed=3, subseed_strength=0.0,
                           start_index=1, batch_size=2, shape=(8, 8, 4),
                           seed_resize=(6, 10)),
    "seed-resize-down": dict(seed=9, subseed=3, subseed_strength=0.5,
                             start_index=0, batch_size=1, shape=(6, 6, 4),
                             seed_resize=(8, 4)),
    "pin-index": dict(seed=9, subseed=3, subseed_strength=0.5, start_index=1,
                      batch_size=3, shape=(8, 8, 4), pin_index=True),
}


@pytest.mark.parametrize("case", sorted(NOISE_CASES))
def test_batch_noise_matches_jax(case):
    args = NOISE_CASES[case]
    want = np.asarray(jrng.batch_noise(**args))
    got = rng.batch_noise(**args).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=NOISE_ATOL)


@pytest.mark.parametrize("step", [0, 5, 19])
def test_step_noise_matches_jax(step):
    shape = (2, 16, 16, 4)
    want = np.asarray(_step_noise(jrng.batch_keys(77, 3, 2), jnp.int32(step),
                                  shape, jnp.float32))
    got = rng.step_noise(rng.batch_keys(77, 3, 2), step, shape[1:]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=NOISE_ATOL)


def test_normals_over_many_draws():
    """20 keys x 16384 draws: the XLA erfinv copy holds 1e-6 everywhere,
    including the tails past w = 5."""
    keys = jrng.batch_keys(123, 0, 20)
    want = np.asarray(jax.vmap(
        lambda k: jax.random.normal(k, (16384,), jnp.float32))(keys))
    got = rng.normal(rng.batch_keys(123, 0, 20), (16384,)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=NOISE_ATOL)
    assert (got == want).mean() > 0.9


@pytest.mark.parametrize("strength", [0.0, 0.4])
def test_subrange_rows_equal_whole_batch(strength):
    whole = rng.batch_noise(5, 8, strength, 0, 5, (8, 8, 4))
    part = rng.batch_noise(5, 8, strength, 2, 2, (8, 8, 4))
    assert torch.equal(whole[2:4], part)
    keys = rng.batch_keys(5, 0, 5)
    assert torch.equal(keys[3:4], rng.batch_keys(5, 3, 1))
    assert torch.equal(rng.step_noise(keys, 4, (8, 8, 4))[3:4],
                       rng.step_noise(rng.batch_keys(5, 3, 1), 4, (8, 8, 4)))
