"""The port's sampler layer against the JAX package's, on the CPU.

Sigma ladders and the sigma-to-timestep map of every sampler the port runs,
and a few Euler / Euler a steps over a fixed toy denoiser, must match the JAX
package within 1e-6 (f32 on both sides; the ancestral noise is the threefry
noise of ``runtime/rng.py``). Samplers the JAX package has and the port does
not yet run must raise, never fall back to another sampler.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stable_diffusion_webui_distributed_tpu.runtime import rng as jrng
from stable_diffusion_webui_distributed_tpu.samplers import kdiffusion as jkd
from stable_diffusion_webui_distributed_tpu.samplers import schedules as jsched
from stable_diffusion_webui_distributed_tpu_torch.runtime import rng
from stable_diffusion_webui_distributed_tpu_torch.samplers import kdiffusion as kd
from stable_diffusion_webui_distributed_tpu_torch.samplers import schedules

ATOL = 1e-6
PORTED = ["Euler a", "Euler", "DDIM", "Euler a Karras", "Euler Karras"]


def test_ported_sampler_names():
    assert kd.ported_sampler_names() == PORTED


@pytest.mark.parametrize("name", PORTED)
@pytest.mark.parametrize("steps", [1, 7, 20])
def test_sigma_ladder_matches_jax(name, steps):
    want = np.asarray(jkd.build_sigmas(jkd.resolve_sampler(name),
                                       jsched.sd_schedule(), steps))
    got = kd.build_sigmas(kd.resolve_sampler(name), schedules.sd_schedule(),
                          steps).numpy()
    assert got.dtype == np.float32 and got.shape == (steps + 1,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=ATOL)


def test_sigma_to_t_matches_jax():
    sigmas = np.array([14.61, 7.0, 1.0, 0.5, 0.0292, 1e-4], np.float32)
    want = np.asarray(jsched.sd_schedule().sigma_to_t(jnp.asarray(sigmas)))
    got = schedules.sd_schedule().sigma_to_t(torch.from_numpy(sigmas))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("name", ["Euler a", "Euler"])
def test_steps_match_jax(name):
    steps, shape = 5, (2, 8, 8, 4)
    x0 = np.random.default_rng(2).standard_normal(shape).astype(np.float32)

    jspec = jkd.resolve_sampler(name)
    jsig = jkd.build_sigmas(jspec, jsched.sd_schedule(), steps)
    jstep = jkd.make_sampler_step(jspec, lambda x, s, i: x * 0.3 - 0.1, jsig,
                                  jrng.batch_keys(31, 4, 2))
    jcarry = jkd.init_carry(jnp.asarray(x0) * jsig[0])

    spec = kd.resolve_sampler(name)
    sig = kd.build_sigmas(spec, schedules.sd_schedule(), steps)
    step = kd.make_sampler_step(spec, lambda x, s, i: x * 0.3 - 0.1, sig,
                                rng.batch_keys(31, 4, 2))
    carry = kd.init_carry(torch.from_numpy(x0) * sig[0])
    for i in range(steps):
        jcarry, _ = jstep(jcarry, jnp.int32(i))
        carry = step(carry, i)
        np.testing.assert_allclose(carry.x.numpy(), np.asarray(jcarry.x),
                                   rtol=1e-5, atol=1e-5)


def test_unknown_name_falls_back_to_euler_a_as_in_jax():
    assert kd.resolve_sampler("no such sampler") == kd.SAMPLERS["Euler a"]
    assert jkd.resolve_sampler("no such sampler").algorithm == "euler_a"


@pytest.mark.parametrize("name", sorted(set(kd.SAMPLERS) - set(PORTED)))
def test_unported_samplers_raise(name):
    with pytest.raises(kd.SamplerNotPorted):
        kd.resolve_sampler(name)
