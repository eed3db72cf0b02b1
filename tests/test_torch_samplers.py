"""The port's sampler layer against the JAX package's, on the CPU.

Sigma ladders and the sigma-to-timestep map of every sampler name must
match the JAX package within 1e-6 (f32 on both sides). Every step algorithm
runs six steps (PLMS reaches order 4) over one analytic denoiser, written
once in numpy and wrapped for each side, with the same image keys: the
latents must agree within 1e-5 after every step (the ancestral noise is the
threefry noise of ``runtime/rng.py``), and each step must evaluate the
denoiser as often as the JAX step does. DPM adaptive's PID controller must
match exactly, one attempt's ``(x_low, x_high, error)`` within 1e-5, and a
whole adaptive run must take the same attempts.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stable_diffusion_webui_distributed_tpu.runtime import rng as jrng
from stable_diffusion_webui_distributed_tpu.samplers import kdiffusion as jkd
from stable_diffusion_webui_distributed_tpu.samplers import schedules as jsched
from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import (
    check_supported,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
    Unsupported,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import rng
from stable_diffusion_webui_distributed_tpu_torch.samplers import kdiffusion as kd
from stable_diffusion_webui_distributed_tpu_torch.samplers import schedules

ATOL = 1e-6
NAMES = list(jkd.SAMPLERS)
# the samplers the first slice ran; the others arrived with DPM adaptive
FIRST_SLICE = ["Euler a", "Euler", "DDIM", "Euler a Karras", "Euler Karras"]


def test_ported_sampler_names():
    assert list(kd.SAMPLERS) == NAMES
    assert len(NAMES) == 18
    for name in NAMES:
        assert dataclass_fields(kd.resolve_sampler(name)) \
            == dataclass_fields(jkd.resolve_sampler(name))


def dataclass_fields(spec):
    return (spec.algorithm, spec.schedule, spec.ancestral,
            spec.evals_per_step, spec.adaptive)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("steps", [1, 2, 7, 20])
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


def analytic_denoiser(x, sigma, step):
    """An x0 prediction that depends on x, sigma and the step, in numpy
    f32: the same function behind both packages' steps."""
    x = np.asarray(x, np.float32)
    s = np.float32(sigma)
    out = np.tanh(x) * np.float32(0.8) / (np.float32(1.0)
                                          + np.float32(0.05) * s) \
        + np.float32(0.02) * np.sin(x * s) \
        + np.float32(0.003) * np.float32(step)
    return out.astype(np.float32)


class Counted:
    """Both packages' wrappers of :func:`analytic_denoiser`; ``calls``
    counts evaluations that ran (JAX traces both sides of a ``cond`` but
    runs one)."""

    def __init__(self):
        self.calls = 0

    def _np(self, x, sigma, step):
        self.calls += 1
        return analytic_denoiser(x, sigma, step)

    def jax_fn(self, x, sigma, step):
        return jax.pure_callback(
            self._np, jax.ShapeDtypeStruct(x.shape, jnp.float32), x,
            jnp.asarray(sigma, jnp.float32), jnp.asarray(step, jnp.int32))

    def torch_fn(self, x, sigma, step):
        return torch.from_numpy(self._np(x.numpy(), sigma.numpy(), step))


STEP_COUNT = 6
SHAPE = (2, 8, 8, 4)


@pytest.mark.parametrize("name", NAMES)
def test_steps_match_jax(name):
    x0 = np.random.default_rng(2).standard_normal(SHAPE).astype(np.float32)
    jden, tden = Counted(), Counted()

    jspec = jkd.resolve_sampler(name)
    jsig = jkd.build_sigmas(jspec, jsched.sd_schedule(), STEP_COUNT)
    jstep = jkd.make_sampler_step(jspec, jden.jax_fn, jsig,
                                  jrng.batch_keys(31, 4, 2))
    jcarry = jkd.init_carry(jnp.asarray(x0) * jsig[0])

    spec = kd.resolve_sampler(name)
    sig = kd.build_sigmas(spec, schedules.sd_schedule(), STEP_COUNT)
    step = kd.make_sampler_step(spec, tden.torch_fn, sig,
                                rng.batch_keys(31, 4, 2))
    carry = kd.init_carry(torch.from_numpy(x0) * sig[0])
    for i in range(STEP_COUNT):
        jcarry, _ = jstep(jcarry, jnp.int32(i))
        jax.block_until_ready(jcarry)
        carry = step(carry, i)
        np.testing.assert_allclose(carry.x.numpy(), np.asarray(jcarry.x),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(carry.old_denoised.numpy(),
                                   np.asarray(jcarry.old_denoised),
                                   rtol=1e-5, atol=1e-5)
        assert carry.n_hist == int(jcarry.n_hist) == i + 1
        assert tden.calls == jden.calls, f"step {i}"
    assert np.isfinite(carry.x.numpy()).all()


def test_unknown_name_falls_back_to_euler_a_as_in_jax():
    assert kd.resolve_sampler("no such sampler") == kd.SAMPLERS["Euler a"]
    assert jkd.resolve_sampler("no such sampler").algorithm == "euler_a"
    assert kd.resolve_sampler("LMS Karras").schedule == "karras"


@pytest.mark.parametrize("name", sorted(set(kd.SAMPLERS) - set(FIRST_SLICE)))
def test_unported_samplers_raise(name):
    """Every sampler runs now; what the port still does not run raises
    whatever the sampler, and is never answered by another path."""
    check_supported(GenerationPayload(prompt="a cow", sampler_name=name))
    with pytest.raises(Unsupported, match="step cache"):
        check_supported(GenerationPayload(
            prompt="a cow", sampler_name=name,
            override_settings={"deepcache": 2}))


# -- DPM adaptive -------------------------------------------------------------

def test_pid_controller_matches_jax_exactly():
    errors = np.random.default_rng(5).uniform(0.05, 3.0, 200)
    errors[::17] = 0.0
    for coeffs in [(0.0, 1.0, 0.0), (0.3, 0.7, 0.1)]:
        j = jkd.PIDStepController(0.05, *coeffs, 3, 0.81)
        t = kd.PIDStepController(0.05, *coeffs, 3, 0.81)
        for e in errors:
            assert t.propose_step(float(e)) == j.propose_step(float(e))
            assert t.h == j.h and t.errs == j.errs


@pytest.mark.parametrize("s,h", [(-2.68, 0.05), (-0.5, 0.4), (1.9, 1.3)])
def test_adaptive_attempt_matches_jax(s, h):
    g = np.random.default_rng(9)
    x = (g.standard_normal(SHAPE) * np.exp(-s)).astype(np.float32)
    x_prev = (x + g.standard_normal(SHAPE).astype(np.float32) * 0.1)
    jden, tden = Counted(), Counted()
    want = jkd.make_adaptive_attempt(jden.jax_fn)(
        jnp.asarray(x), jnp.asarray(x_prev), jnp.float32(s), jnp.float32(h),
        jnp.float32(0.05), jnp.float32(0.0078))
    got = kd.make_adaptive_attempt(tden.torch_fn)(
        torch.from_numpy(x), torch.from_numpy(x_prev), kd._f32(s),
        kd._f32(h), kd._f32(0.05), kd._f32(0.0078))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    assert tden.calls == jden.calls == 3


@pytest.mark.parametrize("kw,rejects", [
    ({}, False),
    ({"h_init": 2.0, "rtol": 0.002, "atol": 0.0002}, True),
])
def test_adaptive_run_takes_the_jax_attempts(kw, rejects):
    sched = schedules.sd_schedule()
    x = np.random.default_rng(4).standard_normal(SHAPE).astype(np.float32)
    x = x * np.float32(sched.sigma_max)
    jinfo_x, jinfo = jkd.sample_dpm_adaptive(
        jkd.make_adaptive_attempt(Counted().jax_fn), jnp.asarray(x),
        sched.sigma_max, sched.sigma_min, **kw)
    accepted = []
    got_x, info = kd.sample_dpm_adaptive(
        kd.make_adaptive_attempt(Counted().torch_fn), torch.from_numpy(x),
        sched.sigma_max, sched.sigma_min,
        on_accept=lambda xx, sigma, n: accepted.append(n) or xx, **kw)
    assert info == jinfo and info["completed"]
    assert accepted == list(range(1, info["n_accept"] + 1))
    # a large first step is rejected and retried smaller
    assert (info["n_reject"] > 0) == rejects
    np.testing.assert_allclose(got_x.numpy(), np.asarray(jinfo_x),
                               rtol=1e-4, atol=1e-4)
