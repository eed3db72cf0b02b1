"""k-diffusion samplers as step functions.

Port of the JAX package's ``samplers/kdiffusion.py`` for ``euler`` and
``euler_a``. A sampler step is ``(carry, step_index) -> carry``; the engine
runs steps in a Python loop of chunks. Ancestral noise is keyed per image and
per step (``fold_in(image_key, step)``, ``runtime/rng.py``), never by batch
position, so a sub-batch reproduces the rows of the whole batch.

The sampler table is the JAX package's. A sampler there that the port does
not run yet raises :class:`SamplerNotPorted` (HTTP 422); it never falls back
to Euler a and returns a different image. Names unknown to both fall back to
Euler a, as the JAX package's ``resolve_sampler`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple

import torch

from stable_diffusion_webui_distributed_tpu_torch.runtime import rng
from stable_diffusion_webui_distributed_tpu_torch.samplers import (
    schedules as sched,
)

# denoise_fn(x, sigma, step_index) -> denoised x0 prediction, same shape as x
DenoiseFn = Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    """A named sampler = step algorithm + sigma schedule + stochasticity."""

    algorithm: str
    schedule: str = "default"  # key into schedules.SCHEDULES
    ancestral: bool = False
    evals_per_step: int = 1
    adaptive: bool = False


SAMPLERS = {
    "Euler a": SamplerSpec("euler_a", ancestral=True),
    "Euler": SamplerSpec("euler"),
    "Heun": SamplerSpec("heun", evals_per_step=2),
    "DDIM": SamplerSpec("euler", schedule="ddim"),
    "LMS": SamplerSpec("lms"),
    "DPM2": SamplerSpec("dpm2", evals_per_step=2),
    "DPM2 a": SamplerSpec("dpm2_a", ancestral=True, evals_per_step=2),
    "DPM++ 2M": SamplerSpec("dpmpp_2m"),
    "DPM++ 2M Karras": SamplerSpec("dpmpp_2m", schedule="karras"),
    "DPM++ 2S a": SamplerSpec("dpmpp_2s_a", ancestral=True,
                              evals_per_step=2),
    "DPM++ 2S a Karras": SamplerSpec("dpmpp_2s_a", schedule="karras",
                                     ancestral=True, evals_per_step=2),
    "DPM++ SDE": SamplerSpec("dpmpp_sde", ancestral=True, evals_per_step=2),
    "DPM++ SDE Karras": SamplerSpec("dpmpp_sde", schedule="karras",
                                    ancestral=True, evals_per_step=2),
    "Euler a Karras": SamplerSpec("euler_a", schedule="karras", ancestral=True),
    "Euler Karras": SamplerSpec("euler", schedule="karras"),
    "PLMS": SamplerSpec("plms", schedule="ddim"),
    "DPM fast": SamplerSpec("dpm_fast", schedule="exponential"),
    "DPM adaptive": SamplerSpec("dpm_solver_3", schedule="exponential",
                                evals_per_step=3, adaptive=True),
}

#: step algorithms the port runs
PORTED = frozenset({"euler", "euler_a"})


class SamplerNotPorted(ValueError):
    """The JAX package has this sampler; the port does not run it yet."""


def _lookup(name: str) -> SamplerSpec:
    if name in SAMPLERS:
        return SAMPLERS[name]
    base = name.replace(" Karras", "")
    if base in SAMPLERS and "Karras" in name:
        return dataclasses.replace(SAMPLERS[base], schedule="karras")
    return SAMPLERS["Euler a"]


def resolve_sampler(name: str) -> SamplerSpec:
    spec = _lookup(name)
    if spec.adaptive or spec.algorithm not in PORTED:
        raise SamplerNotPorted(f"sampler {name!r} is not ported to the "
                               f"PyTorch engine yet")
    return spec


def ported_sampler_names() -> List[str]:
    return [n for n, s in SAMPLERS.items()
            if s.algorithm in PORTED and not s.adaptive]


class Carry(NamedTuple):
    """Sampler state: latent + a 3-deep history of per-step estimates
    (the JAX package's ``Carry``; euler/euler_a keep but never read it)."""

    x: torch.Tensor
    old_denoised: torch.Tensor
    have_old: bool
    hist2: torch.Tensor
    hist3: torch.Tensor
    n_hist: int


def init_carry(x: torch.Tensor) -> Carry:
    return Carry(x, torch.zeros_like(x), False, torch.zeros_like(x),
                 torch.zeros_like(x), 0)


def _ancestral_split(sigma: torch.Tensor, sigma_next: torch.Tensor,
                     eta: float = 1.0):
    """(sigma_down, sigma_up) for ancestral steps (k-diffusion formula)."""
    var_frac = (sigma**2 - sigma_next**2) / torch.clamp(sigma**2, min=1e-20)
    sigma_up = torch.minimum(
        sigma_next,
        eta * torch.sqrt(torch.clamp(sigma_next**2 * var_frac, min=0.0)))
    sigma_down = torch.sqrt(torch.clamp(sigma_next**2 - sigma_up**2,
                                        min=0.0))
    return sigma_down, sigma_up


def make_sampler_step(spec: SamplerSpec, denoise_fn: DenoiseFn,
                      sigmas: torch.Tensor, image_keys: torch.Tensor
                      ) -> Callable[[Carry, int], Carry]:
    """The step function for ``spec`` over a fixed f32 sigma ladder
    ``(steps+1,)``; ``image_keys`` ``(B, 2)`` key the ancestral noise."""
    algo = spec.algorithm
    if algo not in PORTED:
        raise SamplerNotPorted(f"step algorithm {algo!r} is not ported yet")

    def step(carry: Carry, i: int) -> Carry:
        x = carry.x
        sigma, sigma_next = sigmas[i], sigmas[i + 1]
        denoised = denoise_fn(x, sigma, i)
        d = (x - denoised) / torch.clamp(sigma, min=1e-10)
        if algo == "euler":
            x_new = x + d * (sigma_next - sigma)
        else:
            sigma_down, sigma_up = _ancestral_split(sigma, sigma_next)
            x_new = x + d * (sigma_down - sigma)
            noise = rng.step_noise(image_keys, i, x.shape[1:])
            x_new = x_new + noise * sigma_up
        return Carry(x_new, denoised, True, carry.old_denoised, carry.hist2,
                     carry.n_hist + 1)

    return step


def build_sigmas(spec: SamplerSpec, schedule: sched.NoiseSchedule,
                 steps: int) -> torch.Tensor:
    return torch.from_numpy(sched.SCHEDULES[spec.schedule](schedule, steps))
