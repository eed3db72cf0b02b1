"""k-diffusion samplers as step functions.

Port of the JAX package's ``samplers/kdiffusion.py``: every step algorithm
of its sampler table and the DPM adaptive host loop. A sampler step is
``(carry, step_index) -> carry``; the engine runs steps in a Python loop of
chunks. Ancestral noise is keyed per image and per step (``fold_in(image_key,
step)``, ``runtime/rng.py``), never by batch position, so a sub-batch
reproduces the rows of the whole batch.

Where the JAX step branches with ``jax.lax.cond`` (a second evaluation only
while the next sigma is above zero, a warm-up only before PLMS has history),
the port branches on the host: the sigma ladder is a CPU tensor and the
history depth a Python int, so no device value is read back and no UNet
evaluation runs that the JAX package skips. The scalar arithmetic
(``t = -log(sigma)``, ``expm1(-h)``, step ratios) runs on f32 CPU tensors,
as JAX computes it in f32, not in Python's f64.

Names unknown to the table fall back to Euler a, as the JAX package's
``resolve_sampler`` does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

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
    # DPM adaptive: the engine runs the host PID loop
    # (:func:`sample_dpm_adaptive`); ``algorithm`` names the fixed-grid
    # step of a consumer without that loop
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


def resolve_sampler(name: str) -> SamplerSpec:
    """Look up a webui sampler name; unknown names fall back to Euler a."""
    if name in SAMPLERS:
        return SAMPLERS[name]
    base = name.replace(" Karras", "")
    if base in SAMPLERS and "Karras" in name:
        return dataclasses.replace(SAMPLERS[base], schedule="karras")
    return SAMPLERS["Euler a"]


class Carry(NamedTuple):
    """Sampler state: latent + a 3-deep history of per-step estimates.

    ``old_denoised`` is the newest history entry (``denoised`` for
    DPM++ 2M, the eps estimate ``d`` for LMS, PLMS and DPM fast);
    ``hist2``/``hist3`` are one and two steps older (only PLMS reads them).
    ``n_hist`` counts valid entries."""

    x: torch.Tensor
    old_denoised: torch.Tensor
    have_old: bool
    hist2: torch.Tensor
    hist3: torch.Tensor
    n_hist: int


#: the step algorithms of :func:`make_sampler_step`
ALGORITHMS = frozenset({"euler", "euler_a", "heun", "dpm2", "dpm2_a",
                        "dpmpp_2s_a", "dpmpp_sde", "dpmpp_2m", "lms", "plms",
                        "dpm_fast", "dpm_solver_2", "dpm_solver_3"})


def init_carry(x: torch.Tensor) -> Carry:
    return Carry(x, torch.zeros_like(x), False, torch.zeros_like(x),
                 torch.zeros_like(x), 0)


def _f32(value) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32)


def _neg_log(sigma: torch.Tensor) -> torch.Tensor:
    """``t = -log(max(sigma, 1e-10))`` in f32."""
    return -torch.log(torch.clamp(sigma, min=1e-10))


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


def _to_d(x: torch.Tensor, sigma: torch.Tensor,
          denoised: torch.Tensor) -> torch.Tensor:
    return (x - denoised) / torch.clamp(sigma, min=1e-10)


#: the index offset of a sampler's second noise stream (DPM++ 2S a's
#: midpoint draws ``noise(500_000 + i)``)
_STREAM = 500_000


def make_sampler_step(spec: SamplerSpec, denoise_fn: DenoiseFn,
                      sigmas: torch.Tensor, image_keys: torch.Tensor
                      ) -> Callable[[Carry, int], Carry]:
    """The step function for ``spec`` over a fixed f32 sigma ladder
    ``(steps+1,)`` on the CPU; ``image_keys`` ``(B, 2)`` key the ancestral
    noise. Each branch is the JAX step's branch of that name."""
    algo = spec.algorithm
    if algo not in ALGORITHMS:
        raise ValueError(f"unknown sampler algorithm {algo}")

    blocks = {}

    def noise(i: int, x: torch.Tensor) -> torch.Tensor:
        if image_keys.device.type != "cuda":
            return rng.step_noise(image_keys, i, x.shape[1:])
        # on the card, the draws of every step of the ladder at the first
        # one asked for (each keyed by its own index, so the same bits):
        # one pass of a few hundred elementwise kernels per range instead
        # of one per step, whose launches kept the host from running ahead
        # of the card. The CPU draws per step: its multi-threaded
        # elementwise kernels at the block's size are not bit-stable from
        # one call to the next.
        base = i - i % _STREAM
        block = blocks.get(base)
        if block is None:
            block = rng.step_noise_block(image_keys, base, len(sigmas) - 1,
                                         x.shape[1:])
            blocks[base] = block
        return block[i - base]

    def step(carry: Carry, i: int) -> Carry:
        x = carry.x
        sigma, sigma_next = sigmas[i], sigmas[i + 1]
        sigma_prev = sigmas[max(i - 1, 0)]
        denoised = denoise_fn(x, sigma, i)
        d = _to_d(x, sigma, denoised)
        last = not sigma_next > 0  # the ladder's terminal step

        if algo == "euler":
            x_new = x + d * (sigma_next - sigma)

        elif algo == "euler_a":
            sigma_down, sigma_up = _ancestral_split(sigma, sigma_next)
            x_new = x + d * (sigma_down - sigma) + noise(i, x) * sigma_up

        elif algo == "heun":
            x_new = x + d * (sigma_next - sigma)
            if not last:
                denoised2 = denoise_fn(
                    x_new, torch.clamp(sigma_next, min=1e-10), i)
                d2 = _to_d(x_new, sigma_next, denoised2)
                x_new = x + (d + d2) / 2 * (sigma_next - sigma)

        elif algo in ("dpm2", "dpm2_a"):
            if algo == "dpm2_a":
                sigma_down, sigma_up = _ancestral_split(sigma, sigma_next)
            else:
                sigma_down = sigma_next
            if sigma_down > 0:
                # midpoint in log-sigma space (k-diffusion sample_dpm_2)
                sigma_mid = torch.exp(
                    (torch.log(torch.clamp(sigma, min=1e-10))
                     + torch.log(torch.clamp(sigma_down, min=1e-10))) / 2)
                x_mid = x + d * (sigma_mid - sigma)
                d2 = _to_d(x_mid, sigma_mid,
                           denoise_fn(x_mid, sigma_mid, i))
                x_new = x + d2 * (sigma_down - sigma)
            else:
                x_new = x + d * (sigma_down - sigma)
            if algo == "dpm2_a":
                x_new = x_new + noise(i, x) * sigma_up

        elif algo == "dpmpp_2s_a":
            # single-step 2nd order in log-sigma space, then ancestral noise
            sigma_down, sigma_up = _ancestral_split(sigma, sigma_next)
            if sigma_down > 0:
                t = _neg_log(sigma)
                h = _neg_log(sigma_down) - t
                sig_mid = torch.exp(-(t + 0.5 * h))
                x_2 = (sig_mid / sigma) * x \
                    - torch.expm1(-0.5 * h) * denoised
                denoised_2 = denoise_fn(x_2, sig_mid, i)
                x_new = (sigma_down / sigma) * x \
                    - torch.expm1(-h) * denoised_2
            else:
                x_new = x + d * (sigma_down - sigma)
            x_new = x_new + noise(i, x) * sigma_up

        elif algo == "dpmpp_sde":
            # k-diffusion sample_dpmpp_sde (eta=1, r=1/2): fresh noise at
            # the midpoint (keyed 500_000 + i) and the endpoint (keyed i)
            if last:
                x_new = x + d * (sigma_next - sigma)
            else:
                t = _neg_log(sigma)
                h = _neg_log(sigma_next) - t
                sig_mid = torch.exp(-(t + 0.5 * h))
                sd1, su1 = _ancestral_split(sigma, sig_mid)
                x_2 = (sd1 / sigma) * x \
                    - torch.expm1(t - _neg_log(sd1)) * denoised
                x_2 = x_2 + noise(500_000 + i, x) * su1
                denoised_2 = denoise_fn(x_2, sig_mid, i)
                sd2, su2 = _ancestral_split(sigma, sigma_next)
                x_new = (sd2 / sigma) * x \
                    - torch.expm1(t - _neg_log(sd2)) * denoised_2
                x_new = x_new + noise(i, x) * su2

        elif algo == "dpmpp_2m":
            if last:
                x_new = denoised  # x collapses to the x0 prediction
            else:
                t = _neg_log(sigma)
                h = _neg_log(sigma_next) - t
                eff = denoised
                if carry.have_old:
                    r = (t - _neg_log(sigma_prev)) \
                        / torch.clamp(h, min=1e-10)
                    eff = (1 + 1 / (2 * r)) * denoised \
                        - (1 / (2 * r)) * carry.old_denoised
                ratio = sigma_next / torch.clamp(sigma, min=1e-10)
                x_new = ratio * x - torch.expm1(-h) * eff

        elif algo == "lms":
            # order-2 Adams-Bashforth on d; the history holds the last d
            h = sigma_next - sigma
            d_eff = d
            if carry.have_old:
                h_last = sigma - sigma_prev
                r = h / torch.where(h_last == 0, _f32(1.0), h_last)
                d_eff = d + 0.5 * r * (d - carry.old_denoised)
            x_new = x + d_eff * h

        elif algo == "plms":
            # ldm's pseudo linear multistep: Adams-Bashforth on the eps
            # estimate, order 2 -> 4 as history fills; the first step probes
            # sigma_next (pseudo improved Euler). The terminal step takes
            # plain d; the JAX step probes there too when it has no
            # history, and discards the result.
            h = sigma_next - sigma
            n = carry.n_hist
            d1, d2, d3 = carry.old_denoised, carry.hist2, carry.hist3
            if last:
                d_prime = d
            elif n >= 3:
                d_prime = (55 * d - 59 * d1 + 37 * d2 - 9 * d3) / 24
            elif n == 2:
                d_prime = (23 * d - 16 * d1 + 5 * d2) / 12
            elif n == 1:
                d_prime = (3 * d - d1) / 2
            else:
                sn = torch.clamp(sigma_next, min=1e-10)
                x_eul = x + d * h
                d_prime = (d + _to_d(x_eul, sn,
                                     denoise_fn(x_eul, sn, i))) / 2
            x_new = x + d_prime * h

        elif algo == "dpm_fast":
            # multistep 2nd-order DPM-Solver in the VE eps
            # parameterization: eps's slope from the last step's d (one
            # evaluation per step); the first step is solver-1
            if last:
                x_new = denoised
            else:
                t = _neg_log(sigma)
                h = _neg_log(sigma_next) - t
                i0 = sigma - sigma_next
                x_new = x - i0 * d
                if carry.have_old:
                    i1 = sigma - sigma_next - h * sigma_next
                    h_last = t + torch.log(torch.clamp(sigma_prev,
                                                       min=1e-10))
                    c1 = (d - carry.old_denoised) \
                        / torch.clamp(h_last, min=1e-10)
                    x_new = x_new - i1 * c1

        else:  # dpm_solver_2 / dpm_solver_3
            # single-step DPM-Solver, order 2 (midpoint) or 3 (thirds),
            # with the exact integrals of the Taylor terms over the step
            # (t = -log sigma): I0 = sigma - sigma', I1 = I0 - h sigma',
            # I2 = 2 I1 - h^2 sigma'
            if last:
                x_new = denoised
            else:
                t = _neg_log(sigma)
                h = _neg_log(sigma_next) - t
                i0 = sigma - sigma_next
                i1 = sigma - sigma_next - h * sigma_next
                a = 0.5 * h if algo == "dpm_solver_2" else h / 3.0
                sig1 = torch.exp(-(t + a))
                u1 = x + d * (sig1 - sigma)  # Euler probe
                d1 = _to_d(u1, sig1, denoise_fn(u1, sig1, i))
                if algo == "dpm_solver_2":
                    x_new = x - i0 * d - i1 * ((d1 - d) / a)
                else:
                    b = 2.0 * h / 3.0
                    sig2 = torch.exp(-(t + b))
                    # 2nd-order probe to s2 with the midstep slope
                    i0b = sigma - sig2
                    i1b = sigma - sig2 - b * sig2
                    u2 = x - i0b * d - i1b * (d1 - d) / a
                    d2 = _to_d(u2, sig2, denoise_fn(u2, sig2, i))
                    denom = a * b * (b - a)
                    c1 = (b * b * (d1 - d) - a * a * (d2 - d)) / denom
                    c2 = (a * (d2 - d) - b * (d1 - d)) / denom
                    i2 = 2.0 * i1 - h * h * sigma_next
                    x_new = x - i0 * d - i1 * c1 - i2 * c2

        # the history holds the eps estimate d for these, else denoised
        history = d if algo in ("lms", "plms", "dpm_fast") else denoised
        return Carry(x_new, history, True, carry.old_denoised, carry.hist2,
                     carry.n_hist + 1)

    return step


def build_sigmas(spec: SamplerSpec, schedule: sched.NoiseSchedule,
                 steps: int) -> torch.Tensor:
    return torch.from_numpy(sched.SCHEDULES[spec.schedule](schedule, steps))


# --------------------------------------------------------------------------
# DPM adaptive: host-side PID step control over one attempt per step
# --------------------------------------------------------------------------

class PIDStepController:
    """k-diffusion's PIDStepSizeController: proposes and accepts
    log-sigma step sizes from the embedded pair's error. Host arithmetic,
    the JAX package's line for line."""

    def __init__(self, h: float, pcoeff: float, icoeff: float, dcoeff: float,
                 order: float, accept_safety: float, eps: float = 1e-8):
        self.h = h
        self.b1 = (pcoeff + icoeff + dcoeff) / order
        self.b2 = -(pcoeff + 2 * dcoeff) / order
        self.b3 = dcoeff / order
        self.accept_safety = accept_safety
        self.eps = eps
        self.errs: list = []

    def _limiter(self, x: float) -> float:
        return 1.0 + math.atan(x - 1.0)

    def propose_step(self, error: float) -> bool:
        inv_error = 1.0 / (float(error) + self.eps)
        if not self.errs:
            self.errs = [inv_error, inv_error, inv_error]
        self.errs[0] = inv_error
        factor = (self.errs[0] ** self.b1 * self.errs[1] ** self.b2
                  * self.errs[2] ** self.b3)
        factor = self._limiter(factor)
        accept = factor >= self.accept_safety
        if accept:
            self.errs[2] = self.errs[1]
            self.errs[1] = self.errs[0]
        self.h *= factor
        return accept


def make_adaptive_attempt(denoise_fn: DenoiseFn,
                          whole: Optional[Callable[[torch.Tensor],
                                                   torch.Tensor]] = None):
    """One adaptive attempt ``(x, x_prev, s, h, rtol, atol) -> (x_low,
    x_high, error)`` with ``s``, ``h``, ``rtol`` and ``atol`` f32 CPU
    scalars: k-diffusion's embedded order-2/3 DPM-Solver pair in the eps
    parameterization over ``t = -log(sigma)`` (both share the probe at
    r1 = 1/3, so an attempt is 3 evaluations), and the scaled RMS error
    between them, a 0-d device tensor. ``whole``: where ``x`` holds this
    process's rows of a batch split over processes, the batch's scaled
    differences from every process's rows (each process then takes the
    same error over the whole batch)."""

    def attempt(x, x_prev, s, h, rtol, atol):
        sig_s = torch.exp(-s)
        den = denoise_fn(x, sig_s, 0)
        eps = (x - den) / sig_s
        # shared probe at s + h/3 (r1 = 1/3)
        sig1 = torch.exp(-(s + h / 3.0))
        u1 = x - sig1 * torch.expm1(h / 3.0) * eps
        den1 = denoise_fn(u1, sig1, 0)
        eps_r1 = (u1 - den1) / sig1
        sig_t = torch.exp(-(s + h))
        # order-2 estimate (dpm_solver_2_step, r1 = 1/3)
        x_low = x - sig_t * torch.expm1(h) * eps \
            - sig_t * 1.5 * torch.expm1(h) * (eps_r1 - eps)
        # order-3 estimate (dpm_solver_3_step, r1 = 1/3, r2 = 2/3)
        r2h = 2.0 * h / 3.0
        sig2 = torch.exp(-(s + r2h))
        u2 = x - sig2 * torch.expm1(r2h) * eps \
            - sig2 * 2.0 * (torch.expm1(r2h) / r2h - 1.0) * (eps_r1 - eps)
        den2 = denoise_fn(u2, sig2, 0)
        eps_r2 = (u2 - den2) / sig2
        x_high = x - sig_t * torch.expm1(h) * eps \
            - sig_t * 1.5 * (torch.expm1(h) / h - 1.0) * (eps_r2 - eps)
        delta = torch.clamp(
            rtol * torch.maximum(x_low.abs(), x_prev.abs()),
            min=float(atol))
        scaled = (x_low - x_high) / delta
        if whole is not None:
            scaled = whole(scaled)
        error = torch.sqrt(torch.mean(torch.square(scaled)))
        return x_low, x_high, error

    return attempt


def sample_dpm_adaptive(attempt_fn, x: torch.Tensor, sigma_max: float,
                        sigma_min: float, *, rtol: float = 0.05,
                        atol: float = 0.0078, h_init: float = 0.05,
                        pcoeff: float = 0.0, icoeff: float = 1.0,
                        dcoeff: float = 0.0, accept_safety: float = 0.81,
                        order: int = 3, max_attempts: int = 1000,
                        should_stop=None, on_accept=None):
    """k-diffusion ``sample_dpm_adaptive`` (eta=0): the host runs the PID
    controller, each attempt is one call of ``attempt_fn``
    (:func:`make_adaptive_attempt`), and its error is the one value read
    back per attempt.

    Integrates ``t = -log(sigma)`` from ``sigma_max`` to ``sigma_min`` and
    returns ``(x_at_sigma_min, info)``, with no terminal collapse to the
    denoised prediction. ``should_stop()`` is polled between attempts;
    ``on_accept(x, sigma, n)`` may transform x after each accepted step."""
    t_end = -math.log(sigma_min)
    s = float(-math.log(sigma_max))
    x_prev = x
    pid = PIDStepController(abs(h_init), pcoeff, icoeff, dcoeff,
                            order, accept_safety)
    info = {"steps": 0, "nfe": 0, "n_accept": 0, "n_reject": 0,
            "completed": False}
    while s < t_end - 1e-5:
        if should_stop is not None and should_stop():
            break
        if info["steps"] >= max_attempts:  # runaway-tolerance backstop
            break
        t = min(t_end, s + pid.h)
        x_low, x_high, error = attempt_fn(
            x, x_prev, _f32(s), _f32(t - s), _f32(rtol), _f32(atol))
        info["steps"] += 1
        info["nfe"] += 3
        if pid.propose_step(float(error)):
            x_prev = x_low
            x = x_high
            s = t
            info["n_accept"] += 1
            if on_accept is not None:
                x = on_accept(x, math.exp(-s), info["n_accept"])
        else:
            info["n_reject"] += 1
    info["completed"] = s >= t_end - 1e-5
    return x, info
