"""Rectified-flow sampling (PyTorch port of
comfyui_gguf_tpu/sampling/flow_match.py).

sigma == t ∈ (0, 1], x_t = (1-σ)·x₀ + σ·noise, the model predicts the
velocity v = dx/dσ, and an Euler step is x ← x + (σ_next − σ)·v. The
reference runs the loop as one ``lax.scan`` under jit; here it is a Python
loop. ``FLOW_SAMPLERS`` holds Euler, the 2nd-order Adams-Bashforth
``multistep`` and every deterministic σ-space sampler of ``kdiffusion``
through the x₀-adapter ``make_flow_denoiser``; ``FLOW_STOCHASTIC_SAMPLERS``
holds the stochastic ones, which take a ``noise(shape)`` callable (see
``kdiffusion``). ``model_fn(x, sigma)`` receives sigma as a 0-d float32
tensor on x's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import kdiffusion as kd


def linear_schedule(num_steps: int) -> np.ndarray:
    """σ from 1 → 0 inclusive, num_steps+1 points (flux-schnell)."""
    return np.linspace(1.0, 0.0, num_steps + 1, dtype=np.float32)


def shift_sigmas(sigmas: np.ndarray, shift: float) -> np.ndarray:
    """Constant time-shift: σ' = s·σ / (1 + (s−1)·σ) (SD3: s=3.0)."""
    return (shift * sigmas / (1.0 + (shift - 1.0) * sigmas)).astype(np.float32)


def flux_schedule(num_steps: int, image_seq_len: int,
                  base_shift: float = 0.5, max_shift: float = 1.15,
                  shift: bool = True) -> np.ndarray:
    """Flux-dev resolution-dependent schedule: μ interpolated in seq-len."""
    sigmas = linear_schedule(num_steps)
    if not shift:
        return sigmas
    # linear μ(seq_len) through (256, base_shift) and (4096, max_shift)
    m = (max_shift - base_shift) / (4096 - 256)
    mu = m * image_seq_len + (base_shift - m * 256)
    return shift_sigmas(sigmas, math.exp(mu))


def euler_sample(model_fn, x: torch.Tensor, sigmas) -> torch.Tensor:
    """Euler integration of the probability-flow ODE.

    model_fn(x, sigma) → velocity, with sigma a 0-d float32 tensor on x's
    device. sigmas: (steps+1,) descending to 0.
    """
    sigmas = torch.as_tensor(np.asarray(sigmas, dtype=np.float32),
                             device=x.device)
    for i in range(sigmas.shape[0] - 1):
        s_cur, s_next = sigmas[i], sigmas[i + 1]
        v = model_fn(x, s_cur)
        x = (x.to(torch.float32)
             + (s_next - s_cur) * v.to(torch.float32)).to(x.dtype)
    return x


def euler_sample_inpaint(model_fn, x: torch.Tensor, sigmas, z0: torch.Tensor,
                         mask: torch.Tensor, noise_fn) -> torch.Tensor:
    """Masked Euler integration for inpainting.

    mask: 1 where the model generates, 0 where ``z0`` (the encoded source
    latent) is kept. After every step the kept region is projected onto the
    forward-noised source at the new sigma, so boundaries stay consistent
    with the noise level the model sees. ``noise_fn(i)`` gives step i's
    float32 noise of z0's shape (the reference folds i into a key).
    """
    sigmas = torch.as_tensor(np.asarray(sigmas, dtype=np.float32),
                             device=x.device)
    mask = mask.to(torch.float32)
    z0f = z0.to(torch.float32)
    for i in range(sigmas.shape[0] - 1):
        s_cur, s_next = sigmas[i], sigmas[i + 1]
        v = model_fn(x, s_cur)
        xf = x.to(torch.float32) + (s_next - s_cur) * v.to(torch.float32)
        x_keep = (1.0 - s_next) * z0f + s_next * noise_fn(i)
        xf = mask * xf + (1.0 - mask) * x_keep
        x = xf.to(x.dtype)
    return x


def cfg_wrap(model_fn, cond, uncond, scale: float):
    """Classifier-free guidance: the conditional and unconditional
    velocities mixed by ``scale``."""
    def fn(x, sigma):
        v_c = model_fn(x, sigma, cond)
        if scale == 1.0 or uncond is None:
            return v_c
        v_u = model_fn(x, sigma, uncond)
        return v_u + scale * (v_c - v_u)
    return fn


def multistep_sample(model_fn, x: torch.Tensor, sigmas) -> torch.Tensor:
    """2nd-order Adams-Bashforth multistep for the flow ODE (the
    rectified-flow analogue of DPM-Solver++ 2M): one model call per step,
    velocity linearly extrapolated from the previous step.

    x' = x + h·((1 + 1/(2r))·v − 1/(2r)·v_prev),  r = h_prev / h.
    The first step is Euler.
    """
    sig = kd.host_sigmas(sigmas)
    v_prev = None
    for i in range(len(sig) - 1):
        s, s_next = sig[i], sig[i + 1]
        h = s_next - s
        v = model_fn(x, kd.sigma_tensor(s, x)).to(torch.float32)
        if i > 0:
            r = (s - sig[i - 1]) / h
            v_eff = (float(1 + 1 / (2 * r)) * v
                     - float(1 / (2 * r)) * v_prev)
        else:
            v_eff = v
        x = (x.to(torch.float32) + float(h) * v_eff).to(x.dtype)
        v_prev = v
    return x


def make_flow_denoiser(model_fn):
    """velocity model → σ-space denoiser: x₀̂ = x − σ·v(x, σ).

    For rectified flow (x_σ = (1−σ)·x₀ + σ·ε, v = dx/dσ) the ODE in
    x₀-prediction form is dx/dσ = (x − x₀̂)/σ, the k-diffusion form, and the
    exponential-integrator step x' = (σ'/σ)·x + (1−σ'/σ)·x₀̂ is exact under
    locally-constant x₀̂. So every sampler in ``kdiffusion`` applies to flow
    DiTs directly on the flow sigmas."""
    def denoiser(x, sigma):
        v = model_fn(x, sigma)
        sigma = torch.as_tensor(sigma, dtype=torch.float32, device=x.device)
        return (x.to(torch.float32)
                - sigma * v.to(torch.float32)).to(x.dtype)

    return denoiser


def _sigma_space(kd_sampler, stochastic: bool = False):
    """Wrap a kdiffusion σ-space sampler as a flow sampler."""
    if stochastic:
        def run(model_fn, x, sigmas, noise, **kw):
            return kd_sampler(make_flow_denoiser(model_fn), x, sigmas,
                              noise, **kw)
    else:
        def run(model_fn, x, sigmas):
            return kd_sampler(make_flow_denoiser(model_fn), x, sigmas)
    return run


# flow euler is already exact and one call a step, so kdiffusion's euler
# does not replace it
FLOW_SAMPLERS = {"euler": euler_sample, "multistep": multistep_sample,
                 **{name: _sigma_space(fn) for name, fn in kd.SAMPLERS.items()
                    if name != "euler"}}

# stochastic flow samplers take (model_fn, x, sigmas, noise, **knobs)
FLOW_STOCHASTIC_SAMPLERS = {
    name: _sigma_space(fn, stochastic=True)
    for name, fn in kd.STOCHASTIC_SAMPLERS.items()}

# process-wide default for the flow pipelines (euler matches the reference
# host's default; "multistep" is 2nd order, better at low step counts)
DEFAULT_FLOW_SAMPLER = "euler"


def set_flow_sampler(name: str) -> None:
    global DEFAULT_FLOW_SAMPLER
    if name not in FLOW_SAMPLERS:
        raise ValueError(f"unknown flow sampler {name!r}; "
                         f"have {sorted(FLOW_SAMPLERS)}")
    DEFAULT_FLOW_SAMPLER = name


def sample_flow(model_fn, x, sigmas, sampler: str | None = None):
    """Integrate with ``sampler`` (a deterministic FLOW_SAMPLERS name) or
    the process-default flow sampler."""
    name = sampler or DEFAULT_FLOW_SAMPLER
    if name not in FLOW_SAMPLERS:
        raise ValueError(f"unknown flow sampler {name!r}; "
                         f"have {sorted(FLOW_SAMPLERS)}")
    return FLOW_SAMPLERS[name](model_fn, x, sigmas)
