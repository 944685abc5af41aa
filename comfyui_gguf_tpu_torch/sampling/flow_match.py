"""Rectified-flow sampling (PyTorch port of
comfyui_gguf_tpu/sampling/flow_match.py).

sigma == t ∈ (0, 1], x_t = (1-σ)·x₀ + σ·noise, the model predicts the
velocity v = dx/dσ, and an Euler step is x ← x + (σ_next − σ)·v. The
reference runs the loop as one ``lax.scan`` under jit; here it is a Python
loop. The Euler sampler and its inpainting form are ported; the multistep
and k-diffusion samplers raise ``NotImplementedError``.
"""

from __future__ import annotations

import math

import numpy as np
import torch


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


FLOW_SAMPLERS = {"euler": euler_sample}
DEFAULT_FLOW_SAMPLER = "euler"


def sample_flow(model_fn, x, sigmas, sampler: str | None = None):
    """Integrate with ``sampler`` (a FLOW_SAMPLERS name) or the default
    flow sampler."""
    name = sampler or DEFAULT_FLOW_SAMPLER
    if name not in FLOW_SAMPLERS:
        raise NotImplementedError(
            f"flow sampler {name!r} is not in the port (the reference's "
            f"multistep and k-diffusion samplers are not ported yet); the "
            f"port has {sorted(FLOW_SAMPLERS)}")
    return FLOW_SAMPLERS[name](model_fn, x, sigmas)
