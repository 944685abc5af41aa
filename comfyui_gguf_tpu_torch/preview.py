"""Latent→RGB preview projection (PyTorch port of
comfyui_gguf_tpu/preview.py).

The projection is CALIBRATED against the loaded VAE: decode a handful of
random latents once at setup, average-pool the pixels back to latent
resolution, and ridge-fit an affine map latent→RGB. One small
least-squares at load time gives a preview for any latent space with no
copied constants, and the per-step preview is a single (H·W, C)×(C, 3)
matmul — cheap enough to run every serving tick (``on_step``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class LatentPreviewer:
    """Affine latent→RGB map: rgb = z @ W + b, in [0, 1]."""

    W: np.ndarray  # (C, 3)
    b: np.ndarray  # (3,)

    def __call__(self, z) -> np.ndarray:
        """(…, H, W, C) latent (array or tensor, any device) → (…, H, W, 3)
        float RGB in [0, 1]."""
        if isinstance(z, torch.Tensor):
            z = z.detach().to(torch.float32).cpu().numpy()
        rgb = np.asarray(z, np.float32) @ self.W + self.b
        return np.clip((rgb + 1.0) / 2.0, 0.0, 1.0)


def fit_from_samples(z, img, ridge: float = 1e-3) -> LatentPreviewer:
    """Ridge-fit the previewer from latents ``z`` (n, s, s, C) and their
    decoded images ``img`` (n, s·f, s·f, 3) in [-1, 1] (arrays or
    tensors)."""
    z = np.asarray(torch.as_tensor(z).to(torch.float32).cpu(), np.float32)
    img = np.asarray(torch.as_tensor(img).to(torch.float32).cpu(),
                     np.float32)
    n, size, _, c = z.shape
    f = img.shape[1] // size
    # average-pool pixels back to latent resolution
    pooled = img.reshape(n, size, f, size, f, 3).mean(axis=(2, 4))
    zs = z.reshape(-1, c)
    ys = pooled.reshape(-1, 3)
    # ridge-regularized normal equations with a bias column
    A = np.concatenate([zs, np.ones((zs.shape[0], 1), np.float32)], axis=1)
    reg = ridge * np.eye(c + 1, dtype=np.float32)
    reg[-1, -1] = 0.0  # don't shrink the bias
    sol = np.linalg.solve(A.T @ A + reg, A.T @ ys)
    return LatentPreviewer(W=sol[:-1].astype(np.float32),
                           b=sol[-1].astype(np.float32))


def fit_latent_preview(decode_fn, z_channels: int,
                       generator: torch.Generator | None = None, n: int = 8,
                       size: int = 16, ridge: float = 1e-3,
                       latent_std: float = 1.0) -> LatentPreviewer:
    """Calibrate a :class:`LatentPreviewer` against a real decoder.

    decode_fn: (B, size, size, z_channels) latent tensor → (B, size·f,
    size·f, 3) image in [-1, 1] (e.g. ``lambda z: vae.decode(params, cfg,
    z)``). The latents are drawn from ``generator`` (default: a CPU
    generator seeded 0) on its device. ``latent_std`` should match the
    scale of the latents being previewed (scaled DiT latents are ≈ unit
    variance).
    """
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    z = torch.randn((n, size, size, z_channels), generator=generator,
                    device=generator.device,
                    dtype=torch.float32) * latent_std
    return fit_from_samples(z, decode_fn(z), ridge=ridge)


def previewer_for_vae(vae_params, vae_cfg, qcfg=None,
                      generator: torch.Generator | None = None
                      ) -> LatentPreviewer:
    """Calibrate against ``models.vae`` decode, on the params' device."""
    from .models import vae as vae_model
    from .nn.layers import DEFAULT_CONFIG

    qcfg = qcfg or DEFAULT_CONFIG
    device = next(iter(vae_params.values())).device

    def decode_fn(z):
        return vae_model.decode(vae_params, vae_cfg, z.to(device), qcfg=qcfg)

    return fit_latent_preview(decode_fn, vae_cfg.z_channels,
                              generator=generator)
