"""The port's latent→RGB previewer (``preview.py``) on the CPU: the
reference's three tests (``tests/test_preview.py``) on the port, plus the
fit against the reference's: fed the reference's own draws
(``jax.random.normal(key(0), ...)``) and the same tiny VAE (float32
compute in both), the port's ridge fit gives the reference previewer's W
and b within 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

from comfyui_gguf_tpu import preview as jpreview
from comfyui_gguf_tpu.models import vae as jvae
from comfyui_gguf_tpu.nn.layers import QuantConfig as JQuantConfig
from comfyui_gguf_tpu_torch import preview
from comfyui_gguf_tpu_torch.interop import params_from_numpy
from comfyui_gguf_tpu_torch.models import testing
from comfyui_gguf_tpu_torch.models import vae
from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
from comfyui_gguf_tpu_torch.sampling import linear_schedule
from comfyui_gguf_tpu_torch.serving import ContinuousBatchEngine

torch.set_num_threads(2)

DIMS = testing.VAEDims(z_channels=4, base_ch=32, ch_mult=(1, 2),
                       num_res_blocks=1)


def test_fit_recovers_exact_affine_decoder():
    """A decoder that IS affine (rgb = z@W0 + b0, nearest-upsampled) must
    be recovered exactly by the ridge fit."""
    rng = np.random.default_rng(0)
    C = 6
    W0 = rng.standard_normal((C, 3)).astype(np.float32) * 0.3
    b0 = rng.standard_normal(3).astype(np.float32) * 0.1

    def decode_fn(z):
        rgb = z @ torch.from_numpy(W0) + torch.from_numpy(b0)
        return F.interpolate(rgb.permute(0, 3, 1, 2), scale_factor=4,
                             mode="nearest").permute(0, 2, 3, 1)

    pv = preview.fit_latent_preview(decode_fn, C, ridge=1e-6)
    np.testing.assert_allclose(pv.W, W0, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(pv.b, b0, rtol=1e-3, atol=1e-4)
    # projection output is [0, 1]-clipped display RGB, from arrays or
    # tensors
    z = rng.standard_normal((2, 5, 5, C)).astype(np.float32)
    img = pv(z)
    assert img.shape == (2, 5, 5, 3)
    assert img.min() >= 0.0 and img.max() <= 1.0
    np.testing.assert_array_equal(pv(torch.from_numpy(z)), img)


def _vae():
    sd = testing.vae_state_dict(DIMS, seed=4)
    return sd, params_from_numpy(sd, device="cpu"), \
        vae.VAEConfig.from_state_dict(sd)


def test_previewer_r2():
    """R² of the calibrated preview on held-out latents (real VAE): the
    fit generalizes (held-out R² tracks in-sample R²) and is
    deterministic."""
    _, params, cfg = _vae()
    pv = preview.previewer_for_vae(params, cfg)

    def r2(z):
        with torch.no_grad():
            img = vae.decode(params, cfg, torch.from_numpy(z)).numpy()
        f = vae.spatial_factor(cfg)
        n, s = z.shape[0], z.shape[1]
        pooled = img.reshape(n, s, f, s, f, 3).mean(axis=(2, 4))
        pred = z @ pv.W + pv.b
        ss_res = ((pooled - pred) ** 2).sum()
        ss_tot = ((pooled - pooled.mean(axis=(0, 1, 2))) ** 2).sum()
        return 1.0 - ss_res / ss_tot

    rng = np.random.default_rng(42)
    z_ho = rng.standard_normal((4, 12, 12, DIMS.z_channels)).astype(
        np.float32)
    z_in = torch.randn((8, 16, 16, DIMS.z_channels),
                       generator=torch.Generator().manual_seed(0)).numpy()
    r2_in, r2_ho = r2(z_in), r2(z_ho)
    assert r2_ho > r2_in - 0.1, (r2_in, r2_ho)
    pv2 = preview.previewer_for_vae(params, cfg)
    np.testing.assert_array_equal(pv.W, pv2.W)


def test_fit_matches_reference_on_its_draws():
    sd, params, cfg = _vae()
    jq = JQuantConfig(dequant_dtype=jnp.float32, compute_dtype=jnp.float32,
                      prefer_pallas=False)
    jp = {k: jnp.asarray(v) for k, v in sd.items()}
    jcfg = jvae.VAEConfig.from_state_dict(sd)
    want = jpreview.previewer_for_vae(jp, jcfg, qcfg=jq,
                                      key=jax.random.key(0))
    z = np.array(jax.random.normal(jax.random.key(0),
                                     (8, 16, 16, DIMS.z_channels),
                                     jnp.float32))
    tq = QuantConfig(dequant_dtype=torch.float32, compute_dtype=torch.float32)
    with torch.no_grad():
        img = vae.decode(params, cfg, torch.from_numpy(z), qcfg=tq)
    got = preview.fit_from_samples(z, img)
    np.testing.assert_allclose(got.W, want.W, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.b, want.b, rtol=1e-4, atol=1e-4)


def test_engine_on_step_preview_hook():
    """on_step fires per dispatched step with the advanced requests; a
    throwing callback is swallowed and serving completes."""
    def step(x, s_cur, s_next, cond):
        return x + (s_next - s_cur)[:, None, None, None]

    seen = []

    def on_step(reqs):
        for r in reqs:
            seen.append((r.request_id, r.step, float(r.latent.mean())))
        if len(seen) == 2:
            raise RuntimeError("preview exploded")  # must be swallowed

    eng = ContinuousBatchEngine(step, max_batch=2, on_step=on_step,
                                device="cpu")
    r1 = eng.submit(np.zeros((2, 2, 1), np.float32), {}, linear_schedule(3))
    r2 = eng.submit(np.zeros((2, 2, 1), np.float32), {}, linear_schedule(2))
    eng.run_until_drained()
    assert r1.finished and r2.finished and r1.error is None
    assert len(seen) == eng.stats.steps_executed
    assert {i for i, _, _ in seen} == {r1.request_id, r2.request_id}
