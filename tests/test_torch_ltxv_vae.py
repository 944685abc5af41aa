"""The port's LTX-Video causal 3-D VAE (``models/ltxv_vae.py``) against the
reference, on the CPU; mirrors ``tests/test_ltxv_vae.py``.

The reference test's tiny VAE (four levels of widths 8/12/12/16, 6 latent
channels, patch 4, 2 residual blocks a level, per-channel statistics) is
made by ``testing.ltxv_vae_state_dict`` (``LTXVVAEDims``) and given to both
packages; the published geometry is walked too. Checked: the config read
from the keys and the family detection; encode and decode (the shape law
T_lat → 1 + 8(T_lat − 1), 32× spatial) against the reference; the causal
convolution (the first frame repeated in front, never zeros, and nothing
from later frames); the decoder's and the encoder's causality; the
pixel-shuffle reshapes in their channel-major (st, sh, sw, c) order; the
sampled encode with the reference's noise and with a generator; the tiled
and the auto-tiled decode.

Tolerances (relative L2): 1e-4 in float32 compute (the sums run in another
order); 2e-2 in bfloat16 compute (the packages round in other places); 0
for the pure reshapes; 1e-5 absolute for the causality checks, as the
reference's tests.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_gguf_tpu.models import ltxv_vae as jvae
from comfyui_gguf_tpu.nn.layers import QuantConfig as JQuantConfig
from comfyui_gguf_tpu_torch.interop import params_from_numpy
from comfyui_gguf_tpu_torch.models import ltxv_vae, testing
from comfyui_gguf_tpu_torch.nn.layers import QuantConfig

torch.set_num_threads(2)

F32 = QuantConfig(dequant_dtype=torch.float32, compute_dtype=torch.float32)
JF32 = JQuantConfig(dequant_dtype=jnp.float32, compute_dtype=jnp.float32,
                    prefer_pallas=False)
BF16 = QuantConfig()
JBF16 = JQuantConfig(prefer_pallas=False)
LAT = 6


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


@pytest.fixture(scope="module")
def tiny():
    sd = testing.ltxv_vae_state_dict(testing.LTXVVAEDims(), seed=0)
    jp = {k: jnp.asarray(v) for k, v in sd.items()}
    tp = {k: torch.from_numpy(v) for k, v in sd.items()}
    return (jp, jvae.LTXVVAEConfig.from_state_dict(jp), tp,
            ltxv_vae.LTXVVAEConfig.from_state_dict(tp))


def _x(shape, seed, scale=1.0):
    x = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def test_config_introspection(tiny):
    jp, jcfg, tp, cfg = tiny
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.n_levels, cfg.latent_channels, cfg.res_blocks_per_level) == (
        4, LAT, 2)
    assert cfg.spatial_factor == 32 and cfg.temporal_factor == 8
    assert cfg.spatio_temporal_scaling == (True, True, True, False)
    assert ltxv_vae.detect_ltxv_vae(tp.keys()) == jvae.detect_ltxv_vae(
        jp.keys()) is True
    assert not ltxv_vae.detect_ltxv_vae(["decoder.mid_block.resnets.0."
                                         "conv1.conv.weight"])


@pytest.mark.parametrize("mode", [(F32, JF32, 1e-4), (BF16, JBF16, 2e-2)],
                         ids=["f32", "bf16"])
def test_encode_decode_match_reference(tiny, mode):
    """9 = 1 + 8 pixel frames at 64² encode to (2, 2, 2) latents and decode
    back to the video's shape, each equal to the reference's."""
    qcfg, jqcfg, tol = mode
    jp, jcfg, tp, cfg = tiny
    jv, tv = _x((1, 9, 64, 64, 3), 1, 0.5)
    want = np.asarray(jvae.encode(jp, jcfg, jv, qcfg=jqcfg), np.float32)
    z = ltxv_vae.encode(tp, cfg, tv, qcfg=qcfg)
    assert tuple(z.shape) == want.shape == (1, 2, 2, 2, LAT)
    assert _rel(z.float(), want) < tol
    jz, tz = _x((1, 2, 2, 2, LAT), 2)
    want = np.asarray(jvae.decode(jp, jcfg, jz, qcfg=jqcfg), np.float32)
    got = ltxv_vae.decode(tp, cfg, tz, qcfg=qcfg)
    assert tuple(got.shape) == want.shape == (1, 9, 64, 64, 3)
    assert torch.isfinite(got).all() and _rel(got.float(), want) < tol


@pytest.mark.parametrize("t_lat", [1, 3])
def test_frame_law(tiny, t_lat):
    """T_lat latent frames → 1 + 8(T_lat − 1) pixel frames: each temporal
    doubling trims its causal warm-up frame."""
    _, _, tp, cfg = tiny
    _, tz = _x((1, t_lat, 1, 2, LAT), 3)
    out = ltxv_vae.decode(tp, cfg, tz, qcfg=F32)
    assert tuple(out.shape) == (1, 1 + 8 * (t_lat - 1), 32, 64, 3)


def test_causal_conv_replicates_the_first_frame():
    """The causal conv pads with kt − 1 copies of the FIRST frame (not
    zeros, unlike the HunyuanVideo VAE's), so a constant clip gives equal
    output frames; and no output frame sees a later input frame."""
    rng = np.random.default_rng(4)
    w = (rng.standard_normal((4, 3, 3, 3, 3)) * 0.2).astype(np.float32)
    ones = torch.ones((1, 4, 5, 5, 3))
    out = ltxv_vae._causal_conv3d(ones, torch.from_numpy(w), None, cfg=F32)
    want = np.asarray(jvae._causal_conv3d(jnp.ones((1, 4, 5, 5, 3)),
                                          jnp.asarray(w), None, cfg=JF32))
    assert _rel(out, want) < 1e-5
    assert torch.allclose(out[:, 0], out[:, 3], atol=1e-6)
    x = torch.from_numpy(rng.standard_normal((1, 4, 5, 5, 3)).astype(
        np.float32))
    x2 = x.clone()
    x2[:, -1] += 3.0
    a, b = (ltxv_vae._causal_conv3d(t, torch.from_numpy(w), None, cfg=F32)
            for t in (x, x2))
    assert torch.equal(a[:, :3], b[:, :3])


def test_decoder_causality(tiny):
    """Pixel frames of latent frames 0..T−2 do not change when the last
    latent frame changes (norms are per token, every pad is in front)."""
    _, _, tp, cfg = tiny
    _, z = _x((1, 3, 2, 2, LAT), 2)
    z2 = z.clone()
    z2[:, -1] += 10.0
    o1, o2 = (ltxv_vae.decode(tp, cfg, t, qcfg=F32) for t in (z, z2))
    keep = 1 + 8 * (3 - 2)
    np.testing.assert_allclose(o1[:, :keep].numpy(), o2[:, :keep].numpy(),
                               rtol=1e-5, atol=1e-5)
    assert (o1[:, keep:] - o2[:, keep:]).abs().max() > 1e-4


def test_encoder_causality(tiny):
    _, _, tp, cfg = tiny
    _, v = _x((1, 17, 32, 32, 3), 3, 0.5)
    v2 = v.clone()
    v2[:, -8:] += 5.0  # only the last latent frame's window
    z1, z2 = (ltxv_vae.encode(tp, cfg, t, qcfg=F32) for t in (v, v2))
    np.testing.assert_allclose(z1[:, :-1].numpy(), z2[:, :-1].numpy(),
                               rtol=1e-5, atol=1e-5)
    assert (z1[:, -1] - z2[:, -1]).abs().max() > 1e-4


def test_pixel_shuffles_match_reference():
    x = np.random.default_rng(5).standard_normal(
        (2, 3, 4, 6, 2 * 3 * 5 * 7)).astype(np.float32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    got = ltxv_vae._depth_to_spacetime(tx, 2, 3, 5)
    want = np.asarray(jvae._depth_to_spacetime(jx, 2, 3, 5))
    assert tuple(got.shape) == want.shape == (2, 6, 12, 30, 7)
    np.testing.assert_array_equal(got.numpy(), want)
    # channel-major: output (t·2 + a, h·3 + b, w·5 + c) is channel
    # ((a·3 + b)·5 + c)·7 + k of input (t, h, w)
    np.testing.assert_array_equal(got[1, 2 * 2 + 1, 1 * 3 + 2, 3 * 5 + 4],
                                  x[1, 2, 1, 3, ((1 * 3 + 2) * 5 + 4) * 7:
                                    ((1 * 3 + 2) * 5 + 4) * 7 + 7])
    y = x[..., :48]
    s2d = ltxv_vae._depth_to_space(torch.from_numpy(y), 4)
    np.testing.assert_array_equal(
        s2d.numpy(), np.asarray(jvae._depth_to_space(jnp.asarray(y), 4)))
    back = ltxv_vae._space_to_depth(s2d, 4)
    np.testing.assert_array_equal(back.numpy(), y)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jvae._space_to_depth(
            jnp.asarray(s2d.numpy()), 4)))


def test_sampled_encode(tiny):
    """sample=True: z = mean + σ·ε. With the reference's ε (drawn from its
    key) handed in as ``noise`` the port's z equals the reference's; with a
    ``torch.Generator`` the draw is reproducible, seeded, and moves z off
    the mean."""
    jp, jcfg, tp, cfg = tiny
    jv, tv = _x((1, 9, 32, 32, 3), 6, 0.5)
    key = jax.random.key(3)
    want = np.asarray(jvae.encode(jp, jcfg, jv, sample=True, key=key,
                                  qcfg=JF32))
    eps = np.asarray(jax.random.normal(key, want.shape, jnp.float32))
    got = ltxv_vae.encode(tp, cfg, tv, sample=True, noise=eps, qcfg=F32)
    assert _rel(got, want) < 1e-4
    mean = ltxv_vae.encode(tp, cfg, tv, qcfg=F32)
    a, b = (ltxv_vae.encode(tp, cfg, tv, sample=True, qcfg=F32,
                            generator=torch.Generator().manual_seed(s))
            for s in (1, 1))
    assert torch.equal(a, b) and torch.isfinite(a).all()
    assert (a - mean).abs().max() > 0
    c = ltxv_vae.encode(tp, cfg, tv, sample=True, qcfg=F32,
                        generator=torch.Generator().manual_seed(2))
    assert not torch.equal(a, c)


def test_decode_tiled_and_auto_match_reference(tiny, monkeypatch):
    """The tiled decode against the reference's tiled decode (both blend
    the same tiles in the same order); ``decode_auto`` tiles when
    GGUF_TPU_VAE_TILE is set and exceeded, and is ``decode`` otherwise."""
    jp, jcfg, tp, cfg = tiny
    jz, tz = _x((1, 2, 6, 5, LAT), 6, 0.5)
    want = np.asarray(jvae.decode_tiled(jp, jcfg, jz, tile=3, overlap=1,
                                        qcfg=JF32))
    got = ltxv_vae.decode_tiled(tp, cfg, tz, tile=3, overlap=1, qcfg=F32)
    assert tuple(got.shape) == want.shape == (1, 9, 192, 160, 3)
    assert _rel(got, want) < 1e-4
    monkeypatch.setenv("GGUF_TPU_VAE_TILE", "4")
    assert torch.equal(ltxv_vae.decode_auto(tp, cfg, tz, qcfg=F32),
                       ltxv_vae.decode_tiled(tp, cfg, tz, tile=4, overlap=1,
                                             qcfg=F32))
    monkeypatch.delenv("GGUF_TPU_VAE_TILE")
    assert torch.equal(ltxv_vae.decode_auto(tp, cfg, tz, qcfg=F32),
                       ltxv_vae.decode(tp, cfg, tz, qcfg=F32))


def test_published_geometry():
    """The published LTX-Video 0.9 VAE's widths as models/ltxv_vae.py reads
    them: 297M parameters, 128 latent channels, 32× / 8× compression, the
    decoder's pixel-shuffle upsamplers emitting 8× their level's width."""
    shapes = testing.ltxv_vae_shapes(testing.LTXV_VAE_DIMS)
    assert sum(int(np.prod(s)) for s in shapes.values()) == 296743344
    fake = {k: np.zeros(s, np.float32) if len(s) < 5 else None
            for k, s in shapes.items()}
    fake["decoder.conv_in.conv.weight"] = np.zeros((1, 128, 1, 1, 1))
    cfg = ltxv_vae.LTXVVAEConfig.from_state_dict(fake)
    assert cfg == ltxv_vae.LTXVVAEConfig()
    assert shapes["decoder.up_blocks.1.upsamplers.0.conv.weight"] == (
        4096, 512, 3, 3, 3)
    assert shapes["encoder.conv_in.conv.weight"] == (128, 48, 3, 3, 3)
    assert shapes["decoder.conv_out.conv.weight"] == (48, 128, 3, 3, 3)


def test_interop_carries_the_vae_tree(tiny):
    """The reference's VAE tree (per-channel statistics included) through
    ``interop.params_from_numpy``: the same encode and decode bit for
    bit."""
    jp, _, tp, cfg = tiny
    carried = params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                "cpu")
    _, tz = _x((1, 2, 1, 2, LAT), 9)
    assert torch.equal(ltxv_vae.decode(carried, cfg, tz, qcfg=F32),
                       ltxv_vae.decode(tp, cfg, tz, qcfg=F32))
