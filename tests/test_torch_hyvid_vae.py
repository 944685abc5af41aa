"""The port's HunyuanVideo causal 3-D VAE (``models/hyvid_vae.py``) against
the reference, on the CPU; mirrors ``tests/test_hyvid_vae.py``.

The reference test's tiny VAE (three levels of 32 channels, one temporal
doubling, z 4) is made by ``testing.hyvid_vae_state_dict`` (``HyVidVAEDims``,
the diffusers key names with 1x1x1 ``quant_conv`` / ``post_quant_conv``)
and given to both packages, with ``temporal_ups`` 1 as the reference test
sets it; the default small geometry (two doublings, a 64-wide
middle) and the published geometry are walked too. Checked: decode (the
shape law 1 + 2^n(T − 1), a single frame), encode and the encode → decode
round trip, the causal convolution (zero frames in front, never the first
frame repeated, and nothing from later frames), the decode's causality as
far as GroupNorm allows it, the tiled and the auto-tiled decode, and the
mid-block attention's spatial mixing against a hand-rolled softmax.

Tolerances (relative L2): 1e-4 in float32 compute (the sums run in another
order); 2e-2 in bfloat16 compute (the packages round in other places, and
the port rounds the mid-block attention's q/k/v to bf16 as K7 takes them
on the card, where the reference keeps them f32: ROADMAP queue 3); 2e-3
absolute for the attention against the hand-rolled softmax, as the
reference's test.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_gguf_tpu.models import hyvid_vae as jvae
from comfyui_gguf_tpu.nn.layers import QuantConfig as JQuantConfig
from comfyui_gguf_tpu_torch.interop import params_from_numpy
from comfyui_gguf_tpu_torch.models import hyvid_vae, testing
from comfyui_gguf_tpu_torch.nn.layers import QuantConfig

torch.set_num_threads(2)

F32 = QuantConfig(dequant_dtype=torch.float32, compute_dtype=torch.float32)
JF32 = JQuantConfig(dequant_dtype=jnp.float32, compute_dtype=jnp.float32,
                    prefer_pallas=False)
BF16 = QuantConfig()
JBF16 = JQuantConfig(prefer_pallas=False)
TINY = testing.HyVidVAEDims(widths=(32, 32, 32), z=4, layers=1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _both(sd, temporal_ups=None):
    jp = {k: jnp.asarray(v) for k, v in sd.items()}
    tp = {k: torch.from_numpy(v) for k, v in sd.items()}
    jcfg = jvae.HyVidVAEConfig.from_state_dict(jp)
    cfg = hyvid_vae.HyVidVAEConfig.from_state_dict(tp)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    if temporal_ups is not None:
        jcfg = dataclasses.replace(jcfg, temporal_ups=temporal_ups)
        cfg = dataclasses.replace(cfg, temporal_ups=temporal_ups)
    return jp, jcfg, tp, cfg


@pytest.fixture(scope="module")
def tiny():
    return _both(testing.hyvid_vae_state_dict(TINY, seed=0), temporal_ups=1)


def _z(shape, seed, scale=1.0):
    z = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)
    return jnp.asarray(z), torch.from_numpy(z)


@pytest.mark.parametrize("mode", [(F32, JF32, 1e-4), (BF16, JBF16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("frames", [3, 1])
def test_decode_matches_reference(tiny, frames, mode):
    """T latent frames → 1 + 2(T − 1) pixel frames (one temporal doubling),
    two spatial doublings; a single latent frame decodes to one image."""
    qcfg, jqcfg, tol = mode
    jp, jcfg, tp, cfg = tiny
    assert cfg.z_channels == 4
    jz, tz = _z((1, frames, 4, 4, 4), 1)
    want = np.asarray(jvae.decode(jp, jcfg, jz, qcfg=jqcfg), np.float32)
    got = hyvid_vae.decode(tp, cfg, tz, qcfg=qcfg)
    assert tuple(got.shape) == want.shape == (1, 2 * frames - 1, 16, 16, 3)
    assert torch.isfinite(got).all() and _rel(got.float(), want) < tol


def test_encode_matches_reference_and_roundtrip(tiny):
    jp, jcfg, tp, cfg = tiny
    jv, tv = _z((1, 5, 16, 16, 3), 2, 0.1)
    want = np.asarray(jvae.encode(jp, jcfg, jv, qcfg=JF32))
    got = hyvid_vae.encode(tp, cfg, tv, qcfg=F32)
    assert tuple(got.shape) == want.shape == (1, 3, 4, 4, 4)
    assert _rel(got, want) < 1e-4
    out = hyvid_vae.decode(tp, cfg, got, qcfg=F32)
    assert out.shape == tv.shape
    want = np.asarray(jvae.decode(jp, jcfg, jnp.asarray(got.numpy()),
                                  qcfg=JF32))
    assert _rel(out, want) < 1e-4


def test_default_geometry_two_doublings():
    """The small default geometry (a 64-wide middle, K7's D = 64 on the
    card) read with the config's own temporal_ups 2: T → 1 + 4(T − 1)
    frames, 4× spatial, decode and encode equal to the reference's."""
    jp, jcfg, tp, cfg = _both(testing.hyvid_vae_state_dict(
        testing.HyVidVAEDims(), seed=1))
    assert cfg.temporal_ups == 2 and cfg.z_channels == 16
    jz, tz = _z((1, 2, 3, 4, 16), 3)
    want = np.asarray(jvae.decode(jp, jcfg, jz, qcfg=JF32))
    got = hyvid_vae.decode(tp, cfg, tz, qcfg=F32)
    assert tuple(got.shape) == want.shape == (1, 5, 12, 16, 3)
    assert _rel(got, want) < 1e-4
    want = np.asarray(jvae.encode(jp, jcfg, jnp.asarray(got.numpy()),
                                  qcfg=JF32))
    enc = hyvid_vae.encode(tp, cfg, got, qcfg=F32)
    assert tuple(enc.shape) == (1, 2, 3, 4, 16) and _rel(enc, want) < 1e-4


def test_causal_conv_pads_zeros_in_front():
    """The causal conv pads kt − 1 ZERO frames in front (the reference's
    conv padding), so a constant clip's first output frame differs from the
    rest; and no output frame sees a later input frame."""
    rng = np.random.default_rng(4)
    w = (rng.standard_normal((4, 3, 3, 3, 3)) * 0.2).astype(np.float32)
    p = {"c.conv.weight": torch.from_numpy(w)}
    ones = torch.ones((1, 4, 5, 5, 3))
    out = hyvid_vae._cconv(p, "c", ones, cfg=F32)
    want = np.asarray(jvae._cconv({"c.conv.weight": jnp.asarray(w)}, "c",
                                  jnp.ones((1, 4, 5, 5, 3)), cfg=JF32))
    assert _rel(out, want) < 1e-5
    assert (out[:, 0] - out[:, 2]).abs().max() > 1e-2
    assert torch.allclose(out[:, 2], out[:, 3])
    x = torch.from_numpy(rng.standard_normal((1, 4, 5, 5, 3)).astype(
        np.float32))
    x2 = x.clone()
    x2[:, -1] += 3.0
    a, b = (hyvid_vae._cconv(p, "c", t, cfg=F32) for t in (x, x2))
    assert torch.equal(a[:, :3], b[:, :3])


def test_decode_causality(tiny):
    """The reference's check: GroupNorm's statistics span every frame, so
    exact causality holds for the convolutions alone (above); a large
    change of the last latent frame moves the last pixel frame ten times
    more than the first."""
    _, _, tp, cfg = tiny
    z1 = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 3, 4, 4, 4)).astype(np.float32))
    z2 = z1.clone()
    z2[:, -1] += 5.0
    o1, o2 = (hyvid_vae.decode(tp, cfg, z, qcfg=F32) for z in (z1, z2))
    d_first = (o1[:, 0] - o2[:, 0]).abs().max()
    d_last = (o1[:, -1] - o2[:, -1]).abs().max()
    assert d_last > 10 * max(float(d_first), 1e-6)


def test_decode_tiled_and_auto_match_reference(tiny, monkeypatch):
    """The tiled decode against the reference's tiled decode (both blend
    the same tiles in the same order); ``decode_auto`` tiles when
    GGUF_TPU_VAE_TILE is set and exceeded, and is ``decode`` otherwise."""
    jp, jcfg, tp, cfg = tiny
    jz, tz = _z((1, 2, 12, 10, 4), 5, 0.5)
    want = np.asarray(jvae.decode_tiled(jp, jcfg, jz, tile=6, overlap=2,
                                        qcfg=JF32))
    got = hyvid_vae.decode_tiled(tp, cfg, tz, tile=6, overlap=2, qcfg=F32)
    assert tuple(got.shape) == want.shape and _rel(got, want) < 1e-4
    monkeypatch.setenv("GGUF_TPU_VAE_TILE", "6")
    assert torch.equal(hyvid_vae.decode_auto(tp, cfg, tz, qcfg=F32),
                       hyvid_vae.decode_tiled(tp, cfg, tz, tile=6,
                                              overlap=1, qcfg=F32))
    monkeypatch.delenv("GGUF_TPU_VAE_TILE")
    assert torch.equal(hyvid_vae.decode_auto(tp, cfg, tz, qcfg=F32),
                       hyvid_vae.decode(tp, cfg, tz, qcfg=F32))


def test_mid_attn_mixes_spatially():
    """The heads-major layout: one head over all H·W positions of a frame
    (not H·W length-1 heads), against a hand-rolled softmax, and equal to
    the reference's block."""
    rng = np.random.default_rng(11)
    C, p = 32, "mid"
    sd = {f"{p}.group_norm.weight": np.ones(C, np.float32),
          f"{p}.group_norm.bias": np.zeros(C, np.float32),
          f"{p}.to_out.0.bias": np.zeros(C, np.float32)}
    for n in ("to_q", "to_k", "to_v", "to_out.0"):
        sd[f"{p}.{n}.weight"] = (rng.standard_normal((C, C)) * 0.1).astype(
            np.float32)
    tp = {k: torch.from_numpy(v) for k, v in sd.items()}
    x = rng.standard_normal((1, 1, 3, 3, C)).astype(np.float32)
    got = hyvid_vae._mid_attn(tp, p, torch.from_numpy(x), F32)
    h = hyvid_vae._gn3d(torch.from_numpy(x), tp[f"{p}.group_norm.weight"],
                        tp[f"{p}.group_norm.bias"]).numpy()[0, 0]
    h2 = h.reshape(9, C)
    q, k, v = (h2 @ sd[f"{p}.{n}.weight"].T for n in ("to_q", "to_k",
                                                       "to_v"))
    logits = (q @ k.T) * C ** -0.5
    probs = np.exp(logits - logits.max(1, keepdims=True))
    probs /= probs.sum(1, keepdims=True)
    want = x[0, 0].reshape(9, C) + (probs @ v) @ sd[f"{p}.to_out.0.weight"].T
    np.testing.assert_allclose(got[0, 0].reshape(9, C).numpy(), want,
                               rtol=2e-3, atol=2e-3)
    jgot = jvae._mid_attn({k: jnp.asarray(v) for k, v in sd.items()}, p,
                          jnp.asarray(x), JF32)
    assert _rel(got, jgot) < 1e-5


def test_published_geometry():
    """The published HunyuanVideo VAE's layout as models/hyvid_vae.py walks
    it: 246M parameters, a 512-wide middle with its single-head attention
    (K7's D = 512), 3 resnets a decoder level and 2 an encoder level, three
    resamplers a side."""
    shapes = testing.hyvid_vae_shapes(testing.HYVID_VAE_DIMS)
    assert sum(int(np.prod(s)) for s in shapes.values()) == 246478803
    assert shapes["decoder.mid_block.attentions.0.to_q.weight"] == (512, 512)
    assert shapes["decoder.conv_in.conv.weight"] == (512, 16, 3, 3, 3)
    fake = dict.fromkeys(shapes)
    assert hyvid_vae.HyVidVAEConfig.from_state_dict(
        {"decoder.conv_in.conv.weight": np.zeros((512, 16, 3, 3, 3))}
    ).z_channels == 16
    ups = list(hyvid_vae._walk_blocks(fake, "decoder", "up_blocks"))
    downs = list(hyvid_vae._walk_blocks(fake, "encoder", "down_blocks"))
    assert len(ups) == len(downs) == 4
    assert [len(list(hyvid_vae._walk_blocks(fake, b, "resnets")))
            for b in ups] == [3] * 4
    assert [len(list(hyvid_vae._walk_blocks(fake, b, "resnets")))
            for b in downs] == [2] * 4
    assert sum(f"{b}.upsamplers.0.conv.conv.weight" in shapes
               for b in ups) == 3


def test_interop_carries_the_vae_tree(tiny):
    """The reference's VAE tree through ``interop.params_from_numpy``: the
    same tensors, and the same decode bit for bit."""
    jp, _, tp, cfg = tiny
    carried = params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                "cpu")
    _, tz = _z((1, 2, 4, 4, 4), 8)
    assert torch.equal(hyvid_vae.decode(carried, cfg, tz, qcfg=F32),
                       hyvid_vae.decode(tp, cfg, tz, qcfg=F32))
