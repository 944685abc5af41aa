"""The port's Wan 2.1 causal 3-D VAE (``models/wan_vae.py``), ``conv3d``
and ``tiled_apply_video`` against the reference, on the CPU; mirrors
``tests/test_wan_vae.py``.

The reference test's tiny VAE (2 scales, one temporal up/down, base 8,
z 4: the real model's structure at toy width) is built here the same way
and given to both packages; so is the port's builder at a small geometry
(``testing.WanVAEDims``), whose published geometry is walked too. Checked:
decode (the shape law 1 + 2(T − 1) of one doubling, a single frame),
encode, the temporal causality, the tiled decode, the tiling machinery,
the single-head attention, ``conv3d`` in both compute dtypes, and the
interop carry of a VAE tree.

Tolerances (relative L2): 1e-4 in float32 compute (the sums run in another
order); 2e-2 in bfloat16 compute (the packages round in other places, and
the port rounds the attention's q/k/v to bf16 as K7 takes them on the
card: ROADMAP queue 3); 1e-5 for ``conv3d`` in float32 and 1e-3 in
bfloat16 (the same rounded operands, f32 sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_gguf_tpu.models import wan_vae as jvae
from comfyui_gguf_tpu.models.vae import tiled_apply_video as j_tiled
from comfyui_gguf_tpu.nn import layers as jlayers
from comfyui_gguf_tpu.nn.layers import QuantConfig as JQuantConfig
from comfyui_gguf_tpu_torch.interop import params_from_numpy
from comfyui_gguf_tpu_torch.models import testing, wan_vae
from comfyui_gguf_tpu_torch.models.vae import tiled_apply_video
from comfyui_gguf_tpu_torch.nn import layers
from comfyui_gguf_tpu_torch.nn.layers import QuantConfig

torch.set_num_threads(2)

F32 = QuantConfig(dequant_dtype=torch.float32, compute_dtype=torch.float32)
JF32 = JQuantConfig(dequant_dtype=jnp.float32, compute_dtype=jnp.float32,
                    prefer_pallas=False)
BF16 = QuantConfig()
JBF16 = JQuantConfig(prefer_pallas=False)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _conv3(rng, o, i, kt=3, kh=3, kw=3, s=0.15):
    return (rng.standard_normal((o, i, kt, kh, kw)) * s).astype(np.float32)


def _conv2(rng, o, i, k=3, s=0.15):
    return (rng.standard_normal((o, i, k, k)) * s).astype(np.float32)


def _res_block(rng, p, cin, cout):
    sd = {f"{p}.residual.0.gamma": np.ones(cin, np.float32),
          f"{p}.residual.2.weight": _conv3(rng, cout, cin),
          f"{p}.residual.2.bias": np.zeros(cout, np.float32),
          f"{p}.residual.3.gamma": np.ones(cout, np.float32),
          f"{p}.residual.6.weight": _conv3(rng, cout, cout),
          f"{p}.residual.6.bias": np.zeros(cout, np.float32)}
    if cin != cout:
        sd[f"{p}.shortcut.weight"] = _conv3(rng, cout, cin, 1, 1, 1)
        sd[f"{p}.shortcut.bias"] = np.zeros(cout, np.float32)
    return sd


def _attn_block(rng, p, c):
    return {f"{p}.norm.gamma": np.ones(c, np.float32),
            f"{p}.to_qkv.weight": _conv2(rng, 3 * c, c, 1),
            f"{p}.to_qkv.bias": np.zeros(3 * c, np.float32),
            f"{p}.proj.weight": _conv2(rng, c, c, 1),
            f"{p}.proj.bias": np.zeros(c, np.float32)}


def _upsample(rng, p, c, temporal):
    sd = {f"{p}.resample.1.weight": _conv2(rng, c // 2, c),
          f"{p}.resample.1.bias": np.zeros(c // 2, np.float32)}
    if temporal:
        sd[f"{p}.time_conv.weight"] = _conv3(rng, 2 * c, c, 3, 1, 1)
        sd[f"{p}.time_conv.bias"] = np.zeros(2 * c, np.float32)
    return sd


def _downsample(rng, p, c, temporal):
    sd = {f"{p}.resample.1.weight": _conv2(rng, c, c),
          f"{p}.resample.1.bias": np.zeros(c, np.float32)}
    if temporal:
        sd[f"{p}.time_conv.weight"] = _conv3(rng, c, c, 3, 1, 1)
        sd[f"{p}.time_conv.bias"] = np.zeros(c, np.float32)
    return sd


@pytest.fixture(scope="module")
def tiny_sd():
    """The reference test's tiny VAE, as a numpy state dict."""
    rng = np.random.default_rng(0)
    Z, C1, C0 = 4, 16, 8
    sd = {"conv2.weight": _conv3(rng, Z, Z, 1, 1, 1),
          "conv2.bias": np.zeros(Z, np.float32),
          "decoder.conv1.weight": _conv3(rng, C1, Z),
          "decoder.conv1.bias": np.zeros(C1, np.float32)}
    sd.update(_res_block(rng, "decoder.middle.0", C1, C1))
    sd.update(_attn_block(rng, "decoder.middle.1", C1))
    sd.update(_res_block(rng, "decoder.middle.2", C1, C1))
    sd.update(_res_block(rng, "decoder.upsamples.0", C1, C1))
    sd.update(_upsample(rng, "decoder.upsamples.1", C1, temporal=True))
    sd.update(_res_block(rng, "decoder.upsamples.2", C0, C0))
    sd.update(_upsample(rng, "decoder.upsamples.3", C0, temporal=False))
    sd.update(_res_block(rng, "decoder.upsamples.4", C0 // 2, C0 // 2))
    sd["decoder.head.0.gamma"] = np.ones(C0 // 2, np.float32)
    sd["decoder.head.2.weight"] = _conv3(rng, 3, C0 // 2)
    sd["decoder.head.2.bias"] = np.zeros(3, np.float32)
    sd["encoder.conv1.weight"] = _conv3(rng, C0, 3)
    sd["encoder.conv1.bias"] = np.zeros(C0, np.float32)
    sd.update(_res_block(rng, "encoder.downsamples.0", C0, C0))
    sd.update(_downsample(rng, "encoder.downsamples.1", C0, temporal=False))
    sd.update(_res_block(rng, "encoder.downsamples.2", C0, C1))
    sd.update(_downsample(rng, "encoder.downsamples.3", C1, temporal=True))
    sd.update(_res_block(rng, "encoder.middle.0", C1, C1))
    sd.update(_attn_block(rng, "encoder.middle.1", C1))
    sd.update(_res_block(rng, "encoder.middle.2", C1, C1))
    sd["encoder.head.0.gamma"] = np.ones(C1, np.float32)
    sd["encoder.head.2.weight"] = _conv3(rng, 2 * Z, C1)
    sd["encoder.head.2.bias"] = np.zeros(2 * Z, np.float32)
    sd["conv1.weight"] = _conv3(rng, 2 * Z, 2 * Z, 1, 1, 1)
    sd["conv1.bias"] = np.zeros(2 * Z, np.float32)
    return sd


def _both(sd):
    jp = {k: jnp.asarray(v) for k, v in sd.items()}
    tp = params_from_numpy(sd, "cpu")
    return (jp, jvae.WanVAEConfig.from_state_dict(jp), tp,
            wan_vae.WanVAEConfig.from_state_dict(tp))


def _z(shape, seed, scale=1.0):
    z = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)
    return jnp.asarray(z), torch.from_numpy(z)


@pytest.mark.parametrize("mode", [(F32, JF32, 1e-4), (BF16, JBF16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("frames", [3, 1])
def test_decode_matches_reference(tiny_sd, frames, mode):
    """T latent frames → 1 + 2(T − 1) pixel frames (one doubling in the
    tiny VAE), 4× spatial; a single latent frame decodes to one image."""
    qcfg, jqcfg, tol = mode
    jp, jcfg, tp, cfg = _both(tiny_sd)
    assert cfg.z_channels == jcfg.z_channels == 4
    jz, tz = _z((1, frames, 4, 4, 4), 1)
    want = np.asarray(jvae.decode(jp, jcfg, jz, qcfg=jqcfg), np.float32)
    got = wan_vae.decode(tp, cfg, tz, qcfg=qcfg)
    assert tuple(got.shape) == want.shape == (1, 2 * frames - 1, 16, 16, 3)
    assert torch.isfinite(got).all() and _rel(got, want) < tol


def test_encode_matches_reference_and_roundtrip_shapes(tiny_sd):
    jp, jcfg, tp, cfg = _both(tiny_sd)
    jv, tv = _z((1, 5, 16, 16, 3), 3, 0.1)
    want = np.asarray(jvae.encode(jp, jcfg, jv, qcfg=JF32))
    got = wan_vae.encode(tp, cfg, tv, qcfg=F32)
    assert tuple(got.shape) == want.shape == (1, 3, 4, 4, 4)
    assert _rel(got, want) < 1e-4
    assert wan_vae.decode(tp, cfg, got, qcfg=F32).shape == tv.shape


def test_temporal_causality(tiny_sd):
    """Frame t of the decode does not change when later latent frames
    change (the property the front-only padding exists for)."""
    _, _, tp, cfg = _both(tiny_sd)
    z1 = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 4, 4, 4, 4)).astype(np.float32))
    z2 = z1.clone()
    z2[:, -1] += 10.0
    o1 = wan_vae.decode(tp, cfg, z1, qcfg=F32)
    o2 = wan_vae.decode(tp, cfg, z2, qcfg=F32)
    assert torch.equal(o1[:, :3], o2[:, :3])
    assert (o1[:, -1] - o2[:, -1]).abs().max() > 0


def test_decode_tiled_matches_reference(tiny_sd):
    """The tiled decode against the reference's tiled decode (both blend
    the same tiles in the same order), and a latent within one tile takes
    the direct decode exactly."""
    jp, jcfg, tp, cfg = _both(tiny_sd)
    jz, tz = _z((1, 3, 12, 10, 4), 5, 0.5)
    want = np.asarray(jvae.decode_tiled(jp, jcfg, jz, tile=6, overlap=2,
                                        qcfg=JF32))
    got = wan_vae.decode_tiled(tp, cfg, tz, tile=6, overlap=2, qcfg=F32)
    assert tuple(got.shape) == want.shape and _rel(got, want) < 1e-4
    small = wan_vae.decode_tiled(tp, cfg, tz[:, :, :4, :4], tile=8,
                                 qcfg=F32)
    assert torch.equal(small, wan_vae.decode(tp, cfg, tz[:, :, :4, :4],
                                             qcfg=F32))


def test_decode_auto_tiles_on_request(tiny_sd, monkeypatch):
    _, _, tp, cfg = _both(tiny_sd)
    _, tz = _z((1, 2, 12, 10, 4), 6, 0.5)
    monkeypatch.setenv("GGUF_TPU_VAE_TILE", "6")
    tiled = wan_vae.decode_auto(tp, cfg, tz, qcfg=F32)
    assert torch.equal(tiled, wan_vae.decode_tiled(tp, cfg, tz, tile=6,
                                                   overlap=1, qcfg=F32))
    monkeypatch.delenv("GGUF_TPU_VAE_TILE")
    assert torch.equal(wan_vae.decode_auto(tp, cfg, tz, qcfg=F32),
                       wan_vae.decode(tp, cfg, tz, qcfg=F32))


def _up(t, repeat):
    t2 = repeat(repeat(t, 2, 2), 2, 3)
    return repeat(t2, 2, 1)[:, :2 * t.shape[1] - 1]


def test_tiled_video_machinery_matches_reference():
    """An identity fn comes back exactly (a convex feather partition), a
    local pixel-shuffle upsampler with a time doubling commutes with the
    tiling, and both equal the reference's ``tiled_apply_video``."""
    x = np.random.default_rng(7).standard_normal((2, 3, 13, 11, 4)).astype(
        np.float32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    out = tiled_apply_video(lambda t: t, tx, tile=6, overlap=2)
    assert _rel(out, x) < 1e-6
    assert _rel(out, j_tiled(lambda t: t, jx, tile=6, overlap=2)) < 1e-6
    got = tiled_apply_video(
        lambda t: _up(t, lambda a, n, d: a.repeat_interleave(n, dim=d)),
        tx, tile=5, overlap=2)
    want = j_tiled(lambda t: _up(t, lambda a, n, d: jnp.repeat(a, n, d)),
                   jx, tile=5, overlap=2)
    assert tuple(got.shape) == want.shape and _rel(got, want) < 1e-6


def test_attention_block_mixes_spatially():
    """The mid attention mixes the spatial positions of a frame: one head
    over all H·W positions, against a hand-rolled softmax."""
    rng = np.random.default_rng(9)
    C, p = 8, "blk"
    params = {f"{p}.norm.gamma": torch.ones(C),
              f"{p}.to_qkv.weight": torch.from_numpy(
                  (rng.standard_normal((3 * C, C, 1, 1)) * 0.3).astype(
                      np.float32)),
              f"{p}.proj.weight": torch.eye(C)[:, :, None, None]}
    x = torch.from_numpy(rng.standard_normal((1, 1, 3, 3, C)).astype(
        np.float32))
    got = wan_vae._attention_block(params, p, x, F32)[0, 0].reshape(9, C)
    h = wan_vae._rms(x, params[f"{p}.norm.gamma"])[0, 0].reshape(9, C)
    qkv = h @ params[f"{p}.to_qkv.weight"][:, :, 0, 0].T
    q, k, v = qkv.split(C, dim=-1)
    probs = torch.softmax((q @ k.T) * C ** -0.5, dim=-1)
    want = x[0, 0].reshape(9, C) + probs @ v
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("mode", [(F32, JF32, 1e-5), (BF16, JBF16, 1e-3)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("stride,padding", [
    (1, 0), ((1, 2, 2), 0), (1, 1), (2, ((2, 0), (1, 1), (0, 1)))], ids=str)
def test_conv3d_matches_reference(mode, stride, padding):
    qcfg, jqcfg, tol = mode
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 5, 8, 6, 4)).astype(np.float32)
    w = (rng.standard_normal((6, 4, 3, 3, 3)) * 0.2).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    want = np.asarray(jlayers.conv3d(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b), stride=stride,
                                     padding=padding, cfg=jqcfg))
    got = layers.conv3d(torch.from_numpy(x), torch.from_numpy(w),
                        torch.from_numpy(b), stride=stride, padding=padding,
                        cfg=qcfg)
    assert tuple(got.shape) == want.shape and _rel(got, want) < tol


def test_builder_matches_reference_and_published_layout():
    """``testing.wan_vae_state_dict`` at a small geometry decodes and
    encodes as the reference does; the published Wan 2.1 geometry has the
    layout models/wan_vae.py walks: 127M parameters, a 384-wide middle (K7's
    D = 384), two temporal doublings and two halvings."""
    sd = testing.wan_vae_state_dict(testing.WanVAEDims(), seed=1)
    jp, jcfg, tp, cfg = _both(sd)
    jz, tz = _z((1, 3, 4, 6, 4), 2)
    want = np.asarray(jvae.decode(jp, jcfg, jz, qcfg=JF32))
    got = wan_vae.decode(tp, cfg, tz, qcfg=F32)
    assert tuple(got.shape) == want.shape == (1, 5, 16, 24, 3)
    assert _rel(got, want) < 1e-4
    want = np.asarray(jvae.encode(jp, jcfg, jnp.asarray(got.numpy()),
                                  qcfg=JF32))
    assert _rel(wan_vae.encode(tp, cfg, got, qcfg=F32), want) < 1e-4

    shapes = testing.wan_vae_shapes(testing.WAN21_VAE_DIMS)
    assert sum(int(np.prod(s)) for s in shapes.values()) == 126892531
    assert shapes["decoder.middle.1.to_qkv.weight"] == (1152, 384, 1, 1)
    fake = {k: np.zeros(1) for k in shapes}
    for side, n in (("decoder.upsamples", 2), ("encoder.downsamples", 2)):
        kinds = list(wan_vae._walk(fake, side))
        assert sum(f"{p}.time_conv.weight" in shapes
                   for _, p in kinds) == n
    assert [k for k, _ in wan_vae._walk(fake, "decoder.middle")] == [
        "res", "attn", "res"]
