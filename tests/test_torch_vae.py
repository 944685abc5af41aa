"""The port's layers for images and its AutoencoderKL against the
reference's, on the CPU.

The same numpy arrays feed both packages, in the reference's channel-minor
(B, H, W, C) order. Tolerances (relative L2 unless said otherwise):

* ``group_norm``, ``conv2d``, ``embedding`` in float32: 1e-5 (summation
  order); ``conv2d`` at the default bfloat16 compute type: 1e-2 (operands
  rounded to bf16 on both sides, f32 accumulation, one output rounding);
* VAE ``decode`` / ``encode`` (bf16 activations, as the reference runs
  them): 2e-2; float32 config: still bf16 activations inside (the
  reference casts the latent and the image to bf16), 2e-2;
* tiled = untiled: exact where one tile covers the input, and the port's
  tiled result against the reference's tiled result 2e-2; the feather
  masks are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_gguf_tpu.gguf.constants import GGMLQuantizationType as Q
from comfyui_gguf_tpu.models import vae as jvae
from comfyui_gguf_tpu.nn import layers as jlayers
from comfyui_gguf_tpu.quant import codecs as jcodecs
from comfyui_gguf_tpu.quant import planar as jplanar
from comfyui_gguf_tpu_torch.interop import params_from_numpy
from comfyui_gguf_tpu_torch.models import testing
from comfyui_gguf_tpu_torch.models import vae as tvae
from comfyui_gguf_tpu_torch.nn import layers as tlayers
from comfyui_gguf_tpu_torch.quant import i8 as ti8
from comfyui_gguf_tpu_torch.quant import planar as tplanar

torch.set_num_threads(2)

JF32 = jlayers.QuantConfig(dequant_dtype=jnp.float32,
                           compute_dtype=jnp.float32, prefer_pallas=False)
TF32 = tlayers.QuantConfig(dequant_dtype=torch.float32,
                           compute_dtype=torch.float32)
DIMS = testing.VAEDims(z_channels=4, base_ch=32, ch_mult=(1, 2, 2),
                       num_res_blocks=1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jp(sd):
    return {k: jnp.asarray(v) for k, v in sd.items()}


@pytest.mark.parametrize("shape,groups", [((2, 6, 5, 64), 32),
                                          ((1, 3, 3, 32), 8),
                                          ((2, 7, 32), 32)], ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_matches(shape, groups, dtype):
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    want = jlayers.group_norm(jnp.asarray(x, getattr(jnp, dtype)),
                              jnp.asarray(w), jnp.asarray(b),
                              num_groups=groups)
    got = tlayers.group_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                             torch.from_numpy(w), torch.from_numpy(b),
                             num_groups=groups)
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 4e-3
    assert _rel(got.float().numpy(),
                np.asarray(want.astype(jnp.float32))) <= tol
    bare = tlayers.group_norm(torch.from_numpy(x), num_groups=groups)
    want_bare = jlayers.group_norm(jnp.asarray(x), num_groups=groups)
    assert _rel(bare.numpy(), np.asarray(want_bare)) <= 1e-5


CONVS = [
    # cin, cout, k, stride, padding
    (8, 16, 3, 1, 1), (16, 8, 1, 1, 0), (8, 8, 3, 2, 0),
    (4, 12, 3, 2, ((0, 1), (0, 1))), (3, 6, 3, 1, ((1, 0), (2, 1))),
]


@pytest.mark.parametrize("cin,cout,k,stride,padding", CONVS, ids=str)
@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_conv2d_matches(cin, cout, k, stride, padding, f32):
    rng = np.random.default_rng(cin * cout + k)
    x = rng.standard_normal((2, 9, 10, cin)).astype(np.float32)
    w = (rng.standard_normal((cout, cin, k, k)) * 0.2).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    want = jlayers.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                          stride=stride, padding=padding,
                          cfg=JF32 if f32 else jlayers.DEFAULT_CONFIG)
    got = tlayers.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b), stride=stride, padding=padding,
                         cfg=TF32 if f32 else tlayers.DEFAULT_CONFIG)
    assert tuple(got.shape) == tuple(want.shape)
    assert _rel(got.numpy(), np.asarray(want)) <= (1e-5 if f32 else 1e-2)
    if not f32:  # bf16 operands, f32 accumulation: far inside the bound
        assert _rel(got.numpy(), np.asarray(want)) <= 1e-5


def test_embedding_dense_and_packed_rows():
    rng = np.random.default_rng(0)
    table = rng.standard_normal((40, 512)).astype(np.float32)
    ids = rng.integers(0, 40, (2, 3, 5)).astype(np.int32)
    want = np.asarray(jlayers.embedding(jnp.asarray(ids),
                                        jnp.asarray(table)))
    got = tlayers.embedding(torch.from_numpy(ids), torch.from_numpy(table))
    np.testing.assert_array_equal(got.numpy(), want)
    # Q8_0 and Q4_K tables: only the looked-up rows are dequantized, and
    # they equal the reference's rows of the whole dequantized table
    for qtype in (Q.Q8_0, Q.Q4_K):
        raw = jcodecs.quantize(table, qtype)
        jt = jplanar.planarize(raw, qtype, table.shape)
        tt = tplanar.planarize(raw, qtype, table.shape)
        want = np.asarray(jlayers.embedding(jnp.asarray(ids), jt, cfg=JF32))
        got = tlayers.embedding(torch.from_numpy(ids), tt, cfg=TF32)
        assert got.shape == (2, 3, 5, 512)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
        i8 = ti8.requantize_i8(tt)
        rows = tlayers.embedding(torch.from_numpy(ids), i8, cfg=TF32)
        full = tlayers.materialize(i8, torch.float32)[torch.from_numpy(
            ids).long()]
        np.testing.assert_array_equal(rows.numpy(), full.numpy())


def test_config_from_state_dict_matches():
    for dims in (DIMS, testing.VAEDims(), testing.VAEDims(
            z_channels=16, base_ch=8, ch_mult=(1, 2, 4, 4),
            num_res_blocks=2)):
        sd = testing.vae_state_dict(dims)
        a = tvae.VAEConfig.from_state_dict(sd)
        b = jvae.VAEConfig.from_state_dict(sd)
        assert a.__dict__ == b.__dict__
        assert (a.z_channels, a.base_ch, a.ch_mult, a.num_res_blocks) == (
            dims.z_channels, dims.base_ch, dims.ch_mult, dims.num_res_blocks)
    assert set(testing.vae_state_dict(testing.VAEDims(4, 16, (1, 1, 1, 1),
                                                      1))) == set(
        __import__("comfyui_gguf_tpu.models.testing", fromlist=["x"])
        .vae_random_params())


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32cfg"])
def test_decode_and_encode_match(f32):
    sd = testing.vae_state_dict(DIMS, seed=1)
    cfg_j, cfg_t = (m.VAEConfig.from_state_dict(sd) for m in (jvae, tvae))
    rng = np.random.default_rng(2)
    z = rng.standard_normal((2, 6, 5, 4)).astype(np.float32)
    img = rng.uniform(-1, 1, (1, 24, 16, 3)).astype(np.float32)
    jq, tq = (JF32, TF32) if f32 else (jlayers.DEFAULT_CONFIG,
                                       tlayers.DEFAULT_CONFIG)
    tp = params_from_numpy(sd, device="cpu")
    want = np.asarray(jvae.decode(_jp(sd), cfg_j, jnp.asarray(z), qcfg=jq))
    with torch.no_grad():
        got = tvae.decode(tp, cfg_t, torch.from_numpy(z), qcfg=tq)
    assert got.dtype == torch.float32 and got.shape == (2, 24, 20, 3)
    assert _rel(got.numpy(), want) <= 2e-2
    want = np.asarray(jvae.encode(_jp(sd), cfg_j, jnp.asarray(img), qcfg=jq))
    with torch.no_grad():
        got = tvae.encode(tp, cfg_t, torch.from_numpy(img), qcfg=tq)
    assert got.shape == (1, 6, 4, 4)
    assert _rel(got.numpy(), want) <= 2e-2


def test_encode_sampling_uses_the_generator():
    sd = testing.vae_state_dict(DIMS, seed=3)
    cfg = tvae.VAEConfig.from_state_dict(sd)
    tp = params_from_numpy(sd, device="cpu")
    img = torch.zeros((1, 16, 16, 3))
    with torch.no_grad():
        mean = tvae.encode(tp, cfg, img)
        a = tvae.encode(tp, cfg, img,
                        generator=torch.Generator().manual_seed(1))
        b = tvae.encode(tp, cfg, img,
                        generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, mean)


def test_feather_mask_and_tile_positions_match():
    for th, tw, f in ((8, 8, 2), (16, 4, 6), (5, 9, 0)):
        np.testing.assert_allclose(
            tvae._feather_mask(th, tw, f, "cpu").numpy(),
            np.asarray(jvae._feather_mask(th, tw, f)), rtol=1e-6)
    for args in ((10, 4, 3), (4, 8, 6), (17, 8, 6)):
        assert tvae._tile_positions(*args) == jvae._tile_positions(*args)


def test_tiled_matches_untiled_and_reference(monkeypatch):
    sd = testing.vae_state_dict(DIMS, seed=4)
    cfg_j, cfg_t = (m.VAEConfig.from_state_dict(sd) for m in (jvae, tvae))
    tp = params_from_numpy(sd, device="cpu")
    rng = np.random.default_rng(5)
    z = rng.standard_normal((1, 12, 10, 4)).astype(np.float32)
    img = rng.uniform(-1, 1, (1, 48, 40, 3)).astype(np.float32)
    with torch.no_grad():
        whole = tvae.decode(tp, cfg_t, torch.from_numpy(z))
        # one tile covers the latent: the tiled call IS the untiled one
        assert torch.equal(tvae.decode_tiled(tp, cfg_t, torch.from_numpy(z),
                                             tile=16, overlap=4), whole)
        tiled = tvae.decode_tiled(tp, cfg_t, torch.from_numpy(z), tile=8,
                                  overlap=4)
        etiled = tvae.encode_tiled(tp, cfg_t, torch.from_numpy(img),
                                   tile=32, overlap=8)
    want = np.asarray(jvae.decode_tiled(_jp(sd), cfg_j, jnp.asarray(z),
                                        tile=8, overlap=4))
    assert tiled.shape == whole.shape
    assert _rel(tiled.numpy(), want) <= 2e-2
    # per-tile GroupNorm statistics: tiled is close to untiled, not equal
    assert 0 < _rel(tiled.numpy(), whole.numpy()) < 0.5
    want = np.asarray(jvae.encode_tiled(_jp(sd), cfg_j, jnp.asarray(img),
                                        tile=32, overlap=8))
    assert _rel(etiled.numpy(), want) <= 2e-2
    with pytest.raises(ValueError, match="multiples"):
        tvae.encode_tiled(tp, cfg_t, torch.from_numpy(img), tile=30)
    # the opt-in knob keeps its name and rule
    monkeypatch.setenv("GGUF_TPU_VAE_TILE", "8")
    with torch.no_grad():
        auto = tvae.decode_auto(tp, cfg_t, torch.from_numpy(z))
        eauto = tvae.encode_auto(tp, cfg_t, torch.from_numpy(img))
    want = np.asarray(jvae.decode_auto(_jp(sd), cfg_j, jnp.asarray(z)))
    assert _rel(auto.numpy(), want) <= 2e-2
    want = np.asarray(jvae.encode_auto(_jp(sd), cfg_j, jnp.asarray(img)))
    assert _rel(eauto.numpy(), want) <= 2e-2
    monkeypatch.delenv("GGUF_TPU_VAE_TILE")
    with torch.no_grad():
        assert torch.equal(tvae.decode_auto(tp, cfg_t, torch.from_numpy(z)),
                           whole)
