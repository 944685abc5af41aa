"""The port's planar re-tiling and codecs against the reference package.

The same GGUF blocks go through both packages: the port must hold the same
bytes (the layout is kept in this slice) and dequantize bit-identically in
float32, for every format the codecs encode.
"""

import numpy as np
import pytest
import torch

from comfyui_gguf_tpu.gguf.constants import GGMLQuantizationType as JQ
from comfyui_gguf_tpu.quant import codecs as jcodecs
from comfyui_gguf_tpu.quant import planar as jplanar
from comfyui_gguf_tpu_torch.gguf.constants import GGMLQuantizationType as Q
from comfyui_gguf_tpu_torch.quant import codecs, planar

torch.set_num_threads(2)

PLANAR_TYPES = [
    Q.Q8_0, Q.Q4_0, Q.Q4_1, Q.Q5_0, Q.Q5_1, Q.IQ4_NL,
    Q.Q4_K, Q.Q5_K, Q.Q6_K, Q.Q3_K, Q.Q2_K, Q.IQ4_XS,
]
# every format with an encoder: the planar ones plus the float carriers
ALL_TYPES = PLANAR_TYPES + [Q.F32, Q.F16, Q.BF16]


@pytest.mark.parametrize("qtype", ALL_TYPES, ids=lambda q: q.name)
def test_codecs_match_reference(qtype):
    rng = np.random.default_rng(int(qtype) + 100)
    x = (rng.standard_normal((16, 512)) * 3).astype(np.float32)
    blocks = codecs.quantize(x, qtype)
    np.testing.assert_array_equal(
        blocks, jcodecs.quantize(x, JQ(int(qtype)), use_native=False))
    got = codecs.dequantize(blocks, qtype, x.shape)
    want = jcodecs.dequantize(blocks, JQ(int(qtype)), x.shape)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("qtype", PLANAR_TYPES, ids=lambda q: q.name)
@pytest.mark.parametrize("R,K", [(48, 512), (200, 2432)], ids=str)
def test_planar_bytes_and_dequant_match_reference(qtype, R, K):
    rng = np.random.default_rng(int(qtype))
    x = (rng.standard_normal((R, K)) * 2.0).astype(np.float32)
    blocks = codecs.quantize(x, qtype)
    p = planar.planarize(blocks, qtype, (R, K), device="cpu")
    jp = jplanar.planarize(blocks, JQ(int(qtype)), (R, K))

    assert (p.layout, p.group_size, p.zero_point, p.shape) == (
        jp.layout, jp.group_size, jp.zero_point, jp.shape)
    np.testing.assert_array_equal(p.qs.numpy(), np.asarray(jp.qs))
    np.testing.assert_array_equal(p.scales.numpy(), np.asarray(jp.scales))
    if jp.offsets is None:
        assert p.offsets is None
    else:
        np.testing.assert_array_equal(p.offsets.numpy(),
                                      np.asarray(jp.offsets))

    got = planar.dequantize(p).numpy()
    np.testing.assert_array_equal(got, np.asarray(jplanar.dequantize(jp)))
    np.testing.assert_array_equal(
        got, codecs.dequantize(blocks, qtype, (R, K)))


def test_stacked_slice_is_a_view():
    rng = np.random.default_rng(0)
    ps = [planar.planarize(codecs.quantize(
        rng.standard_normal((128, 512)).astype(np.float32), Q.Q4_K),
        Q.Q4_K, (128, 512)) for _ in range(3)]
    st = planar.PlanarQuant(
        qs=torch.stack([p.qs for p in ps]),
        scales=torch.stack([p.scales for p in ps]),
        offsets=torch.stack([p.offsets for p in ps]), qtype=ps[0].qtype,
        layout="nib4", group_size=32, zero_point=0, shape=(128, 512))
    view = st[2]
    for a, b in ((view.qs, st.qs), (view.scales, st.scales),
                 (view.offsets, st.offsets)):
        assert a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()
    np.testing.assert_array_equal(planar.dequantize(view).numpy(),
                                  planar.dequantize(ps[2]).numpy())


# --- bfloat16 scale planes (``planarize(scale_dtype=)``) --------------------
# The reference stores the scale and offset planes in bfloat16 on request
# (``quant/planar.py`` ``scale_dtype``, ``tests/test_planar.py``); the port
# must hold the same bits and dequantize bit-identically.

@pytest.mark.parametrize("qtype", PLANAR_TYPES, ids=lambda q: q.name)
def test_bf16_scale_planes_match_reference_bit_for_bit(qtype):
    import jax.numpy as jnp

    R, K = 200, 2432
    rng = np.random.default_rng(int(qtype) + 7)
    blocks = codecs.quantize(
        (rng.standard_normal((R, K)) * 2.0).astype(np.float32), qtype)
    p = planar.planarize(blocks, qtype, (R, K), scale_dtype=torch.bfloat16)
    jp = jplanar.planarize(blocks, JQ(int(qtype)), (R, K),
                           scale_dtype=jnp.bfloat16)
    assert p.scales.dtype == torch.bfloat16
    np.testing.assert_array_equal(p.qs.numpy(), np.asarray(jp.qs))

    def bits(t):
        return t.view(torch.int16).numpy()

    np.testing.assert_array_equal(
        bits(p.scales), np.asarray(jp.scales).view(np.int16))
    if jp.offsets is None:
        assert p.offsets is None
    else:
        assert p.offsets.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            bits(p.offsets), np.asarray(jp.offsets).view(np.int16))
    np.testing.assert_array_equal(planar.dequantize(p).numpy(),
                                  np.asarray(jplanar.dequantize(jp)))


def test_bf16_scales_halve_plane_bytes_within_quant_noise():
    """The reference's two checks (``tests/test_planar.py``): the planes
    take half the bytes, and the dequantized weight stays within 1e-2
    relative L2 of the float32-scale one and well inside the Q4_K
    quantization noise itself."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((64, 512)).astype(np.float32)
    blocks = codecs.quantize(w, Q.Q4_K)
    p32 = planar.planarize(blocks, Q.Q4_K, (64, 512))
    p16 = planar.planarize(blocks, Q.Q4_K, (64, 512),
                           scale_dtype=torch.bfloat16)
    plane32 = 2 * p32.scales.numel() * 4
    assert p32.nbytes_packed - p16.nbytes_packed == plane32 // 2
    a = planar.dequantize(p32).numpy()
    b = planar.dequantize(p16).numpy()
    assert np.linalg.norm(a - b) / np.linalg.norm(a) < 1e-2
    ref = codecs.dequantize(blocks, Q.Q4_K, (64, 512))
    assert np.abs(b - ref).mean() < 0.15 * np.abs(ref - w).mean()


def test_scale_dtype_must_be_f32_or_bf16():
    blocks = codecs.quantize(np.ones((128, 512), np.float32), Q.Q8_0)
    with pytest.raises(ValueError, match="scale_dtype"):
        planar.planarize(blocks, Q.Q8_0, (128, 512),
                         scale_dtype=torch.float16)


def _widened(p):
    """The same planar weight with its bf16 planes widened to float32."""
    import dataclasses

    return dataclasses.replace(
        p, scales=p.scales.float(),
        offsets=None if p.offsets is None else p.offsets.float())


@pytest.mark.parametrize("qtype", [Q.Q4_K, Q.Q8_0], ids=lambda q: q.name)
def test_bf16_scale_consumers_equal_the_widened_planes(qtype):
    """Every consumer of a planar leaf takes bf16 planes and computes what
    it computes on the exactly widened float32 planes: the plain fused
    matmul (LoRA-patched too), ``requantize_i8`` / ``convert_tree_i8``
    (stacked), and ``memory_report`` counts the halved bytes."""
    from comfyui_gguf_tpu_torch.lora import LoRAPatch, PatchedWeight
    from comfyui_gguf_tpu_torch.nn.layers import QuantConfig, linear
    from comfyui_gguf_tpu_torch.observability import memory_report
    from comfyui_gguf_tpu_torch.quant.i8 import (convert_tree_i8,
                                                 requantize_i8)

    rng = np.random.default_rng(3)
    R, K = 256, 1024
    blocks = codecs.quantize(rng.standard_normal((R, K)).astype(np.float32),
                             qtype)
    p16 = planar.planarize(blocks, qtype, (R, K), scale_dtype=torch.bfloat16)
    p32 = _widened(p16)
    x = torch.from_numpy(rng.standard_normal((5, K)).astype(np.float32))
    cfg = QuantConfig(dequant_dtype=torch.float32,
                      compute_dtype=torch.float32)
    assert torch.equal(linear(x, p16, cfg=cfg), linear(x, p32, cfg=cfg))
    patch = LoRAPatch(
        up=torch.from_numpy(rng.standard_normal((R, 4)).astype(np.float32)),
        down=torch.from_numpy(rng.standard_normal((4, K)).astype(np.float32)),
        mid=None, diff=None, scale=0.5)
    assert torch.equal(
        linear(x, PatchedWeight(p16, (patch,)), cfg=cfg),
        linear(x, PatchedWeight(p32, (patch,)), cfg=cfg))
    i16, i32 = requantize_i8(p16), requantize_i8(p32)
    assert torch.equal(i16.qs, i32.qs) and torch.equal(i16.scales, i32.scales)
    st = {"blocks": {"w": planar.PlanarQuant(
        qs=torch.stack([p16.qs, p16.qs]),
        scales=torch.stack([p16.scales, p16.scales]),
        offsets=(None if p16.offsets is None
                 else torch.stack([p16.offsets, p16.offsets])),
        qtype=p16.qtype, layout=p16.layout, group_size=p16.group_size,
        zero_point=p16.zero_point, shape=p16.shape)}}
    conv = convert_tree_i8(st)["blocks"]["w"]
    assert torch.equal(conv.qs[1], i32.qs)
    rep16, rep32 = memory_report({"w": p16}), memory_report({"w": p32})
    assert rep32["packed_bytes"] - rep16["packed_bytes"] == (
        p32.nbytes_packed - p16.nbytes_packed) > 0


def test_interop_carries_bf16_planes_and_memory_report_agrees():
    """A reference tree with bf16 scale planes carries across as bf16 (no
    widening), and both packages' ``memory_report`` count the same packed
    bytes."""
    import jax
    import jax.numpy as jnp

    from comfyui_gguf_tpu.observability import memory_report as jreport
    from comfyui_gguf_tpu_torch.interop import params_from_numpy
    from comfyui_gguf_tpu_torch.observability import memory_report

    rng = np.random.default_rng(5)
    blocks = codecs.quantize(
        rng.standard_normal((128, 1024)).astype(np.float32), Q.Q4_K)
    jp = jplanar.planarize(blocks, JQ.Q4_K, (128, 1024),
                           scale_dtype=jnp.bfloat16)
    tp = params_from_numpy({"w": jax.tree.map(np.asarray, jp)},
                           device="cpu")["w"]
    assert tp.scales.dtype == tp.offsets.dtype == torch.bfloat16
    np.testing.assert_array_equal(planar.dequantize(tp).numpy(),
                                  np.asarray(jplanar.dequantize(jp)))
    assert (memory_report({"w": tp})["packed_bytes"]
            == jreport({"w": jp})["packed_bytes"])
