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
