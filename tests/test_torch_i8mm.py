"""The port's w8a8 path against the reference package.

* ``quantize_rows`` gives the same int8 codes and scales (round half to
  even, the scale floor, a true division by 127);
* ``requantize_i8`` gives the same int8 weights and per-column scales as the
  reference's (compiled) conversion, bit for bit; the port stores the codes
  transposed, (Rp, Kp) with K contiguous, and ``interop`` carries the
  reference's (Kp, Rp) codes into that layout;
* the plain w8a8 matmul matches ``xla_i8mm`` and the Pallas kernel in
  interpret mode. Integers are exact; the float32 output agrees to 1e-5
  relative L2 (the integer sums are exact and the rescale and epilogue run
  in the same order; only the f32 rounding of tanh may differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_gguf_tpu.gguf.constants import GGMLQuantizationType as JQ
from comfyui_gguf_tpu.ops import i8mm as ji8mm
from comfyui_gguf_tpu.quant import i8 as ji8
from comfyui_gguf_tpu.quant import planar as jplanar
from comfyui_gguf_tpu_torch.gguf.constants import GGMLQuantizationType as Q
from comfyui_gguf_tpu_torch.interop import params_from_numpy
from comfyui_gguf_tpu_torch.ops.i8mm import i8_matmul, plain_i8mm
from comfyui_gguf_tpu_torch.quant import codecs, planar
from comfyui_gguf_tpu_torch.nn.layers import QuantConfig, embedding
from comfyui_gguf_tpu_torch.quant.i8 import (convert_tree_i8, dequantize_i8,
                                             is_modulation_key,
                                             quantize_rows, requantize_i8)

torch.set_num_threads(2)


def _rel_l2(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _pair(qtype, R, K, seed=0):
    rng = np.random.default_rng(seed)
    blocks = codecs.quantize(rng.standard_normal((R, K), dtype=np.float32),
                             qtype)
    return (jplanar.planarize(blocks, JQ(int(qtype)), (R, K)),
            planar.planarize(blocks, qtype, (R, K)))


@pytest.mark.parametrize("scale", [1.0, 1e-3, 300.0])
def test_quantize_rows_identical(scale):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((33, 512)) * scale).astype(np.float32)
    x[4] = 0.0  # an all-zero row keeps a finite scale and zero codes
    x[5, :7] = [0.5, -0.5, 1.5, 2.5, -2.5, 127.0, -127.0]  # half-way values
    jq, js = ji8.quantize_rows(jnp.asarray(x))
    tq, ts = quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32


@pytest.mark.parametrize("qtype", [Q.Q4_K, Q.Q4_0, Q.Q4_1, Q.Q8_0, Q.Q6_K,
                                   Q.Q5_K, Q.Q2_K], ids=lambda q: q.name)
def test_requantize_identical(qtype):
    jp, tp = _pair(qtype, 200, 1536, seed=int(qtype))
    ji = ji8.requantize_i8(jp)
    ti = requantize_i8(tp)
    # the same codes, stored out-feature-major: (Rp, Kp), K contiguous
    assert ti.qs.shape == np.asarray(ji.qs).T.shape and ti.qs.is_contiguous()
    np.testing.assert_array_equal(ti.qs.numpy(), np.asarray(ji.qs).T)
    np.testing.assert_array_equal(ti.scales.numpy(), np.asarray(ji.scales))
    assert ti.shape == ji.shape and ti.qtype == ji.qtype
    assert (ti.padded_in, ti.padded_out) == (ji.padded_in, ji.padded_out)
    np.testing.assert_array_equal(
        dequantize_i8(ti).numpy(),
        np.asarray(ji8.dequantize_i8(ji, jnp.float32)))


def _stacked(*ps):
    a = ps[0]
    return planar.PlanarQuant(
        qs=torch.stack([p.qs for p in ps]),
        scales=torch.stack([p.scales for p in ps]),
        offsets=torch.stack([p.offsets for p in ps]), qtype=a.qtype,
        layout=a.layout, group_size=a.group_size, zero_point=a.zero_point,
        shape=a.shape)


def test_requantize_stacked_matches_slices():
    _, a = _pair(Q.Q4_K, 128, 512, seed=1)
    _, b = _pair(Q.Q4_K, 128, 512, seed=2)
    si = requantize_i8(_stacked(a, b))
    assert si.qs.shape == (2, a.padded_out, a.padded_in)
    for i, p in enumerate((a, b)):
        pi = requantize_i8(p)
        assert torch.equal(si.qs[i], pi.qs)
        assert torch.equal(si.scales[i], pi.scales)


def test_stacked_slices_are_views():
    _, a = _pair(Q.Q4_K, 200, 512, seed=3)
    _, b = _pair(Q.Q4_K, 200, 512, seed=4)
    si = requantize_i8(_stacked(a, b))
    view = si[1]
    assert view.qs.untyped_storage().data_ptr() == \
        si.qs.untyped_storage().data_ptr()
    assert view.qs.data_ptr() == si.qs.data_ptr() + si.qs[0].numel()
    # each slice is itself (Rp, Kp) with K contiguous: the kernel's operand
    assert view.qs.is_contiguous() and view.scales.is_contiguous()
    assert (view.padded_out, view.padded_in) == (a.padded_out, a.padded_in)


@pytest.mark.parametrize("stacked", [False, True], ids=["2d", "stacked"])
def test_interop_carries_reference_i8(stacked):
    jps = [_pair(Q.Q4_K, 200, 1024, seed=s)[0] for s in (5, 6)]
    if stacked:
        ji = ji8.I8Planar(
            qs=jnp.stack([ji8.requantize_i8(p).qs for p in jps]),
            scales=jnp.stack([ji8.requantize_i8(p).scales for p in jps]),
            qtype=jps[0].qtype, shape=jps[0].shape)
    else:
        ji = ji8.requantize_i8(jps[0])
    tree = {"w": jax.tree.map(np.asarray, ji)}
    ti = params_from_numpy(tree, device="cpu")["w"]
    want = np.swapaxes(np.asarray(ji.qs), -1, -2)
    assert ti.qs.shape == want.shape and ti.qs.is_contiguous()
    np.testing.assert_array_equal(ti.qs.numpy(), want)
    np.testing.assert_array_equal(ti.scales.numpy(), np.asarray(ji.scales))
    assert (ti.padded_in, ti.padded_out) == (ji.padded_in, ji.padded_out)
    if stacked:
        for i in range(2):
            np.testing.assert_array_equal(
                dequantize_i8(ti[i]).numpy(),
                np.asarray(ji8.dequantize_i8(ji8.requantize_i8(jps[i]),
                                             jnp.float32)))


@pytest.mark.parametrize("qtype", [Q.Q8_0, Q.Q4_K], ids=lambda q: q.name)
def test_embedding_on_int8_table(qtype):
    rng = np.random.default_rng(11)
    table = rng.standard_normal((40, 512)).astype(np.float32)
    ids = rng.integers(0, 40, (2, 7)).astype(np.int32)
    jp = jplanar.planarize(codecs.quantize(table, qtype), JQ(int(qtype)),
                           table.shape)
    ji = ji8.requantize_i8(jp)
    ti = params_from_numpy({"t": jax.tree.map(np.asarray, ji)}, "cpu")["t"]
    got = embedding(torch.from_numpy(ids), ti,
                    cfg=QuantConfig(dequant_dtype=torch.float32))
    want = np.asarray(ji8.dequantize_i8(ji, jnp.float32))[ids]
    assert got.shape == (2, 7, 512)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("M", [1, 37])
@pytest.mark.parametrize("K", [512, 2432])
@pytest.mark.parametrize("has_bias,act", [(False, None), (True, 0),
                                          (True, 512)], ids=str)
def test_plain_i8mm_matches_reference(M, K, has_bias, act):
    R = 1024
    jp, _ = _pair(Q.Q4_K, R, K, seed=M + K)
    ji = ji8.requantize_i8(jp)
    ti = params_from_numpy({"w": ji}, device="cpu")["w"]
    rng = np.random.default_rng(M * K)
    x = rng.standard_normal((M, K), dtype=np.float32)
    bias = (rng.standard_normal(R) * 0.5).astype(np.float32)
    b = bias if has_bias else None
    want = ji8mm.xla_i8mm(jnp.asarray(x), ji,
                          bias=None if b is None else jnp.asarray(b),
                          act_from_col=act)
    got = plain_i8mm(torch.from_numpy(x), ti,
                     bias=None if b is None else torch.from_numpy(b),
                     act_from_col=act)
    assert got.shape == (M, R)
    assert _rel_l2(got, np.asarray(want)) < 1e-5
    if M == 37:
        kern = ji8mm.pallas_i8mm(jnp.asarray(x), ji, interpret=True,
                                 bias=None if b is None else jnp.asarray(b),
                                 act_from_col=act)
        assert _rel_l2(got, np.asarray(kern)) < 1e-5
    assert torch.equal(i8_matmul(torch.from_numpy(x), ti, bias=None if b is
                                 None else torch.from_numpy(b),
                                 act_from_col=act), got)


def test_convert_tree_keeps_modulation_planar():
    _, p = _pair(Q.Q4_K, 128, 512, seed=9)
    tree = {"double_blocks": {"img_mod.lin.weight": p,
                              "img_attn.qkv.weight": p,
                              "img_attn.qkv.bias": torch.zeros(128)},
            "final_layer.linear.weight": torch.zeros(4, 4)}
    out = convert_tree_i8(tree, free_source=True,
                          pred=lambda k, v: not is_modulation_key(k))
    blk = out["double_blocks"]
    assert isinstance(blk["img_mod.lin.weight"], planar.PlanarQuant)
    assert blk["img_attn.qkv.weight"].qs.dtype == torch.int8
    assert tree["double_blocks"]["img_attn.qkv.weight"] is None  # freed
    assert tree["double_blocks"]["img_mod.lin.weight"] is p
