"""The port's offline tools against the reference's on the same inputs.

convert → quantize → fix_5d must write byte-identical files in both
packages (every ftype preset, the text recipe, the >4-D sidecar round
trip), validate_checkpoint must give the same report dict for dict for
every architecture it has a spec for, and read_tensors the same text. The
quantized files load through the port's loader and dequantize bit for bit
like the reference's (through both packages' model entry points, with a
forward each: test_torch_tools_load.py). Inputs are made from a seed with
numpy; the source files are written with the port's own safetensors
writer.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from comfyui_gguf_tpu.loader import gguf_sd_loader as j_loader
from comfyui_gguf_tpu.tools import convert as jconvert
from comfyui_gguf_tpu.tools import fix_5d_tensors as jfix5d
from comfyui_gguf_tpu.tools import fix_lines_ending as jfixle
from comfyui_gguf_tpu.tools import quantize as jquantize
from comfyui_gguf_tpu.tools import read_tensors as jread
from comfyui_gguf_tpu.tools import validate_checkpoint as jV
from comfyui_gguf_tpu_torch import _safetensors, archs
from comfyui_gguf_tpu_torch.gguf.constants import (
    GGML_QUANT_SIZES,
    GGMLQuantizationType as Q,
    GGUFValueType,
    LlamaFileType as F,
)
from comfyui_gguf_tpu_torch.gguf.reader import GGUFReader
from comfyui_gguf_tpu_torch.gguf.writer import GGUFWriter
from comfyui_gguf_tpu_torch.loader import gguf_sd_loader, to_torch_params
from comfyui_gguf_tpu_torch.models import testing
from comfyui_gguf_tpu_torch.quant import codecs, planar
from comfyui_gguf_tpu_torch.quant.planar import PlanarQuant
from comfyui_gguf_tpu_torch.tools import (convert, fix_5d_tensors,
                                          fix_lines_ending, quantize,
                                          read_tensors)
from comfyui_gguf_tpu_torch.tools import validate_checkpoint as V

torch.set_num_threads(2)

ALL_FTYPES = list(quantize._FTYPE_BY_NAME)
IQ_FTYPES = ("IQ4_NL", "IQ4_XS")


@pytest.fixture(autouse=True)
def _reference_numpy_codecs(monkeypatch):
    """Hold the port against the reference's numpy codecs, its definition
    of the bytes: the reference's optional C++ Q4_0 encoder rounds some
    near-tie codes of f16/bf16-rounded blocks differently from them (its
    ``x * inv + 8.5f`` is compiled to one fused multiply-add)."""
    from comfyui_gguf_tpu import native

    monkeypatch.setattr(native, "available",
                        lambda qtype, decode=False: False)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _same_file(a, b):
    assert _bytes(a) == _bytes(b), (a, b)


def _save(sd, path):
    _safetensors.save_file({k: torch.from_numpy(v) for k, v in sd.items()},
                           str(path))
    return str(path)


def _flux_like_sd(rng):
    """The reference test's minimal key set that fingerprints as flux."""
    def t(*s):
        return rng.standard_normal(s).astype(np.float32)

    return {
        "double_blocks.0.img_attn.proj.weight": t(256, 512),
        "double_blocks.0.img_attn.qkv.weight": t(768, 512),
        "double_blocks.0.img_mlp.2.weight": t(512, 1024),
        "double_blocks.0.img_attn.proj.bias": t(256),
        "img_in.weight": t(256, 64),
        "time_in.in_layer.weight": t(256, 256),
        "final_layer.linear.weight": t(64, 256),
        "norm.scale": t(32),
        "tiny.weight": t(8, 8),
    }


def _convert_both(tmp_path, src, name, **kw):
    """Convert ``src`` with both packages into tmp_path/{ref,port}/name;
    the two files must be equal. Returns (ref path, port path)."""
    outs = []
    for sub, mod in (("ref", jconvert), ("port", convert)):
        d = tmp_path / sub
        d.mkdir(exist_ok=True)
        outs.append(mod.convert_file(src, str(d / name), **kw))
    _same_file(*outs)
    return outs


def _quantize_both(paths, ftype, name=None):
    outs = []
    for src, mod in zip(paths, (jquantize, quantize)):
        dst = (None if name is None
               else os.path.join(os.path.dirname(src), name))
        outs.append(mod.quantize_file(src, dst, ftype))
    _same_file(*outs)
    return outs


def _loads_like_reference(path):
    """The port's loader dequantizes every tensor of ``path`` bit for bit
    like the reference's, and the planar leaves it builds for the card's
    kernels dequantize to the same float32 values."""
    want = j_loader(path)
    got = gguf_sd_loader(path)
    assert set(got) == set(want)
    for k in want:
        assert got[k].qtype == int(want[k].qtype), k
        np.testing.assert_array_equal(got[k].dequantize(np.float32),
                                      want[k].dequantize(np.float32), k)
    params = to_torch_params(got, device="cpu")
    for k, p in params.items():
        if isinstance(p, PlanarQuant):
            np.testing.assert_array_equal(
                planar.dequantize(p).numpy(),
                want[k].dequantize(np.float32).reshape(p.shape), k)
    return params


# --------------------------------------------------------------------------
# convert
# --------------------------------------------------------------------------

def test_convert_dtype_policy(tmp_path):
    src = _save(_flux_like_sd(np.random.default_rng(0)),
                tmp_path / "model.safetensors")
    _, out = _convert_both(tmp_path, src, "m-F16.gguf")
    r = GGUFReader(out)
    by_name = {t.name: t for t in r.tensors}
    assert by_name["double_blocks.0.img_attn.proj.weight"].qtype == Q.F16
    assert by_name["double_blocks.0.img_attn.proj.bias"].qtype == Q.F32
    assert by_name["tiny.weight"].qtype == Q.F32
    assert r.get_int("general.file_type") == int(F.MOSTLY_F16)
    assert r.get_str("general.architecture") == "flux"
    _loads_like_reference(out)


def test_convert_reads_torch_checkpoints(tmp_path):
    """.ckpt through torch.load(weights_only=True): the wrapper dict and
    the model.diffusion_model. prefix go, bf16 widens to f32."""
    sd = _flux_like_sd(np.random.default_rng(3))
    ck = {"state_dict": {
        "model.diffusion_model." + k: torch.from_numpy(v).to(torch.bfloat16)
        if v.ndim == 2 else torch.from_numpy(v) for k, v in sd.items()}}
    src = tmp_path / "model.ckpt"
    torch.save(ck, str(src))
    got = convert.load_state_dict(str(src))
    want = jconvert.load_state_dict(str(src))
    assert list(got) == list(want) == list(sd)
    for k in sd:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    _convert_both(tmp_path, str(src), "m-BF16.gguf", use_bf16_base=True)


def test_quantize_mixed_precision_rules(tmp_path):
    src = _save(_flux_like_sd(np.random.default_rng(1)),
                tmp_path / "model.safetensors")
    f16 = _convert_both(tmp_path, src, "m-F16.gguf")
    _, q = _quantize_both(f16, "Q4_K_M", "m-Q4_K_M.gguf")
    by_name = {t.name: t for t in GGUFReader(q).tensors}
    assert by_name["double_blocks.0.img_attn.proj.weight"].qtype == Q.Q4_K
    assert by_name["double_blocks.0.img_attn.qkv.weight"].qtype == Q.Q5_K
    assert by_name["img_in.weight"].qtype == Q.F16
    assert by_name["time_in.in_layer.weight"].qtype == Q.F16
    assert by_name["final_layer.linear.weight"].qtype == Q.F16
    assert by_name["double_blocks.0.img_attn.proj.bias"].qtype == Q.F32
    loaded, arch = gguf_sd_loader(q, return_arch=True)
    assert arch == "flux"
    assert loaded["double_blocks.0.img_attn.qkv.weight"].qtype == Q.Q5_K
    _loads_like_reference(q)


@pytest.mark.parametrize("ftype,shape,name,want", [
    ("Q4_K_S", (64, 192), "blk.w.weight", Q.F16),  # row fallback
    ("Q4_0", (256, 256), "blk.0.ffn_down.weight", Q.Q4_1),
    ("Q4_K_M", (256, 256), "blk.0.attn_qkv.weight", Q.Q5_K),
    ("Q5_K_M", (256, 256), "a.ff.net.2.weight", Q.Q6_K),
])
def test_tensor_qtype_rules_match_reference(ftype, shape, name, want):
    qs, jqs = quantize.QuantState(), jquantize.QuantState()
    ft = quantize._FTYPE_BY_NAME[ftype]
    got = quantize.tensor_qtype(name, shape, ft, qs)
    ref = jquantize.tensor_qtype(
        name, shape, jquantize._FTYPE_BY_NAME[ftype], jqs)
    assert got == want and int(got) == int(ref)
    assert qs.n_fallback == jqs.n_fallback == int(want == Q.F16)


def test_qtype_attn_v_ladder():
    qs = quantize.QuantState()
    names = ["a.attn_v.weight", "b.attn_v.weight", "c.attn_v.weight",
             "d.attn_v.weight", "e.attn_v.weight"]
    types = [quantize.tensor_qtype(n, (256, 256), F.MOSTLY_Q4_K_S, qs)
             for n in names]
    assert types == [Q.Q5_K] * 4 + [Q.Q4_K]


@pytest.mark.parametrize("n_layers", [8, 26])
def test_use_more_bits_and_should_quantize_match_reference(n_layers):
    assert ([quantize._use_more_bits(i, n_layers) for i in range(n_layers)]
            == [jquantize._use_more_bits(i, n_layers)
                for i in range(n_layers)])
    for name, shape, arch in (
            ("enc.blk.0.attn_rel_b.weight", (32, 8), "t5"),
            ("img_in.weight", (256, 64), "flux"),
            ("double_blocks.0.img_attn.qkv.weight", (768, 256), "flux"),
            ("x_embedder.proj.weight", (64, 16, 2, 2), "sd3"),
            ("blk.0.ffn_up.bias", (256,), "llama"),
            ("blk.0.ffn_up.weight", (512, 256), "llama")):
        assert (quantize.should_quantize(name, shape, arch)
                == jquantize.should_quantize(name, shape, arch)), name


@pytest.mark.parametrize("ftype", ALL_FTYPES)
def test_every_ftype_preset_writes_the_reference_bytes(tmp_path, ftype):
    """Every preset of the quantizer's table gives the reference's file
    and loads back bit for bit; the IQ presets are refused for an image
    model by both."""
    src = _save(_flux_like_sd(np.random.default_rng(7)),
                tmp_path / "m.safetensors")
    f16 = _convert_both(tmp_path, src, "m-F16.gguf")
    if ftype in IQ_FTYPES:
        for path, mod in zip(f16, (jquantize, quantize)):
            with pytest.raises(ValueError, match="IQ"):
                mod.quantize_file(path, str(tmp_path / "x.gguf"), ftype)
        return
    _, out = _quantize_both(f16, ftype, f"m-{ftype}.gguf")
    params = _loads_like_reference(out)
    assert "double_blocks.0.img_attn.proj.weight" in params


def test_bf16_base_conversion_and_quantize(tmp_path):
    src = _save(_flux_like_sd(np.random.default_rng(5)),
                tmp_path / "model.safetensors")
    bf16 = _convert_both(tmp_path, src, "m-BF16.gguf", use_bf16_base=True)
    r = GGUFReader(bf16[1])
    by_name = {t.name: t for t in r.tensors}
    assert by_name["double_blocks.0.img_attn.proj.weight"].qtype == Q.BF16
    assert r.get_int("general.file_type") == int(F.MOSTLY_BF16)
    _, q = _quantize_both(bf16, "Q8_0", "m-Q8_0.gguf")
    byq = {t.name: t for t in GGUFReader(q).tensors}
    assert byq["double_blocks.0.img_attn.proj.weight"].qtype == Q.Q8_0
    # the default destination name drops the base's suffix
    outs = _quantize_both(bf16, "Q4_K_S")
    assert outs[1].endswith("m-Q4_K_S.gguf")


def _sd1_like_sd(rng):
    def t(*s):
        return rng.standard_normal(s).astype(np.float32)

    sd = {k: t(32, 32, 3, 3) for k in (
        "input_blocks.3.0.op.weight", "input_blocks.6.0.op.weight",
        "input_blocks.9.0.op.weight", "output_blocks.2.1.conv.weight",
        "output_blocks.5.2.conv.weight", "output_blocks.8.2.conv.weight",
    )}
    sd["input_blocks.1.1.proj_in.weight"] = t(64, 16, 3, 3)
    sd["input_blocks.1.1.to_q.weight"] = t(64, 320)
    sd["input_blocks.1.1.odd.weight"] = t(30, 33)
    return sd


def test_shape_fix_rearranges_convs_and_narrow_2d(tmp_path):
    src = _save(_sd1_like_sd(np.random.default_rng(7)),
                tmp_path / "model.safetensors")
    _, out = _convert_both(tmp_path, src, "m-F16.gguf")
    r = GGUFReader(out)
    by_name = {t.name: t for t in r.tensors}
    assert tuple(by_name["input_blocks.1.1.proj_in.weight"].shape) == \
        (9216 // 256, 256)
    assert r.get_orig_shape("input_blocks.1.1.proj_in.weight") == \
        (64, 16, 3, 3)
    assert tuple(by_name["input_blocks.1.1.to_q.weight"].shape) == \
        (20480 // 256, 256)
    assert r.get_orig_shape("input_blocks.1.1.to_q.weight") == (64, 320)
    assert tuple(by_name["input_blocks.1.1.odd.weight"].shape) == (30, 33)
    assert r.get_orig_shape("input_blocks.1.1.odd.weight") is None
    loaded = gguf_sd_loader(out)
    assert tuple(loaded["input_blocks.1.1.proj_in.weight"].shape) == \
        (64, 16, 3, 3)
    assert tuple(loaded["input_blocks.1.1.to_q.weight"].shape) == (64, 320)
    _, q = _quantize_both([str(tmp_path / s / "m-F16.gguf")
                           for s in ("ref", "port")], "Q5_0")
    _loads_like_reference(q)


# --------------------------------------------------------------------------
# the >4-D sidecar and fix_5d_tensors
# --------------------------------------------------------------------------

def test_fix_5d_roundtrip(tmp_path):
    rng = np.random.default_rng(2)
    w5 = rng.standard_normal((8, 4, 2, 3, 3)).astype(np.float32)
    w5b = rng.standard_normal((4, 4, 1, 2, 2)).astype(np.float32)
    sidecar = tmp_path / "fix_5d_tensors_wan.safetensors"
    # written out of name order: both tools append in the stored order
    _safetensors.save_file({"patch_embedding.weight": w5,
                            "a_patch.weight": w5b}, str(sidecar))
    w = GGUFWriter("wan")
    w.add_tensor("blocks.0.self_attn.q.weight",
                 rng.standard_normal((16, 16)).astype(np.float32))
    base = tmp_path / "wan-Q8_0.gguf"
    w.write_to_file(str(base))

    want = jfix5d.fix_file(str(base), str(sidecar),
                           str(tmp_path / "ref-5d.gguf"))
    out = fix_5d_tensors.fix_file(str(base), str(sidecar))
    assert out == str(tmp_path / "wan-Q8_0-5d.gguf")
    _same_file(want, out)
    sd = gguf_sd_loader(out, return_arch=False)
    got = sd["patch_embedding.weight"]
    assert got.shape == (8, 4, 2, 3, 3)
    np.testing.assert_array_equal(got.dequantize(np.float32), w5)


def test_wan_sidecar_convert_quantize_fix(tmp_path):
    """A Wan file with its 5-D patch embedding: convert dumps the sidecar,
    quantize, then fix_5d re-injects it — each step byte-identical to the
    reference, and the result loads with the 5-D shape."""
    nonblock, groups = testing.wan_shape_spec(testing.WanDims(
        dim=256, ffn_dim=512, n_heads=2, n_layers=2, in_ch=16,
        text_dim=256))
    sd = testing.random_flat_sd_from_spec(nonblock, groups, seed=4)
    src = _save(sd, tmp_path / "wan.safetensors")
    f16 = _convert_both(tmp_path, src, "wan-F16.gguf")
    side = [os.path.join(os.path.dirname(p), "fix_5d_tensors_wan.safetensors")
            for p in f16]
    got = _safetensors.load_file(side[1])
    assert list(got) == ["patch_embedding.weight"]
    np.testing.assert_array_equal(got["patch_embedding.weight"].numpy(),
                                  sd["patch_embedding.weight"])
    # a stale sidecar stops a second conversion before any work
    with pytest.raises(RuntimeError, match="already exists"):
        convert.convert_file(src, f16[1])
    q = _quantize_both(f16, "Q4_K_S")
    outs = [jfix5d.fix_file(q[0], side[0]), fix_5d_tensors.fix_file(q[1],
                                                                     side[1])]
    _same_file(*outs)
    loaded = gguf_sd_loader(outs[1])
    assert tuple(loaded["patch_embedding.weight"].shape) == \
        tuple(sd["patch_embedding.weight"].shape)
    _loads_like_reference(outs[1])


# --------------------------------------------------------------------------
# the text recipe and the refusals
# --------------------------------------------------------------------------

def _t5_f16(path, n_layers=8):
    w = GGUFWriter("t5")
    w.add_uint32("t5.attention.head_count", 8)
    w.add_uint32("t5.attention.head_count_kv", 2)

    def add(name, rows, cols):
        w.add_tensor(name, np.zeros((rows, cols), np.float16).tobytes(),
                     raw_dtype=Q.F16, raw_shape=(rows, cols))

    rng = np.random.default_rng(11)
    for i in range(n_layers):
        w.add_tensor(f"enc.blk.{i}.attn_v.weight",
                     rng.standard_normal((8, 256)).astype(np.float16)
                     .tobytes(), raw_dtype=Q.F16, raw_shape=(8, 256))
        add(f"enc.blk.{i}.ffn_down.weight", 8, 512)
    add("enc.blk.0.attn_q.weight", 8, 256)
    add("enc.blk.0.attn_qkv.weight", 24, 256)
    add("enc.blk.0.attn_output.weight", 8, 256)
    add("enc.blk.0.attn_rel_b.weight", 32, 8)
    add("enc.blk.0.ffn_gate.weight", 8, 160)
    add("token_embd.weight", 32, 256)
    add("output.weight", 32, 256)
    w.add_tensor("enc.blk.0.ffn_up.bias",
                 np.zeros(256, np.float32).tobytes(), raw_dtype=Q.F32,
                 raw_shape=(256,))
    w.write_to_file(str(path))
    return str(path)


def test_quantize_text_recipe(tmp_path):
    """Stock llama.cpp's rules for a T5 file at Q4_K_M, as the reference's
    test states them, and the reference's bytes."""
    paths = [_t5_f16(tmp_path / f"{s}-t5-F16.gguf") for s in ("ref", "port")]
    _, out = _quantize_both(paths, "Q4_K_M")
    got = {t.name: t.qtype for t in GGUFReader(out).tensors}
    bumped = {0, 3, 6, 7}
    for i in range(8):
        want = Q.Q6_K if i in bumped else Q.Q4_K
        assert got[f"enc.blk.{i}.attn_v.weight"] == want, (i, "attn_v")
        assert got[f"enc.blk.{i}.ffn_down.weight"] == want, (i, "ffn_down")
    assert got["enc.blk.0.attn_q.weight"] == Q.Q4_K
    assert got["enc.blk.0.attn_qkv.weight"] == Q.Q5_K
    assert got["enc.blk.0.attn_rel_b.weight"] == Q.F16
    assert got["enc.blk.0.ffn_gate.weight"] == Q.Q5_0
    assert got["token_embd.weight"] == Q.Q4_K
    assert got["output.weight"] == Q.Q6_K
    assert got["enc.blk.0.ffn_up.bias"] == Q.F32
    for t in GGUFReader(out).tensors:
        assert codecs.dequantize(t.data, t.qtype, t.shape).shape == \
            tuple(t.shape)


@pytest.mark.parametrize("ftype", ALL_FTYPES)
def test_text_recipe_every_ftype_writes_the_reference_bytes(tmp_path,
                                                           ftype):
    """The text recipe at every preset (the IQ ones included: text models
    take them), with a GQA ratio read from the metadata."""
    paths = [_t5_f16(tmp_path / f"{s}-t5-F16.gguf", n_layers=4)
             for s in ("ref", "port")]
    _, out = _quantize_both(paths, ftype)
    for t in GGUFReader(out).tensors:
        codecs.dequantize(t.data, t.qtype, t.shape)


def test_quantize_rejects_unknown_arch_and_missing_arch(tmp_path):
    w = GGUFWriter("mamba")
    w.add_tensor("blk.0.ssm_in.weight",
                 np.zeros((256, 256), np.float16).tobytes(),
                 raw_dtype=Q.F16, raw_shape=(256, 256))
    path = tmp_path / "mamba-F16.gguf"
    w.write_to_file(str(path))
    for mod in (jquantize, quantize):
        with pytest.raises(ValueError, match="unknown architecture"):
            mod.quantize_file(str(path), None, "Q8_0")
        with pytest.raises(KeyError):
            mod.quantize_file(str(path), None, "Q9_9")


# --------------------------------------------------------------------------
# qwen_image detection and the diffusers bans
# --------------------------------------------------------------------------

def _qwen_image_like_sd(rng):
    def t(*s):
        return rng.standard_normal(s).astype(np.float32)

    pfx = "transformer_blocks.0."
    return {
        pfx + "img_mod.1.weight": t(1536, 256),
        pfx + "txt_mod.1.weight": t(1536, 256),
        pfx + "attn.to_q.weight": t(256, 256),
        pfx + "attn.norm_q.weight": t(64),
        pfx + "attn.add_q_proj.weight": t(256, 256),
        pfx + "attn.norm_added_k.weight": t(64),
        pfx + "img_mlp.net.0.proj.weight": t(1024, 256),
        pfx + "img_mlp.net.2.weight": t(256, 1024),
        "img_in.weight": t(256, 64),
        "txt_in.weight": t(256, 512),
        "txt_norm.weight": t(512),
        "time_text_embed.timestep_embedder.linear_1.weight": t(256, 256),
        "norm_out.linear.weight": t(512, 256),
        "proj_out.weight": t(64, 256),
    }


def test_qwen_image_detect_and_convert(tmp_path):
    sd = _qwen_image_like_sd(np.random.default_rng(7))
    assert archs.detect_arch(sd.keys()).arch == "qwen_image"
    src = _save(sd, tmp_path / "model.safetensors")
    f16 = _convert_both(tmp_path, src, "m-F16.gguf")
    assert GGUFReader(f16[1]).get_str("general.architecture") == \
        "qwen_image"
    _, q = _quantize_both(f16, "Q4_K_S", "m-Q4_K_S.gguf")
    by_name = {t.name: t for t in GGUFReader(q).tensors}
    for k in ("img_in.weight", "txt_in.weight", "norm_out.linear.weight",
              "proj_out.weight",
              "time_text_embed.timestep_embedder.linear_1.weight"):
        assert by_name[k].qtype in (Q.F16, Q.F32), (k, by_name[k].qtype)
    assert by_name["transformer_blocks.0.attn.to_q.weight"].qtype \
        not in (Q.F16, Q.F32)
    loaded, arch = gguf_sd_loader(q, return_arch=True)
    assert arch == "qwen_image"
    _loads_like_reference(q)


def test_qwen_image_order_keeps_diffusers_bans(tmp_path):
    bans = ({"transformer_blocks.0.attn.norm_added_k.weight",
             "double_blocks.0.img_attn.proj.weight"},
            {"transformer_blocks.0.attn.add_q_proj.weight",
             "joint_blocks.0.x_block.attn.qkv.weight"})
    for keys in bans:
        with pytest.raises(archs.BannedArchitectureError):
            archs.detect_arch(keys)
        # the converter refuses such a file before writing anything
        src = _save({k: np.zeros((256, 256), np.float32) for k in keys},
                    tmp_path / "diffusers.safetensors")
        with pytest.raises(archs.BannedArchitectureError):
            convert.convert_file(src, str(tmp_path / "x.gguf"))
        assert not (tmp_path / "x.gguf").exists()


# --------------------------------------------------------------------------
# read_tensors, fix_lines_ending
# --------------------------------------------------------------------------

def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


@pytest.mark.parametrize("extra", [[], ["--all"]], ids=["default", "all"])
def test_read_tensors_prints_the_reference_text(tmp_path, extra):
    src = _save(_flux_like_sd(np.random.default_rng(9)),
                tmp_path / "model.safetensors")
    f16 = _convert_both(tmp_path, src, "m-F16.gguf")
    q = _quantize_both(f16, "Q4_K_M")
    for path in (f16[1], q[1]):
        got = _stdout(read_tensors.main, [path] + extra)
        assert got == _stdout(jread.main, [path] + extra)
        assert "census: " in got and "arch: flux" in got


def test_fix_lines_ending_matches_reference(tmp_path):
    for data in (b"a\r\nb\r\n", b"a\nb\n", b""):
        paths = []
        for sub, mod in (("ref", jfixle), ("port", fix_lines_ending)):
            p = tmp_path / f"{sub}.txt"
            p.write_bytes(data)
            assert mod.fix_file(str(p)) == (b"\r\n" in data)
            paths.append(p)
        assert paths[0].read_bytes() == paths[1].read_bytes()
    assert _stdout(fix_lines_ending.main, [str(paths[1])]) == \
        f"{paths[1]}: ok\n"


# --------------------------------------------------------------------------
# validate_checkpoint
# --------------------------------------------------------------------------

def _flat(nonblock, groups):
    out = dict(nonblock)
    for ok, (depth, suf) in groups.items():
        for i in range(depth):
            out.update({f"{ok}.{i}.{s}": sh for s, sh in suf.items()})
    return out


def _write(path, arch, sd, drop=(), extra=None, misshape=None):
    w = GGUFWriter(arch)
    for k, v in sd.items():
        if k in drop:
            continue
        if k == misshape:
            v = np.zeros((v.shape[0], v.shape[1] + 16) if v.ndim == 2
                         else (v.shape[0] + 8,), np.float32)
        w.add_tensor("model.diffusion_model." + k, np.asarray(v, np.float32))
    for k, v in (extra or {}).items():
        w.add_tensor("model.diffusion_model." + k, np.asarray(v, np.float32))
    w.write_to_file(str(path))
    return str(path)


def _same_report(path):
    got, want = V.validate(path), jV.validate(path)
    assert got.to_json() == want.to_json()
    return got


def test_shape_specs_match_state_dict_builders():
    dims = testing.TinyFluxDims()
    sd = testing.flux_state_dict(dims)
    flat = _flat(*testing.flux_shape_spec(dims))
    assert set(flat) == set(sd)
    for k in sd:
        assert tuple(flat[k]) == tuple(sd[k].shape), k
    sdims = testing.TinySD3Dims()
    ssd = testing.sd3_flat_state_dict(sdims)
    want = testing.sd3_shape_spec(sdims)
    assert set(want) == set(ssd)
    for k in ssd:
        assert tuple(want[k]) == tuple(ssd[k].shape), k


def test_validate_checkpoint_clean_and_injected_errors(tmp_path):
    sd = testing.flux_state_dict(testing.TinyFluxDims(), seed=0)
    rep = _same_report(_write(tmp_path / "clean.gguf", "flux", sd))
    assert rep.ok and rep.arch == "flux" and rep.spec == "full"
    assert not (rep.missing or rep.unexpected or rep.misshaped
                or rep.blocked)
    bad = _same_report(_write(
        tmp_path / "bad.gguf", "flux", sd,
        drop=("double_blocks.0.img_attn.proj.weight",
              "single_blocks.1.linear2.bias"),
        extra={"double_blocks.0.bogus.weight": np.zeros((4, 4))},
        misshape="double_blocks.1.txt_mlp.0.weight"))
    assert not bad.ok
    assert bad.missing == ["double_blocks.0.img_attn.proj.weight"]
    assert bad.missing_bias == ["single_blocks.1.linear2.bias"]
    assert bad.unexpected == ["double_blocks.0.bogus.weight"]
    assert [m[0] for m in bad.misshaped] == [
        "double_blocks.1.txt_mlp.0.weight"]


def test_validate_checkpoint_cli_exit_codes(tmp_path):
    sd = testing.flux_state_dict(testing.TinyFluxDims(), seed=0)
    clean = _write(tmp_path / "c.gguf", "flux", sd)
    broken = _write(tmp_path / "b.gguf", "flux", sd,
                    drop=("double_blocks.0.img_attn.proj.weight",))
    text = _t5_f16(tmp_path / "t5.gguf", n_layers=2)
    for args, rc in (([clean], 0), ([clean, "--json"], 0), ([broken], 1),
                     ([broken, "--json"], 1), ([text], 2),
                     ([str(tmp_path / "missing.gguf")], 2)):
        outs = []
        for mod in (jV, V):
            buf, err = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(buf), \
                    contextlib.redirect_stderr(err):
                assert mod.main(args) == rc, (args, mod)
            outs.append((buf.getvalue(), err.getvalue()))
        assert outs[0] == outs[1], args


def test_validate_checkpoint_blocked_iq(tmp_path):
    sd = testing.flux_state_dict(testing.TinyFluxDims(), seed=1)
    key = "double_blocks.0.img_attn.qkv.weight"
    block, type_size = GGML_QUANT_SIZES[Q.IQ2_XS]
    w = GGUFWriter("flux")
    for k, v in sd.items():
        if k == key:
            w.add_tensor("model.diffusion_model." + k,
                         np.zeros((v.size // block, type_size), np.uint8),
                         raw_dtype=Q.IQ2_XS, raw_shape=v.shape)
        else:
            w.add_tensor("model.diffusion_model." + k,
                         np.asarray(v, np.float32))
    p = tmp_path / "iqflux.gguf"
    w.write_to_file(str(p))
    rep = _same_report(str(p))
    assert rep.blocked == [(key, "IQ2_XS")]
    assert not rep.ok and not rep.missing and not rep.misshaped
    assert not codecs.can_decode(Q.IQ2_XS)


# each arch's spec from the port's own builders, at widths 256-512
_ARCH_SPECS = {
    "flux": lambda: testing.flux_shape_spec(testing.TinyFluxDims(
        hidden=256, heads=2, ctx=256, vec=256, in_ch=16)),
    "flux_schnell": lambda: testing.flux_shape_spec(
        testing.TinyFluxDims(hidden=256, heads=2, ctx=256, vec=256),
        guidance=False),
    "sd3": lambda: (testing.sd3_shape_spec(testing.TinySD3Dims(
        hidden=256, heads=2, ctx_dim=256, pooled=256)), {}),
    "qwen_image": lambda: testing.qwen_image_shape_spec(
        testing.QwenImageDims(hidden=256, n_heads=2, context_dim=256)),
    "hidream": lambda: testing.hidream_shape_spec(testing.TinyHiDreamDims(
        hidden=256, heads=2, ffn=512, t5_dim=256, llama_dim=256,
        pooled=256)),
    "wan": lambda: testing.wan_shape_spec(testing.WanDims(
        dim=256, ffn_dim=512, n_heads=2, text_dim=256)),
    "hyvid": lambda: testing.hyvid_shape_spec(testing.HyVidDims(
        hidden=256, n_heads=2, text_dim=256)),
    "ltxv": lambda: testing.ltxv_shape_spec(testing.LTXVDims(
        dim=256, caption_dim=256)),
    "cosmos": lambda: testing.cosmos_shape_spec(testing.CosmosDims(
        dim=256, n_heads=2, text_dim=256)),
    "aura": lambda: testing.aura_shape_spec(testing.AuraDims(
        hidden=256, mlp=512, cond_dim=256)),
    "lumina2": lambda: testing.lumina2_shape_spec(testing.Lumina2Dims(
        dim=256, n_heads=2, ffn=512, cap_dim=256)),
}


def _spec_sd(case):
    nonblock, groups = _ARCH_SPECS[case]()
    sd = testing.random_flat_sd_from_spec(nonblock, groups, seed=2)
    block = sorted(k for k, v in sd.items() if v.ndim == 2
                   and k.split(".")[0] in ("joint_blocks", *groups))
    return case.split("_schnell")[0], sd, block


def _write_spec(path, arch, sd, drop=(), extra=None, misshape=None):
    """``sd`` as a GGUF the way the converter and the quantizer leave it: a
    >4-D kernel stored 4-D with its shape in metadata, the 2-D weights a
    published file quantizes in Q4_K."""
    w = GGUFWriter(arch)
    for k, v in list(sd.items()) + list((extra or {}).items()):
        if k in drop:
            continue
        if k == misshape:
            v = np.zeros((v.shape[0], v.shape[1] + 256), np.float32)
        name = "model.diffusion_model." + k
        q = testing.published_qtype(arch, k, v.shape, Q.Q4_K)
        if v.ndim > 4:
            w.add_tensor(name, v.reshape(-1, *v.shape[-3:]))
            w.add_array(f"comfy.gguf.orig_shape.{name}",
                        [int(d) for d in v.shape], GGUFValueType.INT32)
        elif q is None:
            w.add_tensor(name, np.asarray(v, np.float32))
        else:
            w.add_tensor(name, codecs.quantize(v, q), raw_dtype=q,
                         raw_shape=v.shape)
    w.write_to_file(str(path))
    return str(path)


@pytest.mark.parametrize("case", sorted(_ARCH_SPECS))
def test_validate_checkpoint_arch_spec_matches_reference(tmp_path, case):
    """Each architecture's clean file validates "full" and clean in both
    packages, and a dropped block weight, a misshaped one and an extra key
    give the same report."""
    arch, sd, block = _spec_sd(case)
    rep = _same_report(_write_spec(tmp_path / "clean.gguf", arch, sd))
    assert rep.arch == arch and rep.spec == "full", rep.to_json()
    assert rep.ok and not (rep.missing or rep.unexpected or rep.misshaped)
    drop, bent = block[0], block[-1]
    bad = _same_report(_write_spec(
        tmp_path / "bad.gguf", arch, sd, drop=(drop,), misshape=bent,
        extra={"bogus.weight": np.zeros((4, 4), np.float32)}))
    assert not bad.ok and bad.missing == [drop], bad.to_json()
    assert [m[0] for m in bad.misshaped] == [bent]
    assert bad.unexpected == ["bogus.weight"]


def test_validate_checkpoint_hidream_variants(tmp_path):
    """Routed experts narrower than the shared one and a third caption
    projection validate clean; a misshaped attention weight fails."""
    d = testing.TinyHiDreamDims()
    sd = testing.random_flat_sd_from_spec(*testing.hidream_shape_spec(d),
                                          seed=3)
    for k in list(sd):
        if ".ff_i.experts." in k:
            if k.endswith((".w1.weight", ".w3.weight")):
                sd[k] = sd[k][: d.ffn // 2]
            elif k.endswith(".w2.weight"):
                sd[k] = sd[k][:, : d.ffn // 2]
    sd["caption_projection.2.linear.weight"] = np.zeros(
        (d.hidden, d.llama_dim), np.float32)
    rep = _same_report(_write(tmp_path / "hid.gguf", "hidream", sd))
    assert rep.ok and rep.spec == "full"
    bad = _same_report(_write(
        tmp_path / "hidbad.gguf", "hidream", sd,
        misshape="single_stream_blocks.0.block.attn1.to_q.weight"))
    assert [m[0] for m in bad.misshaped] == [
        "single_stream_blocks.0.block.attn1.to_q.weight"]


def test_validate_checkpoint_structural_and_anchor(tmp_path):
    """sd3.5-medium (dual attention) is checked structurally; a file
    missing the keys its config is read from reports the anchor."""
    dims = testing.TinySD3Dims(dual_prefix=1)
    sd = testing.sd3_flat_state_dict(dims, seed=1)
    rep = _same_report(_write(tmp_path / "med.gguf", "sd3", sd))
    assert rep.spec == "structural" and rep.ok
    sd = testing.flux_state_dict(testing.TinyFluxDims(), seed=0)
    rep = _same_report(_write(tmp_path / "anchor.gguf", "flux", sd,
                              drop=("img_in.weight",)))
    assert not rep.ok and rep.missing[0].startswith("<config anchor>")


# --------------------------------------------------------------------------
# the whole path: safetensors → BF16 → Q4_K_M → validate → load → forward
# --------------------------------------------------------------------------

def test_user_path_to_a_forward_on_the_cpu(tmp_path):
    """A flux file at width 512 through both toolchains (the same bytes at
    each step), validated clean, then loaded by the port's
    load_diffusion_model on the CPU: its planar weights equal the file's
    payload dequantized, and one forward is finite."""
    from comfyui_gguf_tpu_torch.pipeline import load_diffusion_model

    dims = testing.TinyFluxDims(hidden=512, heads=4, ctx=256, vec=256,
                                in_ch=16, depth_double=1, depth_single=1,
                                axes_dim=(16, 56, 56))
    sd = testing.flux_state_dict(dims, seed=5)
    root = tmp_path / "models"
    (root / "diffusion_models").mkdir(parents=True)
    src = _save({k: torch.from_numpy(v).to(torch.bfloat16).float().numpy()
                 for k, v in sd.items()},
                root / "diffusion_models" / "flux-tiny.safetensors")
    bf16 = _convert_both(tmp_path, src, "flux-tiny-BF16.gguf",
                         use_bf16_base=True)
    q = _quantize_both(bf16, "Q4_K_M")
    assert q[1].endswith("flux-tiny-Q4_K_M.gguf")
    rep = _same_report(q[1])
    assert rep.ok and not rep.unexpected
    model = load_diffusion_model(q[1], "cpu")
    reader = GGUFReader(q[1])
    payload = {t.name: t for t in reader.tensors}
    seen = set()
    for k, p in model.params.items():
        if isinstance(p, PlanarQuant):
            t = payload[k]
            seen.add(Q(t.qtype))
            np.testing.assert_array_equal(
                planar.dequantize(p).numpy(),
                codecs.dequantize(t.data, t.qtype, t.shape))
    assert seen == {Q.Q4_K, Q.Q5_K}
    inputs = testing.flux_example_inputs(dims, h_lat=8, w_lat=8, txt_len=8,
                                         seed=1, device="cpu")
    with torch.no_grad():
        out = model.forward(*inputs)
    assert out.shape == inputs[0].shape and bool(torch.isfinite(out).all())
