"""The port's Qwen-VL vision tower (``models/qwen_vl_vision.py``), its
mmproj sidecar loader (``loader.find_mmproj`` / ``gguf_mmproj_loader``) and
``pipeline.qwen_vl_encode_with_image`` against the reference, on the CPU.

A tiny tower (160 wide, 2 heads of 80, 2 blocks, patches of 4 over 2
frames, merged to 128) runs in both packages on the same numpy state dict,
as Qwen2.5-VL (RMS norms, SwiGLU, window attention with one full block) and
Qwen2-VL (LayerNorms, quick-GELU, every block full), on a 64² image (16×16
patches, 2×2 windows of 4×4 merged cells). A qwen2vl text GGUF (2 layers,
Q8_0, q/k/v biases) and its mmproj sidecar (split q/k/v, the patch kernel
in two temporal chunks, F16 linears) are written by the port's writers and
loaded by both packages: the same keys, shapes and bit-equal values. The
image splice runs on that encoder: the same M-RoPE position streams as
the reference's, and the same states as the port's own encode of the
spliced embeddings, bit for bit.

Tolerances (relative L2). Both packages run the tower's activations in
bfloat16 (the reference casts them after the float32 patch embed) and the
encoder in bfloat16, so the two packages' float32 sums, in another order,
move bf16 roundings, and the tower's attention carries them on: the 2-block
tower reads 3.7e-3 (2.5) and 4.3e-3 (2.0) against the reference, one that
drops the window mask 2.9e-2 and one fed transposed patches 0.51.
``TOWER_TOL`` is 1e-2, and a control test holds those two faults above it.
The encoder states take the llama graph's bfloat16 limit
(``test_torch_llama.py``), 2e-2.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_gguf_tpu import loader as jloader
from comfyui_gguf_tpu import pipeline as jpipeline
from comfyui_gguf_tpu.models import qwen_vl_vision as jvision
from comfyui_gguf_tpu.nn.layers import QuantConfig as JQuantConfig
from comfyui_gguf_tpu_torch import loader as tloader
from comfyui_gguf_tpu_torch import pipeline as tpipeline
from comfyui_gguf_tpu_torch.gguf.constants import GGMLQuantizationType as Q
from comfyui_gguf_tpu_torch.interop import params_from_numpy
from comfyui_gguf_tpu_torch.models import qwen_vl_vision as vision
from comfyui_gguf_tpu_torch.models import testing
from comfyui_gguf_tpu_torch.nn.layers import QuantConfig

torch.set_num_threads(2)

VDIMS = testing.QwenVLVisionDims(dim=160, n_layers=2, out_dim=128,
                                 intermediate=320, patch=4)
LDIMS = testing.LlamaDims(hidden=128, n_layers=2, n_heads=32, n_kv_heads=8,
                          head_dim=4, intermediate=256, vocab=300,
                          qkv_bias=True)
F32 = QuantConfig(dequant_dtype=torch.float32, compute_dtype=torch.float32)
JF32 = JQuantConfig(dequant_dtype=jnp.float32, compute_dtype=jnp.float32,
                    prefer_pallas=False)
TOWER_TOL = 1e-2
TOL_BF16 = 2e-2
PAD_ID = 299


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _image(seed, side=64):
    return np.random.default_rng(seed).random((side, side, 3)).astype(
        np.float32)


@pytest.mark.parametrize("v25", [True, False], ids=["2.5", "2.0"])
def test_tower_matches_reference(v25):
    sd = testing.qwen_vl_vision_state_dict(
        dataclasses.replace(VDIMS, v25=v25), seed=3)
    jp = {k: jnp.asarray(v) for k, v in sd.items()}
    cfg = vision.QwenVLVisionConfig.from_state_dict(sd)
    jcfg = jvision.QwenVLVisionConfig.from_state_dict(jp)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.n_heads == 2 and cfg.use_window_attention == v25
    assert cfg.patch_size == 4 and cfg.temporal_patch == 2
    cfg = dataclasses.replace(cfg, fullatt_block_indexes=(1,))
    jcfg = dataclasses.replace(jcfg, fullatt_block_indexes=(1,))
    patches = vision.extract_patches(_image(1), patch=4, temporal=2)
    assert patches.shape == (16, 16, 3 * 2 * 4 * 4)
    want = np.asarray(jvision.forward(jp, jcfg, jnp.asarray(patches),
                                      qcfg=JF32), np.float32)
    got = vision.forward(params_from_numpy(sd, "cpu"), cfg,
                         torch.from_numpy(patches), qcfg=F32)
    assert got.shape == (64, 128)
    assert _rel(got.float(), want) < TOWER_TOL


@pytest.mark.parametrize("fault", ["no_window_mask", "transposed_patches"])
def test_tower_limit_fails_faulted_towers(fault):
    """The control of ``TOWER_TOL``: the 2.5 tower without its window mask
    (the 64² image spans 2×2 windows), or fed its patch grid transposed,
    reads above the limit against the reference."""
    sd = testing.qwen_vl_vision_state_dict(VDIMS, seed=3)
    jp = {k: jnp.asarray(v) for k, v in sd.items()}
    cfg = dataclasses.replace(vision.QwenVLVisionConfig.from_state_dict(sd),
                              fullatt_block_indexes=(1,))
    jcfg = dataclasses.replace(jvision.QwenVLVisionConfig.from_state_dict(jp),
                               fullatt_block_indexes=(1,))
    patches = vision.extract_patches(_image(1), patch=4, temporal=2)
    want = np.asarray(jvision.forward(jp, jcfg, jnp.asarray(patches),
                                      qcfg=JF32), np.float32)
    if fault == "no_window_mask":
        cfg = dataclasses.replace(cfg, use_window_attention=False)
    else:
        patches = np.ascontiguousarray(patches.transpose(1, 0, 2))
    got = vision.forward(params_from_numpy(sd, "cpu"), cfg,
                         torch.from_numpy(patches), qcfg=F32)
    assert _rel(got.float(), want) > TOWER_TOL


@pytest.mark.parametrize("h,w,merge,cells", [(8, 8, 2, 2), (16, 16, 2, 4),
                                             (12, 20, 2, 4), (6, 10, 2, 2)])
def test_window_ids_match_reference(h, w, merge, cells):
    got = vision._window_ids(h, w, merge, cells)
    np.testing.assert_array_equal(got, jvision._window_ids(h, w, merge,
                                                           cells))
    assert got.dtype == np.int32


@pytest.mark.parametrize("side,patch,temporal", [(8, 4, 2), (28, 14, 2),
                                                 (30, 14, 2), (12, 4, 1)])
def test_extract_patches_matches_reference(side, patch, temporal):
    img = np.random.default_rng(side).random((side, side + patch, 3)).astype(
        np.float32)
    got = vision.extract_patches(img, patch, temporal)
    np.testing.assert_array_equal(got, jvision.extract_patches(
        img, patch, temporal))
    # channel-major, then temporal: channel c's slice is the image's channel
    vec = got[0, 0].reshape(3, temporal, patch * patch)
    np.testing.assert_array_equal(vec[1, -1], img[:patch, :patch, 1].ravel())


def test_rope_2d_matches_reference():
    cos, sin = vision._rope_2d(6, 10, 80)
    jcos, jsin = jvision._rope_2d(6, 10, 80)
    np.testing.assert_array_equal(cos.numpy(), np.asarray(jcos))
    np.testing.assert_array_equal(sin.numpy(), np.asarray(jsin))


@pytest.mark.parametrize("name", [
    "Qwen2.5-VL-7B-Instruct-Q8_0", "qwen2.5-vl-7b-instruct-Q4_K_M",
    "Qwen2.5-VL-7B-Instruct-UD-Q4_K_XL", "model_iq4_xs", "plain-name",
    "Qwen2.5-VL-7B-Instruct-BF16"])
def test_strip_quant_suffix_matches_reference(name):
    assert tloader.strip_quant_suffix(name) == jloader.strip_quant_suffix(
        name)


@pytest.mark.parametrize("files,want", [
    (("Qwen2.5-VL-7B-Instruct-Q8_0.gguf",
      "mmproj-Qwen2.5-VL-7B-Instruct-F16.gguf"),
     "mmproj-Qwen2.5-VL-7B-Instruct-F16.gguf"),
    (("Qwen2.5-VL-7B-Instruct-Q8_0.gguf", "mmproj-other-F16.gguf"), None),
    (("Qwen2.5-VL-7B-Instruct-Q8_0.gguf",
      "b-mmproj-Qwen2.5-VL-7B-Instruct.gguf",
      "a-mmproj-Qwen2.5-VL-7B-Instruct.gguf"),
     "a-mmproj-Qwen2.5-VL-7B-Instruct.gguf"),
    (("Qwen2.5-VL-7B-Instruct-Q8_0.gguf",
      "mmproj-Qwen2.5-VL-7B-Instruct.bin"), None),
])
def test_find_mmproj_matches_reference(tmp_path, files, want):
    for f in files:
        (tmp_path / f).write_bytes(b"")
    path = str(tmp_path / files[0])
    got = tloader.find_mmproj(path)
    assert got == jloader.find_mmproj(path)
    assert got == (None if want is None else str(tmp_path / want))


@pytest.fixture(scope="module")
def qwen2vl(tmp_path_factory):
    """A qwen2vl text GGUF with its mmproj sidecar beside it → its path."""
    d = tmp_path_factory.mktemp("qwen2vl")
    path = str(d / "Qwen2.5-VL-tiny-Q8_0.gguf")
    testing.write_llama_gguf(testing.llama_state_dict(LDIMS, seed=4), path,
                             qtype=Q.Q8_0, tokenizer=testing.bpe_spec(300),
                             arch="qwen2vl")
    testing.write_mmproj_gguf(testing.qwen_vl_vision_state_dict(VDIMS,
                                                                seed=5),
                              str(d / "mmproj-Qwen2.5-VL-tiny-F16.gguf"))
    return path


def test_mmproj_loader_matches_reference(qwen2vl):
    """The merged sidecar: the same keys and shapes as the reference's, the
    patch kernel 5-D and the qkv fused (float32, bit-equal), and the same
    placed values."""
    sd, arch, _ = tloader.gguf_clip_loader(qwen2vl)
    jsd, jarch, _ = jloader.gguf_clip_loader(qwen2vl)
    assert arch == jarch == "qwen2vl"
    assert set(sd) == set(jsd)
    vis = sorted(k for k in sd if k.startswith("visual."))
    assert set(vis) == set(testing.qwen_vl_vision_state_dict(VDIMS))
    assert sd["visual.patch_embed.proj.weight"].shape == (160, 3, 2, 4, 4)
    assert sd["visual.blocks.1.attn.qkv.weight"].qtype == Q.F32
    for k in vis:
        assert tuple(sd[k].shape) == tuple(jsd[k].shape), k
        np.testing.assert_array_equal(sd[k].dequantize(),
                                      jsd[k].dequantize())
    want = testing.qwen_vl_vision_state_dict(VDIMS, seed=5)
    np.testing.assert_array_equal(
        sd["visual.blocks.0.attn.qkv.bias"].dequantize(),
        want["visual.blocks.0.attn.qkv.bias"])
    p = tloader.to_torch_params({k: sd[k] for k in vis}, device="cpu")
    jp = jloader.to_jax_params({k: jsd[k] for k in vis})
    for k in vis:
        np.testing.assert_array_equal(p[k].float().numpy(),
                                      np.asarray(jp[k], np.float32))


def test_no_sidecar_loads_without_vision(tmp_path):
    path = str(tmp_path / "alone-Q8_0.gguf")
    testing.write_llama_gguf(testing.llama_state_dict(LDIMS, seed=4), path,
                             qtype=Q.Q8_0, arch="qwen2vl")
    sd, arch, _ = tloader.gguf_clip_loader(path)
    assert arch == "qwen2vl"
    assert not any(k.startswith("visual.") for k in sd)


@pytest.fixture(scope="module")
def encoders(qwen2vl):
    return (tpipeline.load_text_encoder(qwen2vl, device="cpu"),
            jpipeline.load_text_encoder(qwen2vl))


def test_load_text_encoder_qwen2vl(encoders):
    """A qwen2vl file loads into the llama graph with the reference's
    config reading (32 heads by default) and keeps the vision tower; its
    plain encode matches the reference's."""
    enc, jenc = encoders
    assert enc.kind == jenc.kind == "llama"
    assert dataclasses.asdict(enc.config) == dataclasses.asdict(jenc.config)
    assert enc.config.n_heads == 32 and enc.tokenizer is not None
    assert "visual.merger.mlp.2.weight" in enc.params
    assert "model.layers.0.self_attn.q_proj.bias" in enc.params
    ids = np.random.default_rng(2).integers(0, 290, (1, 12))
    got = enc.encode(torch.from_numpy(ids))["last_hidden"]
    want = jenc.encode(jnp.asarray(ids))["last_hidden"]
    assert _rel(got.float(), np.asarray(want, np.float32)) < TOL_BF16


def _pad_ids(n_img, before=3, after=5, seed=6):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 290, (1, before + n_img + after))
    ids[0, before: before + n_img] = PAD_ID
    return ids


def _capture_positions(monkeypatch, mod):
    seen = {}
    enc_fn = mod.TextEncoder.encode

    def spy(self, *a, **kw):
        seen.setdefault("pos", np.asarray(kw.get("position_ids")))
        return enc_fn(self, *a, **kw)

    monkeypatch.setattr(mod.TextEncoder, "encode", spy)
    return seen


def test_encode_with_image_matches_reference(encoders, monkeypatch):
    """The spliced encode: equal (3, B, L) position streams, the final
    states within the bf16 limit of the reference's and equal to the port's
    own encode of the hand-spliced embeddings."""
    enc, jenc = encoders
    img = _image(8, side=32)  # 8×8 patches → 16 merged tokens
    ids = _pad_ids(16)
    seen_t = _capture_positions(monkeypatch, tpipeline)
    got = tpipeline.qwen_vl_encode_with_image(enc, enc.params, ids, img,
                                              PAD_ID)["last_hidden"]
    seen_j = _capture_positions(monkeypatch, jpipeline)
    want = jpipeline.qwen_vl_encode_with_image(jenc, jenc.params, ids, img,
                                               PAD_ID)["last_hidden"]
    np.testing.assert_array_equal(seen_t["pos"], seen_j["pos"])
    assert seen_t["pos"][1, 0, 3:19].max() == 3 + 3  # a 4×4 grid at offset 3
    assert got.shape == (1, ids.shape[1], LDIMS.hidden)
    assert _rel(got.float(), np.asarray(want, np.float32)) < TOL_BF16
    # the splice by hand: the tower's tokens over the pad ids
    vcfg = vision.QwenVLVisionConfig.from_state_dict(enc.params)
    vis = vision.forward(enc.params, vcfg, torch.from_numpy(
        vision.extract_patches(img, 4, 2)), qcfg=enc.qcfg)
    emb = enc.params["model.embed_tokens.weight"][torch.from_numpy(ids)]
    emb = emb.float()
    emb[0, 3:19] = vis.float()
    hand = enc.encode(torch.from_numpy(ids), inputs_embeds=emb,
                      position_ids=torch.from_numpy(seen_t["pos"]))
    assert torch.equal(got, hand["last_hidden"])
    plain = enc.encode(torch.from_numpy(ids))["last_hidden"]
    assert _rel(got.float(), plain.float()) > 10 * TOL_BF16  # the image


@pytest.mark.parametrize("n_pad", [15, 17])
def test_encode_with_image_count_mismatch_raises(encoders, n_pad):
    enc, _ = encoders
    with pytest.raises(ValueError, match="image_pad tokens"):
        tpipeline.qwen_vl_encode_with_image(enc, enc.params, _pad_ids(n_pad),
                                            _image(8, side=32), PAD_ID)
