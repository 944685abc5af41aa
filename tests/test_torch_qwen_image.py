"""The port's Qwen-Image MMDiT (``models/qwen_image.py``),
``QwenImagePipeline`` (``generate``, ``generate_edit``) and
``qwen_image_engine`` against the reference, on the CPU.

A tiny Qwen-Image (hidden 512, 4 heads of 128, 2 blocks, 64 input features,
context 128) is written as Q4_K and Q8_0 GGUFs by the port's writer,
quantized the way a published file is (the embedders, ``txt_norm``,
``norm_out`` and ``proj_out`` stay float), and loaded by both packages.
Checked: config detection (the (16, 56, 56) RoPE split at head dim 128);
``forward`` planar in float32 and bfloat16; ``forward_stacked`` (the port's
stacking and the reference's stacked tree carried across) equal to
``forward``; the w8a8 tree with the modulations kept planar; the pipeline
(a 2-layer qwen2vl encoder GGUF with its mmproj sidecar) with the
reference's noise, text to image and edit (two reference latents, and the
conditioning from ``qwen_vl_encode_with_image``); the engine against the
reference's engine and the direct Euler sampler, flat and stacked. These
mirror ``tests/test_cosmos_qwen.py::test_qwen_image`` and the non-TP tests
of ``tests/test_qwen_image_engine.py``.

Tolerances (relative L2): 3e-4 for the planar trees in float32 (the same
products in another order: read 4.3e-7), 2e-2 in bfloat16, 1.5e-2 · max(1,
cfg) for CFG latents against the reference, 1e-2 for a served request
against the direct sampler (as ``test_torch_lumina2.py``), and
``W8A8_TOL`` = 1e-4 for the w8a8 tree in float32: the port reads 4.3e-7
against the reference's tree converted with the same predicate (no int8
activation code lands a step off at this size), while a conversion that
skips the activation rounding reads 7.0e-4 and one that converts the
modulations 5.2e-4 (the w8a8 tree's own distance from the planar one is
9.0e-4); a control test holds both faults above the limit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_gguf_tpu import pipeline as jpipeline
from comfyui_gguf_tpu.loader import gguf_sd_loader as j_sd_loader
from comfyui_gguf_tpu.loader import to_jax_params
from comfyui_gguf_tpu.models import flux as jflux
from comfyui_gguf_tpu.models import qwen_image as jqi
from comfyui_gguf_tpu.nn.layers import QuantConfig as JQuantConfig
from comfyui_gguf_tpu.quant import i8 as ji8
from comfyui_gguf_tpu_torch import pipeline as tpipeline
from comfyui_gguf_tpu_torch.gguf.constants import GGMLQuantizationType as Q
from comfyui_gguf_tpu_torch.interop import params_from_numpy
from comfyui_gguf_tpu_torch.models import qwen_image, testing
from comfyui_gguf_tpu_torch.models.flux import make_img_ids
from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
from comfyui_gguf_tpu_torch.quant.i8 import I8Planar, is_modulation_key
from comfyui_gguf_tpu_torch.quant.planar import PlanarQuant
from comfyui_gguf_tpu_torch.sampling import linear_schedule, sample_flow

torch.set_num_threads(2)

DIMS = testing.QwenImageDims(hidden=512, n_heads=4, n_layers=2, in_ch=64,
                             context_dim=128)
B, H_TOK, TXT_LEN = 2, 4, 7
F32 = (QuantConfig(dequant_dtype=torch.float32, compute_dtype=torch.float32),
       JQuantConfig(dequant_dtype=jnp.float32, compute_dtype=jnp.float32,
                    prefer_pallas=False), np.float32, 3e-4)
BF16 = (QuantConfig(), JQuantConfig(prefer_pallas=False), "bfloat16", 2e-2)
W8A8_TOL = 1e-4
PAD_ID = 299


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _cfg_tol(cfg):
    return 1.5e-2 * max(1.0, cfg)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("qwen_image")
    sd = testing.random_flat_sd_from_spec(
        *testing.qwen_image_shape_spec(DIMS), seed=0)
    out = {}
    for qtype in (Q.Q4_K, Q.Q8_0):
        out[qtype] = str(d / f"qwen_image_{qtype.name}.gguf")
        testing.write_spec_gguf(sd, out[qtype], "qwen_image", qtype)
    return out


def _trees(path):
    jp = to_jax_params(j_sd_loader(path), JQuantConfig())
    return jp, tpipeline.load_diffusion_model(path, device="cpu")


def _inputs(np_dtype, seed=5):
    rng = np.random.default_rng(seed)
    L = H_TOK * H_TOK
    img = rng.standard_normal((B, L, DIMS.in_ch))
    txt = rng.standard_normal((B, TXT_LEN, DIMS.context_dim))
    img_ids = np.array(make_img_ids(H_TOK, H_TOK, B))
    txt_ids = np.zeros((B, TXT_LEN, 3), np.int32)
    t = np.asarray([1.0, 0.5], np.float32)
    tdt = torch.float32 if np_dtype == np.float32 else torch.bfloat16
    jx = [jnp.asarray(img, np_dtype), jnp.asarray(img_ids),
          jnp.asarray(txt, np_dtype), jnp.asarray(txt_ids), jnp.asarray(t)]
    tx = [torch.as_tensor(img.astype(np.float32)).to(tdt),
          torch.as_tensor(img_ids),
          torch.as_tensor(txt.astype(np.float32)).to(tdt),
          torch.as_tensor(txt_ids), torch.from_numpy(t)]
    return jx, tx


def test_config_and_published_quantization(files):
    jp, model = _trees(files[Q.Q4_K])
    assert model.arch == "qwen_image" and not model.is_stacked
    assert dataclasses.asdict(model.config) == dataclasses.asdict(
        jqi.QwenImageConfig.from_state_dict(jp))
    assert model.config == DIMS.config()
    assert model.config.axes_dim == (16, 56, 56)
    p = model.params
    for k in ("transformer_blocks.1.attn.to_q.weight",
              "transformer_blocks.0.img_mod.1.weight",
              "transformer_blocks.0.txt_mlp.net.2.weight"):
        assert isinstance(p[k], PlanarQuant), k
    for k in ("img_in.weight", "txt_in.weight", "norm_out.linear.weight",
              "proj_out.weight", "txt_norm.weight"):
        assert isinstance(p[k], torch.Tensor), k


@pytest.mark.parametrize("mode", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("qtype", [Q.Q4_K, Q.Q8_0], ids=lambda q: q.name)
def test_forward_and_stacked_match_reference(files, qtype, mode):
    qcfg, jqcfg, np_dtype, tol = mode
    jp, model = _trees(files[qtype])
    jcfg = jqi.QwenImageConfig.from_state_dict(jp)
    jx, tx = _inputs(np_dtype)
    want = np.asarray(jqi.forward(jp, jcfg, *jx, qcfg=jqcfg), np.float32)
    got = qwen_image.forward(model.params, model.config, *tx, qcfg=qcfg)
    assert got.shape == (B, H_TOK * H_TOK, DIMS.in_ch)
    assert _rel(got.float(), want) < tol
    sp = qwen_image.stack_qwen_params(model.params, model.config)
    got_s = qwen_image.forward_stacked(sp, model.config, *tx, qcfg=qcfg)
    assert torch.equal(got_s, got)
    if mode is F32:
        jsp = jax.tree.map(np.asarray, jqi.stack_qwen_params(jp, jcfg))
        got_c = qwen_image.forward_stacked(params_from_numpy(jsp, "cpu"),
                                           model.config, *tx, qcfg=qcfg)
        assert _rel(got_c, want) < tol


def _w8a8_reference(files):
    from comfyui_gguf_tpu.quant.i8 import is_modulation_key as j_is_mod

    _, jqcfg, np_dtype, _ = F32
    jp, model = _trees(files[Q.Q4_K])
    jcfg = jqi.QwenImageConfig.from_state_dict(jp)
    jp = ji8.convert_tree_i8(jp, pred=lambda k, v: not j_is_mod(k))
    jx, tx = _inputs(np_dtype, seed=6)
    want = np.asarray(jqi.forward(jp, jcfg, *jx, qcfg=jqcfg), np.float32)
    return model, want, tx


def test_w8a8_forward_matches_reference(files):
    """requantize_i8 with img_mod / txt_mod kept planar (modulation keys),
    flat and stacked, against the reference's tree converted with the same
    predicate."""
    qcfg = F32[0]
    model, want, tx = _w8a8_reference(files)
    model.requantize_i8()
    assert is_modulation_key("transformer_blocks.0.img_mod.1.weight")
    assert isinstance(model.params["transformer_blocks.0.img_mod.1.weight"],
                      PlanarQuant)
    assert isinstance(model.params["transformer_blocks.0.attn.to_q.weight"],
                      I8Planar)
    got = qwen_image.forward(model.params, model.config, *tx, qcfg=qcfg)
    assert _rel(got, want) < W8A8_TOL
    stacked = model.stack()
    assert stacked.is_stacked
    out = qwen_image.forward_stacked(stacked.params, model.config, *tx,
                                     qcfg=qcfg)
    assert torch.equal(out, got)


@pytest.mark.parametrize("fault", ["unrounded_activations",
                                   "modulations_converted"])
def test_w8a8_limit_fails_faulted_conversions(files, fault, monkeypatch):
    """The control of ``W8A8_TOL``: a w8a8 forward whose activations are
    scaled but not rounded to int8 codes, or whose img_mod / txt_mod were
    converted against the reference's rule, reads above the limit."""
    from comfyui_gguf_tpu_torch.ops import i8mm

    model, want, tx = _w8a8_reference(files)
    if fault == "unrounded_activations":
        rows = i8mm.quantize_rows

        def unrounded(x2):
            _, xs = rows(x2)
            return x2.float() / xs, xs

        monkeypatch.setattr(i8mm, "quantize_rows", unrounded)
        model.requantize_i8()
    else:
        model.requantize_i8(mod_planar=False)
        assert isinstance(
            model.params["transformer_blocks.0.img_mod.1.weight"], I8Planar)
    got = qwen_image.forward(model.params, model.config, *tx, qcfg=F32[0])
    assert _rel(got, want) > W8A8_TOL


@pytest.fixture(scope="module")
def text_file(tmp_path_factory):
    """A 2-layer qwen2vl encoder GGUF of the context width (Q8_0, q/k/v
    biases, gpt2-BPE metadata) with a tiny mmproj sidecar beside it."""
    d = tmp_path_factory.mktemp("qwen_image_text")
    path = str(d / "qwen2.5-vl-tiny-Q8_0.gguf")
    dims = testing.LlamaDims(hidden=DIMS.context_dim, n_layers=2, n_heads=32,
                             n_kv_heads=8, head_dim=4, intermediate=256,
                             vocab=300, qkv_bias=True)
    testing.write_llama_gguf(testing.llama_state_dict(dims, seed=4), path,
                             qtype=Q.Q8_0, tokenizer=testing.bpe_spec(300),
                             arch="qwen2vl")
    testing.write_mmproj_gguf(
        testing.qwen_vl_vision_state_dict(testing.QwenVLVisionDims(
            dim=160, n_layers=2, out_dim=DIMS.context_dim, intermediate=320,
            patch=4), seed=5),
        str(d / "mmproj-qwen2.5-vl-tiny-F16.gguf"))
    return path


@pytest.fixture(scope="module")
def pipes(files, text_file):
    jp = jpipeline.QwenImagePipeline(
        jpipeline.load_diffusion_model(files[Q.Q4_K]),
        jpipeline.load_text_encoder(text_file))
    tp = tpipeline.QwenImagePipeline(
        tpipeline.load_diffusion_model(files[Q.Q4_K], device="cpu"),
        tpipeline.load_text_encoder(text_file, device="cpu"))
    return jp, tp


def _jax_noise(seed, L):
    return np.asarray(jax.random.normal(jax.random.key(seed),
                                        (1, L, DIMS.in_ch), jnp.bfloat16),
                      np.float32)


@pytest.mark.parametrize("cfg_scale", [4.0, 1.0])
def test_pipeline_matches_reference(pipes, cfg_scale):
    """generate with the reference's noise: the same latent tokens within
    the CFG-scaled limit; shift 2.2 and the reference's defaults."""
    jp, tp = pipes
    assert tp.shift == jp.shift == 2.2 and tp.text.kind == "llama"
    kw = dict(width=64, height=64, steps=3, cfg_scale=cfg_scale, seed=4,
              max_len=16)
    want = np.asarray(jp.generate("a photo of a cat on the moon", **kw),
                      np.float32)
    got = tp.generate("a photo of a cat on the moon",
                      noise=_jax_noise(4, 16), **kw)
    assert got.shape == want.shape == (16, DIMS.in_ch)
    assert np.isfinite(got).all()
    assert _rel(got, want) < _cfg_tol(cfg_scale)
    assert set(tp.last_timings) >= {"encode_s", "denoise_s", "total_s"}


def test_generate_edit_matches_reference(pipes):
    """Two reference latents (frames 1 and 2 of the RoPE ids; the second of
    another size) appended to the image stream, CFG 4."""
    jp, tp = pipes
    rng = np.random.default_rng(9)
    refs = [rng.standard_normal((8, 8, 16)).astype(np.float32),
            rng.standard_normal((4, 8, 16)).astype(np.float32)]
    kw = dict(width=64, height=64, steps=2, cfg_scale=4.0, seed=5,
              negative_prompt="blurry", max_len=16)
    want = np.asarray(jp.generate_edit("make it night", refs, **kw),
                      np.float32)
    got = tp.generate_edit("make it night", refs, noise=_jax_noise(5, 16),
                           **kw)
    assert got.shape == want.shape == (16, DIMS.in_ch)
    assert _rel(got, want) < _cfg_tol(4.0)
    plain = tp.generate("make it night", noise=_jax_noise(5, 16), **kw)
    assert _rel(got, plain) > 1e-2  # the references moved it


def test_generate_edit_with_image_conditioning(pipes):
    """Qwen-Image-Edit conditioned through the vision tower: each package's
    ``qwen_vl_encode_with_image`` states as ``txt_override``, the
    reference's as ``ntxt_override`` to both."""
    jp, tp = pipes
    img = np.random.default_rng(3).random((32, 32, 3)).astype(np.float32)
    ids = np.random.default_rng(4).integers(0, 290, (1, 24))
    ids[0, 4:20] = PAD_ID  # 8×8 patches → 16 merged tokens
    t_txt = tpipeline.qwen_vl_encode_with_image(
        tp.text, tp.text.params, ids, img, PAD_ID)["last_hidden"]
    j_txt = jpipeline.qwen_vl_encode_with_image(
        jp.text, jp.text.params, ids, img, PAD_ID)["last_hidden"]
    assert _rel(t_txt.float(), np.asarray(j_txt, np.float32)) < 2e-2
    # the reference builds its text ids from txt's length: ntxt of the same
    nids = np.random.default_rng(5).integers(0, 290, (1, 24))
    ntxt = np.asarray(jp.text.encode(jnp.asarray(nids))["last_hidden"],
                      np.float32)
    ref = np.random.default_rng(10).standard_normal((8, 8, 16)).astype(
        np.float32)
    kw = dict(width=64, height=64, steps=2, cfg_scale=4.0, seed=6)
    want = np.asarray(jp.generate_edit(
        "", [ref], txt_override=j_txt,
        ntxt_override=jnp.asarray(ntxt, jnp.bfloat16), **kw), np.float32)
    got = tp.generate_edit("", [ref], txt_override=t_txt,
                           ntxt_override=ntxt, noise=_jax_noise(6, 16), **kw)
    assert _rel(got, want) < _cfg_tol(4.0)


def _requests(seeds, steps, L):
    reqs = []
    for seed, n in zip(seeds, steps):
        r = np.random.default_rng(seed)
        reqs.append((r.standard_normal((L, DIMS.in_ch)).astype(np.float32),
                     {"txt": r.standard_normal(
                         (TXT_LEN, DIMS.context_dim)).astype(np.float32)},
                     linear_schedule(n)))
    return reqs


def _serve(eng, reqs):
    hs = [eng.submit(x.copy(), dict(c), s) for x, c, s in reqs]
    eng.run_until_drained()
    assert all(h.finished and h.error is None for h in hs)
    return [np.asarray(h.result, np.float32) for h in hs]


@pytest.mark.parametrize("stacked", [False, True], ids=["flat", "stacked"])
def test_engine_matches_reference_and_direct(files, stacked):
    """Two pooled requests of different lengths: the port's engine against
    the reference's, and each request against the port's direct Euler at
    batch 1."""
    jp, model = _trees(files[Q.Q8_0])
    jmodel = jpipeline.DiffusionModel(
        arch="qwen_image", params=jp,
        config=jqi.QwenImageConfig.from_state_dict(jp), qcfg=F32[1])
    model = dataclasses.replace(model, qcfg=F32[0])
    if stacked:
        jmodel, model = jmodel.stack(), model.stack()
        assert model.is_stacked
    L = H_TOK * H_TOK
    reqs = _requests((10, 11), (3, 4), L)
    got = _serve(tpipeline.qwen_image_engine(model, H_TOK, H_TOK, TXT_LEN,
                                             max_batch=2), reqs)
    want = _serve(jpipeline.qwen_image_engine(jmodel, H_TOK, H_TOK, TXT_LEN,
                                              max_batch=2), reqs)
    img_ids = torch.as_tensor(np.array(make_img_ids(H_TOK, H_TOK, 1)))
    txt_ids = torch.zeros((1, TXT_LEN, 3), dtype=torch.int32)
    for (x, c, sig), g, w in zip(reqs, got, want):
        assert g.shape == (L, DIMS.in_ch) and np.isfinite(g).all()
        assert _rel(g, w) < _cfg_tol(1.0)

        def vel(xc, s, c=c):
            return model.forward(xc, img_ids, torch.as_tensor(c["txt"])[
                None].to(torch.bfloat16), txt_ids,
                s.to(torch.float32).expand(1))

        with torch.no_grad():
            direct = sample_flow(vel, torch.as_tensor(x)[None].to(
                torch.bfloat16), sig)
        assert _rel(g, direct[0].float()) < 1e-2


@pytest.mark.parametrize("kw", [{"dp_mesh": object()}, {"mesh": object()}],
                         ids=["dp_mesh", "mesh"])
def test_engine_refuses_meshes(files, kw):
    _, model = _trees(files[Q.Q8_0])
    with pytest.raises(ValueError, match="axis"):
        tpipeline.qwen_image_engine(model, H_TOK, H_TOK, TXT_LEN, **kw)


def test_jax_img_ids_match():
    np.testing.assert_array_equal(np.array(make_img_ids(3, 5, 2)),
                                  np.asarray(jflux.make_img_ids(3, 5, 2)))


def test_seed_made_stacked_tree():
    """``qwen_image_random_stacked_params``: the blocks stacked and packed
    (at the reference helper's scale), the no-quant keys dense, the qk-norm
    gains near 1; a forward of it is finite."""
    p = testing.qwen_image_random_stacked_params(DIMS, seed=3, device="cpu")
    blocks = p["transformer_blocks"]
    assert isinstance(blocks["attn.to_q.weight"], PlanarQuant)
    assert blocks["attn.to_q.weight"].qs.shape[0] == DIMS.n_layers
    assert isinstance(blocks["img_mod.1.weight"], PlanarQuant)
    for k in ("img_in.weight", "txt_in.weight", "proj_out.weight"):
        assert isinstance(p[k], torch.Tensor), k
    assert abs(float(blocks["attn.norm_q.weight"].mean()) - 1) < 0.01
    model = tpipeline.DiffusionModel(arch="qwen_image", params=p,
                                     config=DIMS.config(), qcfg=BF16[0],
                                     device=torch.device("cpu"))
    assert model.is_stacked
    _, tx = _inputs("bfloat16")
    out = model.forward(*tx)
    assert out.shape == tx[0].shape and bool(torch.isfinite(out).all())
