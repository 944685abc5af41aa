"""The port's Lumina Image 2.0 NextDiT (``models/lumina2.py``),
``lumina2_engine`` and ``Lumina2Pipeline`` against the reference, on the
CPU.

A tiny Lumina 2 (dim 512, 4 heads, 2 layers, one noise and one context
refiner) is written as Q4_K and Q8_0 GGUFs by the port's writer, quantized
the way a published file is (the embedders, the final layer and both
refiners stay float) and loaded by both packages. Checked: config
detection (head dim and RoPE axes from the qk-norm width); ``forward``
planar in float32 and bfloat16; ``forward_stacked`` (the port's stacking,
refiners flat, and the reference's stacked tree carried across) equal to
``forward``; the scale-only final modulation; the w8a8 tree (the adaLN
projections kept planar); the engine against the reference's engine and
the direct sampler, Euler and DPM-Solver++(2M), flat and stacked; the
pipeline (a 2-layer llama-graph encoder from a llama GGUF with a gpt2-BPE
tokenizer) against the reference with the reference's noise.

Tolerances as in ``test_torch_aura.py``: 1e-4 (float32), 2e-2 (bfloat16),
1.5e-2 · max(1, cfg) for CFG latents against the reference, 1e-2 for a
served request against the direct sampler; and 5e-3 for the w8a8 tree in
float32 (``W8A8_TOL``): each linear quantizes its input rows to int8, and
where the two packages' f32 sums differ in the last bits a code lands one
step off now and then (ROADMAP queue 3). In a NextDiT block one such flip
in the attention output's input moves the FFN input, the SwiGLU product
multiplies it, and the second layer's w2 input carries tens of flipped
codes (each one step off): 2.7e-3 at the output of this model, where the
planar tree agrees within 1e-4. A conversion that skips the activation
rounding reads 8.3e-3 and one that converts the adaLN projections 8.5e-3;
a control test holds both above the limit.
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
from comfyui_gguf_tpu.models import lumina2 as jlumina2
from comfyui_gguf_tpu.nn.layers import QuantConfig as JQuantConfig
from comfyui_gguf_tpu.quant import i8 as ji8
from comfyui_gguf_tpu_torch import pipeline as tpipeline
from comfyui_gguf_tpu_torch.gguf.constants import GGMLQuantizationType as Q
from comfyui_gguf_tpu_torch.interop import params_from_numpy
from comfyui_gguf_tpu_torch.models import lumina2, testing
from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
from comfyui_gguf_tpu_torch.quant.i8 import I8Planar, is_modulation_key
from comfyui_gguf_tpu_torch.quant.planar import PlanarQuant
from comfyui_gguf_tpu_torch.sampling import linear_schedule, sample_flow

torch.set_num_threads(2)

DIMS = testing.Lumina2Dims(dim=512, n_heads=4, n_layers=2, n_refiner=1,
                           n_context_refiner=1, ffn=1024, in_ch=4,
                           cap_dim=128)
B, H_LAT, CAP_LEN = 2, 8, 7
F32 = (QuantConfig(dequant_dtype=torch.float32, compute_dtype=torch.float32),
       JQuantConfig(dequant_dtype=jnp.float32, compute_dtype=jnp.float32,
                    prefer_pallas=False), np.float32, 1e-4)
BF16 = (QuantConfig(), JQuantConfig(prefer_pallas=False), "bfloat16", 2e-2)
W8A8_TOL = 5e-3


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _cfg_tol(cfg):
    return 1.5e-2 * max(1.0, cfg)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("lumina2")
    sd = testing.random_flat_sd_from_spec(*testing.lumina2_shape_spec(DIMS),
                                          seed=0)
    out = {}
    for qtype in (Q.Q4_K, Q.Q8_0):
        out[qtype] = str(d / f"lumina2_{qtype.name}.gguf")
        testing.write_spec_gguf(sd, out[qtype], "lumina2", qtype)
    return out


def _trees(path):
    """Both packages' trees of one file, each loaded with its default
    QuantConfig (``load_diffusion_model``'s), so that dense leaves take the
    same dtype on both sides."""
    jp = to_jax_params(j_sd_loader(path), JQuantConfig())
    return jp, tpipeline.load_diffusion_model(path, device="cpu")


def _inputs(np_dtype, seed=5):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((B, H_LAT, H_LAT, DIMS.in_ch))
    cap = rng.standard_normal((B, CAP_LEN, DIMS.cap_dim))
    t = np.asarray([1.0, 0.5], np.float32)
    tdt = torch.float32 if np_dtype == np.float32 else torch.bfloat16
    jx = [jnp.asarray(a, np_dtype) for a in (lat, cap)] + [jnp.asarray(t)]
    tx = [torch.as_tensor(np.asarray(a, np.float32)).to(tdt)
          for a in (lat, cap)] + [torch.from_numpy(t)]
    return jx, tx


def test_config_and_published_quantization(files):
    jp, model = _trees(files[Q.Q4_K])
    assert model.arch == "lumina2" and not model.is_stacked
    assert dataclasses.asdict(model.config) == dataclasses.asdict(
        jlumina2.Lumina2Config.from_state_dict(jp))
    assert model.config == DIMS.config()
    assert model.config.head_dim == 128
    assert sum(model.config.axes_dim) == 128
    p = model.params
    assert isinstance(p["layers.1.attention.qkv.weight"], PlanarQuant)
    assert isinstance(p["layers.0.adaLN_modulation.1.weight"], PlanarQuant)
    for k in ("noise_refiner.0.attention.qkv.weight",
              "context_refiner.0.feed_forward.w2.weight",
              "x_embedder.weight", "cap_embedder.1.weight",
              "final_layer.adaLN_modulation.1.weight"):
        assert isinstance(p[k], torch.Tensor), k


@pytest.mark.parametrize("mode", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("qtype", [Q.Q4_K, Q.Q8_0], ids=lambda q: q.name)
def test_forward_and_stacked_match_reference(files, qtype, mode):
    qcfg, jqcfg, np_dtype, tol = mode
    jp, model = _trees(files[qtype])
    jcfg = jlumina2.Lumina2Config.from_state_dict(jp)
    jx, tx = _inputs(np_dtype)
    want = np.asarray(jlumina2.forward(jp, jcfg, *jx, qcfg=jqcfg),
                      np.float32)
    got = lumina2.forward(model.params, model.config, *tx, qcfg=qcfg)
    assert got.shape == (B, H_LAT, H_LAT, DIMS.in_ch)
    assert _rel(got.float(), want) < tol
    sp = lumina2.stack_lumina2_params(model.params, model.config)
    assert "noise_refiner.0.attention.qkv.weight" in sp  # refiners flat
    got_s = lumina2.forward_stacked(sp, model.config, *tx, qcfg=qcfg)
    assert torch.equal(got_s, got)
    if mode is F32:
        jsp = jax.tree.map(np.asarray,
                           jlumina2.stack_lumina2_params(jp, jcfg))
        got_c = lumina2.forward_stacked(params_from_numpy(jsp, "cpu"),
                                        model.config, *tx, qcfg=qcfg)
        assert _rel(got_c, want) < tol


def test_scale_only_final_modulation_matches_reference():
    """A final layer whose modulation has one chunk (scale only) instead of
    (shift, scale): dense float32 trees."""
    d = dataclasses.replace(DIMS, dim=128, n_heads=2, ffn=256)
    nonblock, groups = testing.lumina2_shape_spec(d)
    nonblock["final_layer.adaLN_modulation.1.weight"] = (d.dim, d.dim)
    nonblock["final_layer.adaLN_modulation.1.bias"] = (d.dim,)
    sd = testing.random_flat_sd_from_spec(nonblock, groups, seed=3)
    cfg = lumina2.Lumina2Config.from_state_dict(sd)
    jcfg = jlumina2.Lumina2Config.from_state_dict(sd)
    rng = np.random.default_rng(8)
    lat = rng.standard_normal((1, 8, 8, d.in_ch)).astype(np.float32)
    cap = rng.standard_normal((1, 5, d.cap_dim)).astype(np.float32)
    t = np.asarray([0.3], np.float32)
    want = jlumina2.forward({k: jnp.asarray(v) for k, v in sd.items()},
                            jcfg, jnp.asarray(lat), jnp.asarray(cap),
                            jnp.asarray(t), qcfg=F32[1])
    got = lumina2.forward(params_from_numpy(sd, "cpu"), cfg,
                          torch.as_tensor(lat), torch.as_tensor(cap),
                          torch.as_tensor(t), qcfg=F32[0])
    assert _rel(got, np.asarray(want)) < 1e-4


def _w8a8_reference(files):
    """(the port's model, the reference's w8a8 forward, the port's inputs):
    the reference's tree converted with ``convert_tree_i8`` and the
    reference's ``is_modulation_key`` predicate; the port's model still
    planar."""
    from comfyui_gguf_tpu.quant.i8 import is_modulation_key as j_is_mod

    _, jqcfg, np_dtype, _ = F32
    jp, model = _trees(files[Q.Q4_K])
    jcfg = jlumina2.Lumina2Config.from_state_dict(jp)
    jp = ji8.convert_tree_i8(jp, pred=lambda k, v: not j_is_mod(k))
    jx, tx = _inputs(np_dtype, seed=6)
    want = np.asarray(jlumina2.forward(jp, jcfg, *jx, qcfg=jqcfg),
                      np.float32)
    return model, want, tx


def test_w8a8_forward_matches_reference(files):
    """requantize_i8 with the adaLN projections kept planar (they are
    modulation keys), flat and stacked, against the reference's tree
    converted with the same predicate."""
    qcfg = F32[0]
    model, want, tx = _w8a8_reference(files)
    model.requantize_i8()
    assert is_modulation_key("layers.0.adaLN_modulation.1.weight")
    assert isinstance(model.params["layers.0.adaLN_modulation.1.weight"],
                      PlanarQuant)
    assert isinstance(model.params["layers.0.feed_forward.w2.weight"],
                      I8Planar)
    got = lumina2.forward(model.params, model.config, *tx, qcfg=qcfg)
    assert _rel(got, want) < W8A8_TOL
    stacked = model.stack()
    assert stacked.is_stacked
    out = lumina2.forward_stacked(stacked.params, model.config, *tx,
                                  qcfg=qcfg)
    assert torch.equal(out, got)


@pytest.mark.parametrize("fault", ["unrounded_activations",
                                   "adaln_converted"])
def test_w8a8_limit_fails_faulted_conversions(files, fault, monkeypatch):
    """The control of ``W8A8_TOL``: a w8a8 forward that scales each
    activation row but skips its rounding to int8 codes, or one that
    converts the adaLN projections to int8 against the reference's rule,
    reads above the limit against the reference."""
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
            model.params["layers.0.adaLN_modulation.1.weight"], I8Planar)
    got = lumina2.forward(model.params, model.config, *tx, qcfg=F32[0])
    assert _rel(got, want) > W8A8_TOL


def _requests(seeds_scales, steps):
    reqs = []
    for (seed, scale), n in zip(seeds_scales, steps):
        r = np.random.default_rng(seed)
        reqs.append((r.standard_normal((H_LAT, H_LAT, DIMS.in_ch)).astype(
                         np.float32),
                     {"cap": r.standard_normal((CAP_LEN, DIMS.cap_dim))
                      .astype(np.float32),
                      "ncap": r.standard_normal((CAP_LEN, DIMS.cap_dim))
                      .astype(np.float32),
                      "cfg_scale": np.float32(scale)},
                     linear_schedule(n)))
    return reqs


def _serve(mk, model, reqs, sampler):
    eng = mk(model, max_batch=2, sampler=sampler)
    hs = [eng.submit(x.copy(), dict(c), s) for x, c, s in reqs]
    eng.run_until_drained()
    assert all(h.finished and h.error is None for h in hs)
    return [np.asarray(h.result, np.float32) for h in hs]


@pytest.mark.parametrize("stacked", [False, True], ids=["flat", "stacked"])
@pytest.mark.parametrize("sampler", ["euler", "dpmpp_2m"])
def test_engine_matches_reference_and_direct(files, sampler, stacked):
    """Two pooled requests at CFG 4.0 and 1.0 (different lengths) on the
    cond keys cap/ncap: the port's engine against the reference's, and each
    request against the port's direct sampler at batch 1."""
    jp, model = _trees(files[Q.Q8_0])
    jmodel = jpipeline.DiffusionModel(
        arch="lumina2", params=jp,
        config=jlumina2.Lumina2Config.from_state_dict(jp), qcfg=F32[1])
    model = dataclasses.replace(model, qcfg=F32[0])
    if stacked:
        jmodel, model = jmodel.stack(), model.stack()
        assert model.is_stacked
    reqs = _requests([(10, 4.0), (11, 1.0)], (3, 4))
    got = _serve(tpipeline.lumina2_engine, model, reqs, sampler)
    want = _serve(jpipeline.lumina2_engine, jmodel, reqs, sampler)
    for (x, c, sig), g, w in zip(reqs, got, want):
        assert g.shape == (H_LAT, H_LAT, DIMS.in_ch) and np.isfinite(g).all()
        assert _rel(g, w) < _cfg_tol(float(c["cfg_scale"]))

        def vel(xc, s, c=c):
            t = s.to(torch.float32).expand(1)
            v_c = model.forward(xc, torch.as_tensor(c["cap"])[None].to(
                torch.bfloat16), t)
            v_u = model.forward(xc, torch.as_tensor(c["ncap"])[None].to(
                torch.bfloat16), t)
            # mixed in f32, as the engine's _cfg_mix_velocity does
            return v_u.float() + float(c["cfg_scale"]) * (v_c.float()
                                                          - v_u.float())

        x0 = torch.as_tensor(x)[None].to(torch.bfloat16)
        with torch.no_grad():
            direct = sample_flow(vel, x0, sig, sampler=sampler)
        assert _rel(g, direct[0].float()) < 1e-2


def test_engine_refuses_dp_mesh(files):
    _, model = _trees(files[Q.Q8_0])
    with pytest.raises(ValueError, match="axis"):
        tpipeline.lumina2_engine(model, dp_mesh=object())


@pytest.fixture(scope="module")
def pipes(files, tmp_path_factory):
    """(reference Lumina2Pipeline, port Lumina2Pipeline) over the Q4_K file
    and a 2-layer llama-graph encoder of the caption width (a Q8_0 llama
    GGUF with gpt2-BPE metadata)."""
    d = tmp_path_factory.mktemp("lumina2_llama")
    path = str(d / "llama.gguf")
    dims = testing.LlamaDims(hidden=DIMS.cap_dim, n_layers=2, n_heads=32,
                             n_kv_heads=8, head_dim=4, intermediate=256,
                             vocab=300)
    testing.write_llama_gguf(testing.llama_state_dict(dims, seed=4), path,
                             qtype=Q.Q8_0, tokenizer=testing.bpe_spec(300))
    jp = jpipeline.Lumina2Pipeline(
        jpipeline.load_diffusion_model(files[Q.Q4_K]),
        jpipeline.load_text_encoder(path))
    tp = tpipeline.Lumina2Pipeline(
        tpipeline.load_diffusion_model(files[Q.Q4_K], device="cpu"),
        tpipeline.load_text_encoder(path, device="cpu"))
    return jp, tp


@pytest.mark.parametrize("cfg_scale", [4.0, 1.0])
def test_pipeline_matches_reference(pipes, cfg_scale):
    """generate(prompt, negative_prompt) with the reference's noise handed
    to the port: the same latent within the CFG-scaled limit; shift 6.0
    and the (H/8, W/8, C) latent out."""
    jp, tp = pipes
    assert tp.encoder.kind == "llama" and tp.shift == jp.shift == 6.0
    kw = dict(width=64, height=64, steps=3, cfg_scale=cfg_scale, seed=4,
              negative_prompt="rain at night", max_len=16)
    want = np.asarray(jp.generate("a photo of a cat on the moon", **kw),
                      np.float32)
    noise = np.asarray(jax.random.normal(
        jax.random.key(4), (1, 8, 8, DIMS.in_ch), jnp.bfloat16), np.float32)
    got = tp.generate("a photo of a cat on the moon", noise=noise, **kw)
    assert got.shape == want.shape == (8, 8, DIMS.in_ch)
    assert np.isfinite(got).all()
    assert _rel(got, want) < _cfg_tol(cfg_scale)
    assert set(tp.last_timings) >= {"encode_s", "denoise_s", "total_s"}


def test_seed_made_stacked_tree():
    """``lumina2_random_stacked_params``: the main layers stacked and packed
    (at the reference helper's scale), the refiners, embedders and final
    layer dense (the arch's no-quant keys), norm gains near 1; a forward of
    it is finite."""
    d = dataclasses.replace(DIMS, n_layers=2)
    p = testing.lumina2_random_stacked_params(d, seed=3, device="cpu")
    assert isinstance(p["layers"]["attention.qkv.weight"], PlanarQuant)
    assert p["layers"]["attention.qkv.weight"].qs.shape[0] == 2
    for k in ("noise_refiner.0.attention.qkv.weight",
              "context_refiner.0.feed_forward.w1.weight",
              "cap_embedder.1.weight", "final_layer.linear.weight"):
        assert isinstance(p[k], torch.Tensor), k
    assert abs(float(p["layers"]["ffn_norm1.weight"].mean()) - 1) < 0.01
    model = tpipeline.DiffusionModel(arch="lumina2", params=p,
                                     config=d.config(), qcfg=BF16[0],
                                     device=torch.device("cpu"))
    assert model.is_stacked
    lat, cap, t = testing.dit_example_inputs(
        (1, H_LAT, H_LAT, d.in_ch), (1, CAP_LEN, d.cap_dim), device="cpu")
    out = model.forward(lat, cap, t)
    assert out.shape == lat.shape and bool(torch.isfinite(out).all())
