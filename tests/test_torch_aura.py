"""The port's AuraFlow DiT (``models/aura.py``), ``aura_engine`` and
``AuraPipeline`` against the reference, on the CPU.

A tiny AuraFlow (hidden 512: two heads of 256, the published head dim; 2
double + 2 single layers) is written as Q4_K and Q8_0 GGUFs by the port's
writer, quantized the way a published file is (the positional table,
register tokens, ``modF``, the embedders and the final linear stay float)
and loaded by both packages. Checked: config detection; ``forward`` planar
in float32 and bfloat16, ``forward_stacked`` (the port's stacking and the
reference's stacked tree carried across) equal to ``forward``; the w8a8
tree (``modC``/``modX``/``modCX`` converted to int8, as the reference's
``is_modulation_key`` leaves them: ROADMAP queue 3); the engine against
the reference's engine and against the direct sampler, Euler and
DPM-Solver++(2M), flat and stacked; the pipeline (a 2-layer Pile-T5-like
Q8_0 encoder with a unigram tokenizer) against the reference with the
reference's noise.

Tolerances (relative L2): 1e-4 with float32 compute; 2e-2 with bfloat16
compute (bf16 rounding points differ between the packages); 3e-4 for the
w8a8 tree in float32 (``W8A8_TOL``; queue 3: an activation code may land
on the other side of a rounding boundary where the two packages' f32 sums
differ in the last bits): measured 3.5e-6, while a conversion that skips
the activation rounding reads 5.9e-4 and one that keeps the modulations
planar 4.6e-4, which a control test holds above it; 1.5e-2 · max(1, cfg)
for CFG latents against the reference (bf16 latents between steps, the
rounding difference scaled by the CFG mix, as the SD pipelines' limit);
1e-2 for a served request against the direct sampler in the port.
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
from comfyui_gguf_tpu.models import aura as jaura
from comfyui_gguf_tpu.nn.layers import QuantConfig as JQuantConfig
from comfyui_gguf_tpu.quant import i8 as ji8
from comfyui_gguf_tpu_torch import pipeline as tpipeline
from comfyui_gguf_tpu_torch.gguf.constants import GGMLQuantizationType as Q
from comfyui_gguf_tpu_torch.interop import params_from_numpy
from comfyui_gguf_tpu_torch.models import aura, testing
from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
from comfyui_gguf_tpu_torch.quant.i8 import I8Planar
from comfyui_gguf_tpu_torch.quant.planar import PlanarQuant
from comfyui_gguf_tpu_torch.sampling import linear_schedule, sample_flow

torch.set_num_threads(2)

DIMS = testing.AuraDims(hidden=512, depth_double=2, depth_single=2,
                        mlp=1024, in_ch=4, cond_dim=64,
                        n_register_tokens=3, max_tokens=64)
B, H_LAT, CTX_LEN = 2, 8, 7
F32 = (QuantConfig(dequant_dtype=torch.float32, compute_dtype=torch.float32),
       JQuantConfig(dequant_dtype=jnp.float32, compute_dtype=jnp.float32,
                    prefer_pallas=False), np.float32, 1e-4)
BF16 = (QuantConfig(), JQuantConfig(prefer_pallas=False), "bfloat16", 2e-2)
CPU = torch.device("cpu")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _cfg_tol(cfg):
    return 1.5e-2 * max(1.0, cfg)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("aura")
    sd = testing.random_flat_sd_from_spec(*testing.aura_shape_spec(DIMS),
                                          seed=0)
    out = {}
    for qtype in (Q.Q4_K, Q.Q8_0):
        out[qtype] = str(d / f"aura_{qtype.name}.gguf")
        testing.write_spec_gguf(sd, out[qtype], "aura", qtype)
    return out


def _trees(path):
    """Both packages' trees of one file, each loaded with its default
    QuantConfig (``load_diffusion_model``'s), so that dense leaves take the
    same dtype on both sides."""
    jp = to_jax_params(j_sd_loader(path), JQuantConfig())
    model = tpipeline.load_diffusion_model(path, device="cpu")
    return jp, model


def _inputs(np_dtype, seed=5):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((B, H_LAT, H_LAT, DIMS.in_ch))
    cond = rng.standard_normal((B, CTX_LEN, DIMS.cond_dim))
    t = np.asarray([1.0, 0.4], np.float32)
    tdt = torch.float32 if np_dtype == np.float32 else torch.bfloat16
    jx = [jnp.asarray(a, np_dtype) for a in (lat, cond)] + [jnp.asarray(t)]
    tx = [torch.as_tensor(np.asarray(a, np.float32)).to(tdt)
          for a in (lat, cond)] + [torch.from_numpy(t)]
    return jx, tx


def test_config_and_published_quantization(files):
    jp, model = _trees(files[Q.Q4_K])
    assert model.arch == "aura" and not model.is_stacked
    assert dataclasses.asdict(model.config) == dataclasses.asdict(
        jaura.AuraConfig.from_state_dict(jp))
    assert model.config == DIMS.config()
    assert model.config.n_heads == 2  # heads of 256
    p = model.params
    assert isinstance(p["double_layers.0.modC.1.weight"], PlanarQuant)
    assert isinstance(p["single_layers.1.mlp.c_proj.weight"], PlanarQuant)
    for k in ("positional_encoding", "register_tokens", "modF.1.weight",
              "cond_seq_linear.weight", "init_x_linear.weight",
              "t_embedder.mlp.2.weight", "final_linear.weight"):
        assert isinstance(p[k], torch.Tensor), k


@pytest.mark.parametrize("mode", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("qtype", [Q.Q4_K, Q.Q8_0], ids=lambda q: q.name)
def test_forward_and_stacked_match_reference(files, qtype, mode):
    qcfg, jqcfg, np_dtype, tol = mode
    jp, model = _trees(files[qtype])
    jcfg = jaura.AuraConfig.from_state_dict(jp)
    jx, tx = _inputs(np_dtype)
    want = np.asarray(jaura.forward(jp, jcfg, *jx, qcfg=jqcfg), np.float32)
    got = aura.forward(model.params, model.config, *tx, qcfg=qcfg)
    assert got.shape == (B, H_LAT, H_LAT, DIMS.in_ch)
    assert _rel(got.float(), want) < tol
    sp = aura.stack_aura_params(model.params, model.config)
    got_s = aura.forward_stacked(sp, model.config, *tx, qcfg=qcfg)
    assert torch.equal(got_s, got)
    if mode is F32:
        jsp = jax.tree.map(np.asarray, jaura.stack_aura_params(jp, jcfg))
        got_c = aura.forward_stacked(params_from_numpy(jsp, "cpu"),
                                     model.config, *tx, qcfg=qcfg)
        assert _rel(got_c, want) < tol


W8A8_TOL = 3e-4


def _w8a8_reference(files):
    """(the port's model, the reference's w8a8 forward, the port's inputs):
    the reference's tree converted with ``convert_tree_i8`` and the
    reference's ``is_modulation_key`` predicate; the port's model still
    planar."""
    from comfyui_gguf_tpu.quant.i8 import is_modulation_key as j_is_mod

    _, jqcfg, np_dtype, _ = F32
    jp, model = _trees(files[Q.Q4_K])
    jcfg = jaura.AuraConfig.from_state_dict(jp)
    jp = ji8.convert_tree_i8(jp, pred=lambda k, v: not j_is_mod(k))
    jx, tx = _inputs(np_dtype, seed=6)
    want = np.asarray(jaura.forward(jp, jcfg, *jx, qcfg=jqcfg), np.float32)
    return model, want, tx


def test_w8a8_forward_matches_reference(files):
    """DiffusionModel.requantize_i8 on the port, convert_tree_i8 with the
    same predicate on the reference: modC/modX/modCX are no modulation keys
    by the reference's rule (a segment ending in "mod"), so they convert
    to int8 with the token linears; flat and stacked."""
    qcfg = F32[0]
    model, want, tx = _w8a8_reference(files)
    model.requantize_i8()
    for k in ("double_layers.0.modC.1.weight", "double_layers.1.modX.1.weight",
              "single_layers.0.modCX.1.weight",
              "double_layers.0.attn.w2q.weight"):
        assert isinstance(model.params[k], I8Planar), k
    got = aura.forward(model.params, model.config, *tx, qcfg=qcfg)
    assert _rel(got, want) < W8A8_TOL
    got_s = model.stack()
    assert got_s.is_stacked
    out = aura.forward_stacked(got_s.params, model.config, *tx, qcfg=qcfg)
    assert torch.equal(out, got)


@pytest.mark.parametrize("fault", ["unrounded_activations",
                                   "modulations_planar"])
def test_w8a8_limit_fails_faulted_conversions(files, fault, monkeypatch):
    """The control of ``W8A8_TOL``: a w8a8 forward that scales each
    activation row but skips its rounding to int8 codes, or one that keeps
    modC/modX/modCX planar against the reference's rule, reads above the
    limit against the reference."""
    from comfyui_gguf_tpu_torch.ops import i8mm
    from comfyui_gguf_tpu_torch.quant.i8 import convert_tree_i8

    model, want, tx = _w8a8_reference(files)
    if fault == "unrounded_activations":
        rows = i8mm.quantize_rows

        def unrounded(x2):
            _, xs = rows(x2)
            return x2.float() / xs, xs

        monkeypatch.setattr(i8mm, "quantize_rows", unrounded)
        model.requantize_i8()
    else:
        model.params = convert_tree_i8(model.params,
                                       pred=lambda k, v: ".mod" not in k)
        assert isinstance(model.params["double_layers.0.modC.1.weight"],
                          PlanarQuant)
    got = aura.forward(model.params, model.config, *tx, qcfg=F32[0])
    assert _rel(got, want) > W8A8_TOL


def _requests(seeds_scales, sig_steps=(3, 3)):
    reqs = []
    for (seed, scale), n in zip(seeds_scales, sig_steps):
        r = np.random.default_rng(seed)
        reqs.append((r.standard_normal((H_LAT, H_LAT, DIMS.in_ch)).astype(
                         np.float32),
                     {"ctx": r.standard_normal((CTX_LEN, DIMS.cond_dim))
                      .astype(np.float32),
                      "nctx": r.standard_normal((CTX_LEN, DIMS.cond_dim))
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
    """Two pooled requests at CFG 3.5 and 1.0 (different lengths): the
    port's engine against the reference's engine on the same tree, and
    each request against the port's direct sampler at batch 1."""
    jp, model = _trees(files[Q.Q8_0])
    jmodel = jpipeline.DiffusionModel(
        arch="aura", params=jp, config=jaura.AuraConfig.from_state_dict(jp),
        qcfg=F32[1])
    model = dataclasses.replace(model, qcfg=F32[0])
    if stacked:
        jmodel, model = jmodel.stack(), model.stack()
        assert model.is_stacked
    reqs = _requests([(10, 3.5), (11, 1.0)], (3, 4))
    got = _serve(tpipeline.aura_engine, model, reqs, sampler)
    want = _serve(jpipeline.aura_engine, jmodel, reqs, sampler)
    for (x, c, sig), g, w in zip(reqs, got, want):
        assert g.shape == (H_LAT, H_LAT, DIMS.in_ch) and np.isfinite(g).all()
        assert _rel(g, w) < _cfg_tol(float(c["cfg_scale"]))

        def vel(xc, s, c=c):
            t = s.to(torch.float32).expand(1)
            v_c = model.forward(xc, torch.as_tensor(c["ctx"])[None].to(
                torch.bfloat16), t)
            v_u = model.forward(xc, torch.as_tensor(c["nctx"])[None].to(
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
    with pytest.raises(NotImplementedError, match="parallel"):
        tpipeline.aura_engine(model, dp_mesh=object())


@pytest.fixture(scope="module")
def pipes(files, tmp_path_factory):
    """(reference AuraPipeline, port AuraPipeline) over the Q4_K file and a
    2-layer Q8_0 T5 of the model's cond width with a unigram tokenizer."""
    d = tmp_path_factory.mktemp("aura_t5")
    t5_path = str(d / "t5.gguf")
    testing.write_t5_gguf(
        testing.t5_state_dict(testing.T5Dims(
            d_model=DIMS.cond_dim, d_kv=16, n_heads=4, d_ff=128,
            n_layers=2, vocab=64), seed=2), t5_path, qtype=Q.Q8_0,
        tokenizer=testing.unigram_spec(64))
    jp = jpipeline.AuraPipeline(
        jpipeline.load_diffusion_model(files[Q.Q4_K]),
        jpipeline.load_text_encoder(t5_path))
    tp = tpipeline.AuraPipeline(
        tpipeline.load_diffusion_model(files[Q.Q4_K], device="cpu"),
        tpipeline.load_text_encoder(t5_path, device="cpu"))
    return jp, tp


@pytest.mark.parametrize("cfg_scale", [3.5, 1.0])
def test_pipeline_matches_reference(pipes, cfg_scale):
    """generate(prompt, negative_prompt) with the reference's noise handed
    to the port: the same latent within the CFG-scaled limit; shift 1.73
    and the (H/8, W/8, C) latent out."""
    jp, tp = pipes
    assert tp.shift == jp.shift == 1.73
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
    # the noise drawn from the seed gives another, finite latent
    drawn = tp.generate("a photo of a cat on the moon", **kw)
    assert np.isfinite(drawn).all() and _rel(drawn, got) > 1e-2


def test_seed_made_stacked_tree():
    """``aura_random_stacked_params``: the stacked layout forward_stacked
    reads, packed leaves where a published file quantizes (at
    ``random_planar``'s scale, the reference helper's), the no-quant keys
    dense; a forward of it is finite."""
    from comfyui_gguf_tpu_torch.quant.planar import dequantize

    dims = dataclasses.replace(DIMS, depth_double=1, depth_single=1)
    p = testing.aura_random_stacked_params(dims, seed=3, device="cpu")
    assert set(p["double_layers"]) == set(testing.aura_shape_spec(dims)[1][
        "double_layers"][1])
    w = p["double_layers"]["mlpX.c_proj.weight"]
    assert isinstance(w, PlanarQuant) and w.qs.shape[0] == 1  # depth 1
    std = float(dequantize(dataclasses.replace(
        w, qs=w.qs[0], scales=w.scales[0], offsets=w.offsets[0]),
        torch.float32).std())
    ref_std = float(dequantize(testing.random_planar(
        Q.Q4_K, (512, 1024), torch.Generator().manual_seed(0),
        device="cpu"), torch.float32).std())
    assert abs(std / ref_std - 1.0) < 0.1
    assert isinstance(p["single_layers"]["modCX.1.weight"], PlanarQuant)
    for k in ("positional_encoding", "register_tokens", "modF.1.weight",
              "cond_seq_linear.weight", "final_linear.weight"):
        assert isinstance(p[k], torch.Tensor), k
    assert testing.published_qtype("aura", "modF.1.weight", (1024, 512),
                                   Q.Q4_K) is None
    assert testing.published_qtype("aura", "double_layers.0.modC.1.weight",
                                   (3072, 512), Q.Q4_K) == Q.Q4_K
    model = tpipeline.DiffusionModel(arch="aura", params=p,
                                     config=dims.config(), qcfg=BF16[0],
                                     device=CPU)
    assert model.is_stacked and model.stack() is model
    lat, cond, t = testing.dit_example_inputs(
        (1, H_LAT, H_LAT, DIMS.in_ch), (1, CTX_LEN, DIMS.cond_dim),
        device="cpu")
    out = model.forward(lat, cond, t)
    assert out.shape == lat.shape and bool(torch.isfinite(out).all())
