"""The port's ``SD3Pipeline`` and ``sd3_engine`` against the reference's, on
the CPU.

One set of numpy trees — a tiny SD3.5-like MMDiT (Q8_0 planar block
linears), a 2-layer CLIP-L, a 2-layer CLIP-G-like tower (plain GELU), a
2-layer T5 and a 16-channel AutoencoderKL — and one pair of synthetic
vocabularies build an ``SD3Pipeline`` in both packages. The reference draws
its noise from ``jax.random.key(seed)``; the test draws the same arrays and
hands them to the port's ``generate`` (``noise=`` / ``step_noise=``), so
both run the same request: txt2img with a negative prompt (CFG, two
forwards a step) to a latent and through the VAE, img2img and inpainting,
and txt2img on the depth-stacked tree. ``_condition``'s concatenation and
zero-padding, the 16-channel VAE's scale factors (the reference's, kept as
the reference has them: ROADMAP queue 3), a kohya LoRA on the tiny MMDiT,
CLIP-G at its published width (1280, two layers) and the reference's three
``sd3_engine`` tests (without a mesh) run too, and the port's engine is
held against the reference's.

Tolerances (relative L2 of the whole output): 1e-2 for latents and images
(float32 compute, bfloat16 latents between steps in both packages, as in
``test_torch_pipeline.py``), 1e-4 for encoder states in float32, 1e-2 for
a served request against the same request integrated alone.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_gguf_tpu import pipeline as jpipeline
from comfyui_gguf_tpu.gguf.constants import GGMLQuantizationType as JQ
from comfyui_gguf_tpu.loader import TokenizerSpec as JTokenizerSpec
from comfyui_gguf_tpu.models import clip as jclip
from comfyui_gguf_tpu.models import sd3 as jsd3
from comfyui_gguf_tpu.models import t5 as jt5
from comfyui_gguf_tpu.models import testing as jtesting
from comfyui_gguf_tpu.models import vae as jvae
from comfyui_gguf_tpu.nn.layers import QuantConfig as JQuantConfig
from comfyui_gguf_tpu.sampling import flow_match as jfm
from comfyui_gguf_tpu.sampling import kdiffusion as jkd
from comfyui_gguf_tpu.tokenizer import UnigramTokenizer as JUnigram
from comfyui_gguf_tpu.tokenizer.clip_bpe import CLIPBPETokenizer as JCLIPBPE
from comfyui_gguf_tpu_torch import _safetensors
from comfyui_gguf_tpu_torch import lora
from comfyui_gguf_tpu_torch import pipeline as tpipeline
from comfyui_gguf_tpu_torch.interop import params_from_numpy
from comfyui_gguf_tpu_torch.models import clip as tclip
from comfyui_gguf_tpu_torch.models import sd3
from comfyui_gguf_tpu_torch.models import t5 as tt5
from comfyui_gguf_tpu_torch.models import testing
from comfyui_gguf_tpu_torch.models import vae as tvae
from comfyui_gguf_tpu_torch.nn.layers import QuantConfig as TQuantConfig
from comfyui_gguf_tpu_torch.sampling import (euler_sample, linear_schedule,
                                             sample_flow)
from comfyui_gguf_tpu_torch.tokenizer import UnigramTokenizer
from comfyui_gguf_tpu_torch.tokenizer.clip_bpe import CLIPBPETokenizer

torch.set_num_threads(2)

CTX, POOLED = 160, 32  # MMDiT context width (= T5 d_model); pooled_l ⊕ g
DIMS = testing.TinySD3Dims(hidden=256, heads=4, depth=2, ctx_dim=CTX,
                           pooled=POOLED, pos_max=8)
JF32 = JQuantConfig(dequant_dtype=jnp.float32, compute_dtype=jnp.float32,
                    prefer_pallas=False)
TF32 = TQuantConfig(dequant_dtype=torch.float32, compute_dtype=torch.float32)
CPU = torch.device("cpu")
PROMPT, NEG = "a photo of a cat on the moon", "rain at night"
TOL = 1e-2


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _sd3_trees(seed=1):
    jp = jtesting.quantize_flux_params(
        testing.sd3_flat_state_dict(DIMS, seed=seed), qtype=JQ.Q8_0)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _clip_pair(kind, seed, vocab, merges):
    sd = testing.clip_state_dict(
        testing.CLIPDims(hidden=64, n_layers=2, n_heads=1, intermediate=96,
                         vocab=600, max_positions=16, proj=POOLED // 2),
        seed=seed)
    act = "gelu" if kind == "clip_g" else "quick_gelu"
    jcfg = dataclasses.replace(jclip.CLIPTextConfig.from_state_dict(sd),
                               act=act)
    tcfg = dataclasses.replace(tclip.CLIPTextConfig.from_state_dict(sd),
                               act=act)
    return (jpipeline.TextEncoder(kind, {k: jnp.asarray(v)
                                         for k, v in sd.items()},
                                  jcfg, JCLIPBPE(vocab, merges), JF32),
            tpipeline.TextEncoder(kind, params_from_numpy(sd, "cpu"), tcfg,
                                  CLIPBPETokenizer(vocab, merges), TF32,
                                  CPU))


def _build(with_vae=True, stacked=False):
    """→ (reference SD3Pipeline, port SD3Pipeline) over the same arrays."""
    jp, tp = _sd3_trees()
    jmodel = jpipeline.DiffusionModel(arch="sd3", params=jp,
                                      config=jtesting.TinySD3Dims(
                                          **dataclasses.asdict(DIMS)).config(),
                                      qcfg=JF32)
    tmodel = tpipeline.DiffusionModel(arch="sd3", params=tp,
                                      config=DIMS.config(), qcfg=TF32,
                                      device=CPU)
    if stacked:
        jmodel, tmodel = jmodel.stack(), tmodel.stack()
    vocab, merges = testing.clip_vocab(600)
    jl, tl = _clip_pair("clip_l", 3, vocab, merges)
    jg, tg = _clip_pair("clip_g", 4, vocab, merges)
    spec = testing.unigram_spec(64)
    t5_sd = testing.t5_state_dict(
        testing.T5Dims(d_model=CTX, d_kv=16, n_heads=4, d_ff=128,
                       n_layers=2, vocab=64), seed=2)
    jt = jpipeline.TextEncoder(
        "t5", {k: jnp.asarray(v) for k, v in t5_sd.items()},
        jt5.T5Config.from_state_dict(t5_sd),
        JUnigram(JTokenizerSpec(**dataclasses.asdict(spec))), JF32)
    tt = tpipeline.TextEncoder(
        "t5", params_from_numpy(t5_sd, "cpu"),
        tt5.T5Config.from_state_dict(t5_sd), UnigramTokenizer(spec), TF32,
        CPU)
    jvp = jvc = tvp = tvc = None
    if with_vae:
        vae_sd = testing.vae_state_dict(
            testing.VAEDims(z_channels=16, base_ch=32), seed=5)
        jvp = {k: jnp.asarray(v) for k, v in vae_sd.items()}
        jvc = jvae.VAEConfig.from_state_dict(vae_sd)
        tvp = params_from_numpy(vae_sd, "cpu")
        tvc = tvae.VAEConfig.from_state_dict(vae_sd)
    return (jpipeline.SD3Pipeline(jmodel, jl, jg, jt, jvp, jvc),
            tpipeline.SD3Pipeline(tmodel, tl, tg, tt, tvp, tvc))


@pytest.fixture(scope="module")
def pipes():
    return _build()


def _noise(seed, shape):
    """The initial noise the reference's ``generate_from_ids`` draws, as
    float32 (the port rounds it back to the same bfloat16 values)."""
    return np.asarray(jax.random.normal(jax.random.key(seed), shape,
                                        jnp.bfloat16), np.float32)


def _step_noise(seed):
    """Inpainting step i's noise as the reference's sampler draws it."""
    key = jax.random.fold_in(jax.random.key(seed), 1)

    def fn(i, shape):
        return torch.from_numpy(np.array(jax.random.normal(
            jax.random.fold_in(key, i), shape)))
    return fn


def _both(pipes, seed=0, size=64, steps=2, no_vae=False, **kw):
    jp, tp = pipes
    if no_vae:
        jp = dataclasses.replace(jp, vae_params=None, vae_config=None)
        tp = dataclasses.replace(tp, vae_params=None, vae_config=None)
    kw = dict(width=size, height=size, steps=steps, max_t5_len=16,
              negative_prompt=NEG, **kw)
    want = jp.generate(PROMPT, seed=seed, **kw)
    got = tp.generate(PROMPT, noise=_noise(
        seed, (1, size // 8, size // 8, DIMS.in_ch)),
        step_noise=_step_noise(seed), **kw)
    return np.asarray(want, np.float32), got


@pytest.mark.parametrize("cfg_scale,forwards", [(4.5, 6), (1.0, 3)])
def test_txt2img_latent_matches(pipes, monkeypatch, cfg_scale, forwards):
    """With a negative prompt and cfg != 1, CFG runs two forwards a step
    (three steps: six forwards); at cfg 1, one."""
    calls = []
    model = pipes[1].model
    forward = model.forward
    monkeypatch.setattr(model, "forward",
                        lambda *a, **k: calls.append(1) or forward(*a, **k))
    want, got = _both(pipes, seed=0, no_vae=True, steps=3,
                      cfg_scale=cfg_scale)
    assert len(calls) == forwards
    assert got.shape == want.shape == (8, 8, DIMS.in_ch)
    assert np.isfinite(got).all()
    assert _rel(got, want) <= TOL


def test_txt2img_image_matches(pipes):
    want, got = _both(pipes, seed=1)
    assert got.shape == want.shape == (64, 64, 3)
    assert got.min() >= 0.0 and got.max() <= 1.0
    assert _rel(got, want) <= TOL
    assert set(pipes[1].last_timings) >= {"encode_s", "denoise_s", "vae_s",
                                          "total_s"}


def test_img2img_and_inpaint_match(pipes):
    rng = np.random.default_rng(5)
    init = rng.random((64, 64, 3)).astype(np.float32)
    want, got = _both(pipes, seed=2, steps=4, init_image=init, denoise=0.5)
    assert got.shape == want.shape == (64, 64, 3)
    assert _rel(got, want) <= TOL
    mask = np.zeros((64, 64), np.float32)
    mask[16:48, 8:40] = 1.0
    want, got = _both(pipes, seed=3, steps=3, init_image=init, denoise=1.0,
                      inpaint_mask=mask)
    assert _rel(got, want) <= TOL


def test_inpaint_keep_all_is_the_vae_round_trip(pipes):
    """The reference's check: an all-keep mask returns the VAE round trip
    of the source (the kept region is projected onto it every step; the
    last σ is 0)."""
    _, tp = pipes
    init = np.random.default_rng(0).uniform(0, 1, (64, 64, 3)).astype(
        np.float32)
    out = tp.generate_from_ids(
        np.ones((1, 4), np.int64), np.ones((1, 4), np.int64), width=64,
        height=64, steps=3, cfg_scale=1.0, init_image=init, denoise=1.0,
        inpaint_mask=np.zeros((8, 8), np.float32))
    img01 = torch.from_numpy(init)[None] * 2 - 1
    z0 = tvae.encode(tp.vae_params, tp.vae_config, img01)
    rt = tvae.decode(tp.vae_params, tp.vae_config, z0.to(torch.bfloat16))
    want = ((rt[0].clamp(-1, 1) + 1) / 2).numpy()
    np.testing.assert_allclose(out, want, atol=0.03)


def test_stacked_pipeline_matches_reference():
    """``DiffusionModel.stack()`` routes the pipeline to forward_stacked in
    both packages (the reference's stacked test, held across them)."""
    pipes = _build(with_vae=False, stacked=True)
    assert pipes[1].model.is_stacked
    want, got = _both(pipes, seed=6, steps=2, cfg_scale=3.0)
    assert _rel(got, want) <= TOL


def test_generate_draws_from_the_seed(pipes):
    _, tp = pipes
    tp = dataclasses.replace(tp, vae_params=None, vae_config=None)
    kw = dict(width=64, height=64, steps=1, max_t5_len=16)
    a, b, c = (tp.generate(PROMPT, seed=s, **kw) for s in (7, 7, 8))
    np.testing.assert_array_equal(a, b)
    assert not np.allclose(a, c)


def test_condition_concat_and_pad(pipes):
    """penultimate CLIP-L ⊕ CLIP-G zero-padded to the context width, then
    T5 appended; pooled_l ⊕ pooled_g — equal to the reference's."""
    jp, tp = pipes
    rng = np.random.default_rng(9)
    l_ids, g_ids = (rng.integers(0, 600, (1, 7)) for _ in range(2))
    t5_ids = rng.integers(0, 64, (1, 5))
    want_ctx, want_pooled = jp._condition(
        jnp.asarray(l_ids), jnp.asarray(g_ids), jnp.asarray(t5_ids))
    ctx, pooled = tp._condition(torch.from_numpy(l_ids),
                                torch.from_numpy(g_ids),
                                torch.from_numpy(t5_ids))
    assert ctx.shape == (1, 7 + 5, CTX) and pooled.shape == (1, POOLED)
    assert not ctx[0, :7, 128:].any()  # 64 + 64 CLIP channels, then zeros
    want_ctx = np.asarray(want_ctx)
    # the CLIP states in f32; the T5 states are bfloat16 in both packages
    assert _rel(ctx[:, :7].numpy(), want_ctx[:, :7]) <= 1e-4
    assert _rel(ctx[:, 7:].numpy(), want_ctx[:, 7:]) <= TOL
    assert _rel(pooled.numpy(), np.asarray(want_pooled)) <= 1e-4
    no_t5, _ = tp._condition(torch.from_numpy(l_ids),
                             torch.from_numpy(g_ids), None)
    assert no_t5.shape == (1, 7, CTX)
    bare = tpipeline.SD3Pipeline(model=None, clip_l=tp.clip_l,
                                 clip_g=tp.clip_g)
    assert bare._condition(torch.from_numpy(l_ids), torch.from_numpy(g_ids),
                           None)[0].shape == (1, 7, 4096)


def test_generate_requires_tokenizers_and_init_image(pipes):
    _, tp = pipes
    bare = dataclasses.replace(tp, clip_l=dataclasses.replace(
        tp.clip_l, tokenizer=None))
    with pytest.raises(ValueError, match="tokenizer"):
        bare.generate("a cat")
    ids = np.ones((1, 4), np.int64)
    with pytest.raises(ValueError, match="init_image"):
        tp.generate_from_ids(ids, ids, width=64, height=64, steps=2,
                             inpaint_mask=np.ones((8, 8), np.float32))
    with pytest.raises(ValueError, match="VAE"):
        dataclasses.replace(tp, vae_params=None).generate_from_ids(
            ids, ids, width=64, height=64, steps=2,
            init_image=np.zeros((64, 64, 3), np.float32), denoise=0.5)


def test_16_channel_vae_takes_flux_scale_factors(tmp_path):
    """A reference behaviour kept as it is (ROADMAP queue 3): the
    reference's ``VAEConfig.from_state_dict`` gives every 16-channel VAE
    flux's factors (0.3611 / 0.1159), so its SD3Pipeline decodes with them
    and not with SD3's published 1.5305 / 0.0609. The port matches: the
    config loaded through ``load_vae`` is the reference's, and the
    pipeline's image is the VAE decode with flux's factors."""
    vae_sd = testing.vae_state_dict(
        testing.VAEDims(z_channels=16, base_ch=32), seed=5)
    path = str(tmp_path / "vae.safetensors")
    _safetensors.save_file({k: torch.from_numpy(v)
                            for k, v in vae_sd.items()}, path)
    _, _, tvc = tpipeline.load_vae(path, device="cpu")
    jvc = jvae.VAEConfig.from_state_dict(vae_sd)
    assert dataclasses.asdict(tvc) == dataclasses.asdict(jvc)
    assert (tvc.scale_factor, tvc.shift_factor) == (0.3611, 0.1159)
    pipes = _build(with_vae=True)
    _, tp = pipes
    ids = np.ones((1, 4), np.int64)
    img = tp.generate_from_ids(ids, ids, width=64, height=64, steps=1,
                               cfg_scale=1.0)
    lat = tp.last_latent
    flux_img = tvae.decode_auto(tp.vae_params, tvc, lat)
    sd3_img = tvae.decode_auto(tp.vae_params, dataclasses.replace(
        tvc, scale_factor=1.5305, shift_factor=0.0609), lat)
    as01 = lambda x: ((x[0].clamp(-1, 1) + 1) / 2).numpy()  # noqa: E731
    np.testing.assert_array_equal(img, as01(flux_img))
    assert not np.allclose(img, as01(sd3_img))


def _targets():
    """(key, R, K) of every joint-block linear of the tiny MMDiT."""
    sd = testing.sd3_flat_state_dict(DIMS, seed=1)
    return [(k, *v.shape) for k, v in sd.items()
            if k.startswith("joint_blocks.") and v.ndim == 2]


def test_kohya_lora_on_tiny_sd3_matches_reference(tmp_path):
    """A kohya LoRA over every joint-block linear, attached through
    ``DiffusionModel.apply_lora`` in both packages: the same request, the
    patches moving it; then requantize_i8() + stack() on the port keeps the
    patches (the kernels' LoRA instances on the card)."""
    path = str(tmp_path / "sd3_lora.safetensors")
    _safetensors.save_file(testing.kohya_lora_state_dict(
        _targets(), rank=4, alpha=4.0, seed=1, std=0.3), path)
    pipes = _build(with_vae=False)
    jp, tp = pipes
    base_want, base = _both(pipes, seed=8, steps=2, cfg_scale=2.0)
    for p in (jp, tp):
        p.model.apply_lora(path, strength=0.8)
    assert sum(isinstance(v, lora.PatchedWeight)
               for v in tp.model.params.values()) == len(_targets())
    want, got = _both(pipes, seed=8, steps=2, cfg_scale=2.0)
    assert _rel(got, want) <= TOL
    assert _rel(got, base) > 3 * TOL
    tp.model = tp.model.requantize_i8().stack()
    leaf = tp.model.params["joint_blocks"]["x_block.attn.qkv.weight"]
    assert isinstance(leaf, lora.PatchedWeight)
    _, got_i8 = _both(pipes, seed=8, steps=2, cfg_scale=2.0)
    assert _rel(got_i8, want) <= 5e-2  # int8 activations on top


def test_clip_g_at_published_width_matches_reference(tmp_path):
    """CLIP-G's published width (1280, 20 heads of 64, plain GELU, text
    projection) at two layers, loaded from one safetensors file by both
    packages' ``load_text_encoder``: the same kind, config, penultimate,
    last and pooled states (f32)."""
    dims = dataclasses.replace(testing.CLIP_G_DIMS, n_layers=2, vocab=600)
    sd = testing.clip_state_dict(dims, seed=11)
    path = str(tmp_path / "clip_g.safetensors")
    _safetensors.save_file({k: torch.from_numpy(v) for k, v in sd.items()},
                           path)
    te = tpipeline.load_text_encoder(path, device="cpu")
    jte = jpipeline.load_text_encoder(path)
    te.qcfg, jte.qcfg = TF32, JF32
    assert te.kind == jte.kind == "clip_g"
    assert te.config.act == "gelu" and te.config.n_heads == 20
    assert dataclasses.asdict(te.config) == dataclasses.asdict(jte.config)
    ids = np.random.default_rng(2).integers(0, 600, (2, 9))
    got = te.encode(torch.from_numpy(ids))
    want = jte.encode(jnp.asarray(ids))
    for k in ("last_hidden", "penultimate", "pooled"):
        assert got[k].shape == tuple(want[k].shape)
        assert _rel(got[k].numpy(), np.asarray(want[k])) <= 1e-4, k


# -- sd3_engine (the reference's tests/test_sd3_engine.py, without a mesh) --

H_LAT = W_LAT = 8
CTX_LEN = 8
E_DIMS = testing.TinySD3Dims(depth=3)


@pytest.fixture(scope="module")
def engine_models():
    jp = jtesting.sd3_random_quant_params(
        jtesting.TinySD3Dims(**dataclasses.asdict(E_DIMS)), seed=9)
    cfg = E_DIMS.config()
    tmodel = tpipeline.DiffusionModel(
        arch="sd3", params=params_from_numpy(jax.tree.map(np.asarray, jp),
                                             "cpu"),
        config=cfg, qcfg=TF32, device=CPU)
    jmodel = jpipeline.DiffusionModel(
        arch="sd3", params=jp,
        config=jtesting.TinySD3Dims(**dataclasses.asdict(E_DIMS)).config(),
        qcfg=JF32)
    return tmodel, jmodel


def _cond(seed):
    rng = np.random.default_rng(seed)
    return {"ctx": rng.standard_normal((CTX_LEN, E_DIMS.ctx_dim)).astype(
                np.float32),
            "pooled": rng.standard_normal((E_DIMS.pooled,)).astype(
                np.float32)}


def _latent(seed):
    return np.random.default_rng(seed).standard_normal(
        (H_LAT, W_LAT, E_DIMS.in_ch)).astype(np.float32)


def _direct(mdl, x0, cond, sigmas, sampler="euler"):
    ctx = torch.from_numpy(cond["ctx"])[None].bfloat16()
    pooled = torch.from_numpy(cond["pooled"])[None].bfloat16()

    def velocity(x, s):
        return sd3.forward(mdl.params, mdl.config, x, ctx, pooled,
                           s.expand(1), qcfg=mdl.qcfg)
    x = torch.from_numpy(x0)[None].bfloat16()
    if sampler == "euler":
        return euler_sample(velocity, x, sigmas)[0].float().numpy()
    return sample_flow(velocity, x, sigmas, sampler)[0].float().numpy()


def test_sd3_engine_matches_direct_euler(engine_models):
    mdl, _ = engine_models
    eng = tpipeline.sd3_engine(mdl, max_batch=4)
    x0, cond, sigmas = _latent(1), _cond(2), linear_schedule(3)
    req = eng.submit(x0, cond, sigmas)
    req2 = eng.submit(_latent(3), _cond(3), linear_schedule(5))
    eng.run_until_drained()
    assert req.finished and req2.finished
    assert _rel(req.result, _direct(mdl, x0, cond, sigmas)) <= TOL
    assert eng.stats.completed == 2


def test_sd3_engine_stacked_serves_same(engine_models):
    mdl, _ = engine_models
    x0, cond, sigmas = _latent(4), _cond(5), linear_schedule(4)
    outs = []
    for m in (mdl, mdl.stack()):
        eng = tpipeline.sd3_engine(m, max_batch=2)
        req = eng.submit(x0.copy(), cond, sigmas)
        eng.run_until_drained()
        outs.append(req.result.astype(np.float32))
    assert _rel(outs[1], outs[0]) <= 1e-5


def test_sd3_engine_dpmpp_2m_matches_direct(engine_models):
    """sampler="dpmpp_2m": pooled requests match per-request
    DPM-Solver++(2M) through the flow x₀-adapter."""
    mdl, _ = engine_models
    eng = tpipeline.sd3_engine(mdl, max_batch=2, sampler="dpmpp_2m")
    reqs = [(_latent(50 + i), _cond(50 + i), linear_schedule(4 - i))
            for i in range(2)]
    rs = [eng.submit(x.copy(), c, s) for x, c, s in reqs]
    eng.run_until_drained()
    assert all(r.finished and r.error is None for r in rs)
    for (x, c, s), r in zip(reqs, rs):
        assert _rel(r.result, _direct(mdl, x, c, s, "dpmpp_2m")) <= TOL


@pytest.mark.parametrize("sampler", ["euler", "dpmpp_2m"])
@pytest.mark.parametrize("stacked", [False, True], ids=["flat", "stacked"])
def test_sd3_engine_matches_reference_engine(engine_models, sampler,
                                             stacked):
    """The port's engine and the reference's on the same tiny SD3 and the
    same three requests (mixed schedules: a mixed-progress, padded pool),
    on the flat and the depth-stacked tree."""
    tm, jm = engine_models
    if stacked:
        tm, jm = tm.stack(), jm.stack()
    reqs = [(_latent(60 + i), _cond(70 + i), linear_schedule(3 + i))
            for i in range(3)]
    out = []
    for mk, m in ((jpipeline.sd3_engine, jm), (tpipeline.sd3_engine, tm)):
        eng = mk(m, max_batch=2, sampler=sampler)
        rs = [eng.submit(x.copy(), c, s) for x, c, s in reqs]
        eng.run_until_drained()
        assert all(r.finished and r.error is None for r in rs)
        out.append([np.asarray(r.result, np.float32) for r in rs])
    for want, got in zip(*out):
        assert got.shape == want.shape == (H_LAT, W_LAT, E_DIMS.in_ch)
        assert _rel(got, want) <= TOL


def test_sd3_engine_dp_mesh_raises_until_ported(engine_models):
    mdl, _ = engine_models
    with pytest.raises(ValueError, match="axis"):
        tpipeline.sd3_engine(mdl, dp_mesh=object())


def test_direct_dpmpp_2m_matches_reference(engine_models):
    """The per-request DPM-Solver++(2M) the engine test holds against, in
    both packages (the reference's own direct path)."""
    tm, jm = engine_models
    x0, cond, sigmas = _latent(81), _cond(81), linear_schedule(4)
    ctx = jnp.asarray(cond["ctx"])[None].astype(jnp.bfloat16)
    pooled = jnp.asarray(cond["pooled"])[None].astype(jnp.bfloat16)

    def vel(xc, sigma):
        ts = jnp.full((1,), sigma, jnp.float32)
        return jsd3.forward(jm.params, jm.config, xc, ctx, pooled, ts,
                            qcfg=JF32)
    want = jkd.dpmpp_2m_sample_sigma(
        jfm.make_flow_denoiser(vel),
        jnp.asarray(x0)[None].astype(jnp.bfloat16), jnp.asarray(sigmas))
    got = _direct(tm, x0, cond, sigmas, "dpmpp_2m")
    assert _rel(got, np.asarray(want[0], np.float32)) <= TOL
