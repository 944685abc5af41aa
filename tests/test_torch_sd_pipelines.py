"""The port's ``SD1Pipeline`` and ``SDXLPipeline`` (and the SDXL refiner
pass) against the reference's, on the CPU.

One set of numpy trees — tiny sgm UNets written by the port's builder
(``testing.unet_state_dict``: an SD1-like one over CLIP-L's 64-wide states,
an SDXL-like one over CLIP-L ⊕ CLIP-G with the pooled-G + size vector, and
a refiner over CLIP-G alone with the aesthetic-score vector), two 2-layer
CLIP towers and a 4-channel AutoencoderKL — builds the pipelines in both
packages. The reference draws its noise from ``jax.random.key(seed)``; the
test draws the same arrays and hands them to the port (``noise=``,
``step_noise=``), so both run the same request: txt2img with CFG, img2img,
SDXL inpainting and the refiner, with the Euler and DPM-Solver++(2M)
samplers. The reference's menu tests (every sampler and every schedule
through ``SD1Pipeline``) and its error paths run on the port.

Tolerances (relative L2 of the whole output): both packages step in bf16
latents with f32 compute. Every block gives the same bits on the same bf16
input, but a float32 sum in another order (the convolutions) now and then
rounds an activation to the other bf16 neighbour, and CFG multiplies the
difference of the two forwards by its scale; so a request is held to
1.5e-2 · max(1, cfg), as the engine tests of ``test_torch_unet.py`` are.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_gguf_tpu import pipeline as jpipeline
from comfyui_gguf_tpu.models import clip as jclip
from comfyui_gguf_tpu.models import unet as junet
from comfyui_gguf_tpu.models import vae as jvae
from comfyui_gguf_tpu.nn.layers import QuantConfig as JQuantConfig
from comfyui_gguf_tpu_torch import pipeline as tpipeline
from comfyui_gguf_tpu_torch.interop import params_from_numpy
from comfyui_gguf_tpu_torch.models import clip as tclip
from comfyui_gguf_tpu_torch.models import testing
from comfyui_gguf_tpu_torch.models import unet as tunet
from comfyui_gguf_tpu_torch.models import vae as tvae
from comfyui_gguf_tpu_torch.nn.layers import QuantConfig as TQuantConfig
from comfyui_gguf_tpu_torch.sampling import kdiffusion as kd

torch.set_num_threads(2)

JF32 = JQuantConfig(dequant_dtype=jnp.float32, compute_dtype=jnp.float32,
                    prefer_pallas=False)
TF32 = TQuantConfig(dequant_dtype=torch.float32, compute_dtype=torch.float32)
CPU = torch.device("cpu")
HID, POOL_G = 64, 16  # both CLIP towers' widths; CLIP-G's projection
SD1 = testing.SDXLDims(model_channels=32, channel_mult=(1, 2),
                       num_res_blocks=1, depths=(1, 1), ctx=HID, adm=None)
SDXL = testing.SDXLDims(model_channels=32, channel_mult=(1, 2),
                        num_res_blocks=1, depths=(0, 1), ctx=2 * HID,
                        adm=POOL_G + 6 * 256)
REFINER = dataclasses.replace(SDXL, ctx=HID, adm=POOL_G + 5 * 256)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _tol(cfg_scale) -> float:
    return 1.5e-2 * max(1.0, float(cfg_scale))


def _models(dims, arch, seed):
    sd = testing.unet_state_dict(dims, seed=seed)
    jp = {k: jnp.asarray(v) for k, v in sd.items()}
    tp = params_from_numpy(sd, "cpu")
    return (jpipeline.DiffusionModel(
                arch=arch, params=jp,
                config=junet.UNetConfig.from_state_dict(jp), qcfg=JF32),
            tpipeline.DiffusionModel(
                arch=arch, params=tp,
                config=tunet.UNetConfig.from_state_dict(tp), qcfg=TF32,
                device=CPU))


def _clip_pair(kind, seed):
    sd = testing.clip_state_dict(
        testing.CLIPDims(hidden=HID, n_layers=2, n_heads=1, intermediate=96,
                         vocab=600, max_positions=16, proj=POOL_G),
        seed=seed)
    act = "gelu" if kind == "clip_g" else "quick_gelu"
    return (jpipeline.TextEncoder(
                kind, {k: jnp.asarray(v) for k, v in sd.items()},
                dataclasses.replace(jclip.CLIPTextConfig.from_state_dict(sd),
                                    act=act), None, JF32),
            tpipeline.TextEncoder(
                kind, params_from_numpy(sd, "cpu"),
                dataclasses.replace(tclip.CLIPTextConfig.from_state_dict(sd),
                                    act=act), None, TF32, CPU))


@pytest.fixture(scope="module")
def parts():
    vae_sd = testing.vae_state_dict(testing.VAEDims(z_channels=4,
                                                    base_ch=32), seed=8)
    jvc = jvae.VAEConfig.from_state_dict(vae_sd)
    tvc = tvae.VAEConfig.from_state_dict(vae_sd)
    assert dataclasses.asdict(jvc) == dataclasses.asdict(tvc)
    return dict(
        sd1=_models(SD1, "sd1", 1), sdxl=_models(SDXL, "sdxl", 2),
        refiner=_models(REFINER, "sdxl", 3), clip_l=_clip_pair("clip_l", 4),
        clip_g=_clip_pair("clip_g", 5),
        vae=(({k: jnp.asarray(v) for k, v in vae_sd.items()}, jvc),
             (params_from_numpy(vae_sd, "cpu"), tvc)))


def _pipes(parts, kind, vae=False):
    (jv, jvc), (tv, tvc) = parts["vae"] if vae else ((None, None),
                                                      (None, None))
    jm, tm = parts[kind if kind != "refiner" else "sdxl"]
    jl, tl = parts["clip_l"]
    if kind == "sd1":
        return (jpipeline.SD1Pipeline(jm, jl, jv, jvc),
                tpipeline.SD1Pipeline(tm, tl, tv, tvc))
    jg, tg = parts["clip_g"]
    return (jpipeline.SDXLPipeline(jm, jl, jg, jv, jvc),
            tpipeline.SDXLPipeline(tm, tl, tg, tv, tvc))


def _ids(seed, n=7):
    return np.random.default_rng(seed).integers(0, 600, (1, n))


def _noise(seed, shape, dtype):
    """The draw the reference's pipeline makes from ``key(seed)``, as
    float32."""
    return np.asarray(jax.random.normal(jax.random.key(seed), shape, dtype),
                      np.float32)


def _step_noise(seed):
    key = jax.random.fold_in(jax.random.key(seed), 1)

    def fn(i, shape):
        return torch.from_numpy(np.array(jax.random.normal(
            jax.random.fold_in(key, i), shape)))
    return fn


@pytest.mark.parametrize("sampler", ["euler", "dpmpp_2m"])
def test_sd1_txt2img_matches_reference(parts, sampler):
    jp, tp = _pipes(parts, "sd1")
    ids, neg = _ids(1), _ids(2)
    kw = dict(width=64, height=64, steps=3, cfg_scale=5.0, seed=4,
              sampler=sampler)
    want = np.asarray(jp.generate_from_ids(jnp.asarray(ids),
                                           neg_clip_l_ids=jnp.asarray(neg),
                                           **kw), np.float32)
    got = tp.generate_from_ids(ids, neg_clip_l_ids=neg,
                               noise=_noise(4, (1, 8, 8, 4), jnp.bfloat16),
                               **kw)
    assert got.shape == want.shape == (8, 8, 4)
    assert np.isfinite(got).all()
    assert _rel(got, want) <= _tol(5.0)


def test_sd1_img2img_matches_reference(parts):
    jp, tp = _pipes(parts, "sd1", vae=True)
    init = np.random.default_rng(1).uniform(0, 1, (64, 64, 3)).astype(
        np.float32)
    kw = dict(width=64, height=64, steps=4, cfg_scale=1.0, seed=2,
              init_image=init, denoise=0.5)
    want = np.asarray(jp.generate_from_ids(jnp.asarray(_ids(3)), **kw))
    got = tp.generate_from_ids(_ids(3), noise=_noise(2, (1, 8, 8, 4),
                                                     jnp.float32), **kw)
    assert got.shape == want.shape == (64, 64, 3)
    assert _rel(got, want) <= _tol(1.0)


@pytest.mark.parametrize("sampler", ["euler", "dpmpp_2m"])
def test_sdxl_txt2img_matches_reference(parts, sampler):
    jp, tp = _pipes(parts, "sdxl")
    kw = dict(width=64, height=64, steps=3, cfg_scale=3.0, seed=5,
              sampler=sampler)
    args = (_ids(1), _ids(2))
    neg = dict(neg_clip_l_ids=_ids(3), neg_clip_g_ids=_ids(4))
    want = np.asarray(jp.generate_from_ids(
        *map(jnp.asarray, args),
        **{k: jnp.asarray(v) for k, v in neg.items()}, **kw), np.float32)
    got = tp.generate_from_ids(*args, **neg, noise=_noise(
        5, (1, 8, 8, 4), jnp.bfloat16), **kw)
    assert got.shape == want.shape == (8, 8, 4)
    assert _rel(got, want) <= _tol(3.0)


def test_sdxl_img2img_and_inpaint_match_reference(parts):
    jp, tp = _pipes(parts, "sdxl", vae=True)
    rng = np.random.default_rng(7)
    init = rng.random((64, 64, 3)).astype(np.float32)
    mask = np.zeros((64, 64), np.float32)
    mask[16:48, 8:40] = 1.0
    args = (_ids(1), _ids(2))
    for extra in ({}, {"inpaint_mask": mask}):
        kw = dict(width=64, height=64, steps=4, cfg_scale=1.0, seed=6,
                  init_image=init, denoise=0.75, **extra)
        want = np.asarray(jp.generate_from_ids(*map(jnp.asarray, args),
                                               **kw))
        got = tp.generate_from_ids(
            *args, noise=_noise(6, (1, 8, 8, 4), jnp.float32),
            step_noise=_step_noise(6), **kw)
        assert got.shape == want.shape == (64, 64, 3)
        assert _rel(got, want) <= _tol(1.0), extra.keys()


def test_sdxl_inpaint_keep_all_is_the_vae_round_trip(parts):
    """The reference's check on the port: an all-keep mask lands on the
    source latent at the last (σ = 0) projection."""
    _, tp = _pipes(parts, "sdxl", vae=True)
    init = np.random.default_rng(8).random((64, 64, 3)).astype(np.float32)
    out = tp.generate_from_ids(_ids(1), _ids(2), width=64, height=64,
                               steps=3, cfg_scale=1.0, init_image=init,
                               inpaint_mask=np.zeros((8, 8), np.float32))
    img01 = torch.from_numpy(init)[None] * 2 - 1
    z0 = tvae.encode(tp.vae_params, tp.vae_config, img01)
    rt = tvae.decode(tp.vae_params, tp.vae_config, z0.to(torch.bfloat16))
    np.testing.assert_allclose(out, ((rt[0].clamp(-1, 1) + 1) / 2).numpy(),
                               atol=0.03)


def test_sdxl_refiner_matches_reference(parts):
    """refine_from_ids: CLIP-G-only context, the aesthetic-score vector
    (5 x 256), partial re-noise of a base latent, CFG."""
    jp, tp = _pipes(parts, "refiner")
    jref, tref = parts["refiner"]
    base = np.random.default_rng(9).standard_normal((8, 8, 4)).astype(
        np.float32)
    kw = dict(width=64, height=64, steps=4, cfg_scale=2.0, denoise=0.5,
              seed=3)
    want = np.asarray(jp.refine_from_ids(
        base, jnp.asarray(_ids(1)), neg_clip_g_ids=jnp.asarray(_ids(2)),
        refiner=jref, **kw), np.float32)
    got = tp.refine_from_ids(base, _ids(1), neg_clip_g_ids=_ids(2),
                             refiner=tref, noise=_noise(
                                 3, (1, 8, 8, 4), jnp.bfloat16), **kw)
    assert got.shape == want.shape == (8, 8, 4)
    assert np.isfinite(got).all()
    assert _rel(got, want) <= _tol(2.0)
    # the base model's target-size vector does not fit the refiner
    assert tref.config.adm_in_channels == POOL_G + 5 * 256


def test_sdxl_size_embedding_width():
    emb = tpipeline._size_embedding([1024, 1024, 0, 0, 1024, 1024],
                                    torch.zeros(1, dtype=torch.bfloat16))
    assert emb.shape == (1, 6 * 256) and emb.dtype == torch.bfloat16
    # SDXL's adm vector = pooled_g (1280) + 6 x 256 = 2816
    assert 1280 + emb.shape[1] == testing.SDXL_DIMS.adm


def _menu_pipe(parts):
    _, tp = _pipes(parts, "sd1")
    return tp, _ids(1)


def test_sd1_pipeline_sampler_menu(parts):
    """Every sampler (deterministic and stochastic) runs through
    SD1Pipeline; the stochastic ones are reproducible from the seed."""
    pipe, ids = _menu_pipe(parts)
    for name in sorted(kd.SAMPLERS) + sorted(kd.STOCHASTIC_SAMPLERS):
        out = pipe.generate_from_ids(ids, width=32, height=32, steps=2,
                                     cfg_scale=1.0, sampler=name, seed=3)
        assert out.shape == (4, 4, 4), name
        assert np.isfinite(out).all(), name
    a, b = (pipe.generate_from_ids(ids, width=32, height=32, steps=2,
                                   cfg_scale=1.0, sampler="dpmpp_2m_sde",
                                   seed=3) for _ in range(2))
    np.testing.assert_array_equal(a, b)


def test_sd1_pipeline_scheduler_menu(parts):
    pipe, ids = _menu_pipe(parts)
    for name in sorted(kd.SCHEDULES):
        out = pipe.generate_from_ids(ids, width=32, height=32, steps=3,
                                     cfg_scale=1.0, scheduler=name, seed=4)
        assert out.shape == (4, 4, 4), name
        assert np.isfinite(out).all(), name


def test_error_paths(parts):
    _, tp = _pipes(parts, "sdxl")
    with pytest.raises(ValueError, match="init_image"):
        tp.generate_from_ids(_ids(1), _ids(2), width=64, height=64,
                             steps=2, inpaint_mask=np.ones((8, 8)))
    with pytest.raises(ValueError, match="VAE"):
        tp.generate_from_ids(_ids(1), _ids(2), width=64, height=64,
                             steps=2, init_image=np.zeros((64, 64, 3)),
                             denoise=0.5)
    _, sd1 = _pipes(parts, "sd1")
    with pytest.raises(ValueError, match="unknown sampler"):
        sd1.generate_from_ids(_ids(1), width=32, height=32, steps=2,
                              sampler="bogus")
