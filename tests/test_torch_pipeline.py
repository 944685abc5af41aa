"""The port's ``FluxPipeline`` as a whole against the reference's, on the CPU.

One set of numpy trees (tiny flux in Q8_0 planar, a 2-layer T5, a 2-layer
CLIP, a 4-level AutoencoderKL) and one pair of synthetic vocabularies build
a ``FluxPipeline`` in both packages. The reference draws its noise from
``jax.random.key(seed)``; the test draws the same arrays and hands them to
the port's ``generate_from_noise``, so both run the same request: txt2img
to a latent, txt2img through the VAE, img2img, inpainting, Kontext
``ref_latents``, and txt2img under ``attention_i8`` at a size inside the
int8 gate (the reference runs its kernel in interpret mode there, over one
key tile, which is the arithmetic of the port's plain version).

Tolerances (relative L2 of the whole output), float32 compute in both
packages with bfloat16 latents between the Euler steps:

* latents and images: 1e-2. Both packages round the latent to bfloat16
  after every step, so a different f32 summation order moves a value across
  a rounding boundary now and then (one bf16 step is 4e-3 of the value),
  and the VAE computes in bfloat16 in both (found: 1.3e-3 to 1.6e-3 for
  latents, 5e-3 to 7e-3 for images).
* under ``attention_i8``: 2e-2, since on top of that a probability can land
  on the other side of a 1/127 quantization step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_gguf_tpu import pipeline as jpipeline
from comfyui_gguf_tpu.gguf.constants import GGMLQuantizationType as Q
from comfyui_gguf_tpu.loader import TokenizerSpec as JTokenizerSpec
from comfyui_gguf_tpu.models import clip as jclip
from comfyui_gguf_tpu.models import t5 as jt5
from comfyui_gguf_tpu.models import testing as jtesting
from comfyui_gguf_tpu.models import vae as jvae
from comfyui_gguf_tpu.nn import attention as jattention
from comfyui_gguf_tpu.nn.layers import QuantConfig as JQuantConfig
from comfyui_gguf_tpu.tokenizer import UnigramTokenizer as JUnigram
from comfyui_gguf_tpu.tokenizer.clip_bpe import CLIPBPETokenizer as JCLIPBPE
from comfyui_gguf_tpu_torch import pipeline as tpipeline
from comfyui_gguf_tpu_torch.interop import params_from_numpy
from comfyui_gguf_tpu_torch.models import clip as tclip
from comfyui_gguf_tpu_torch.models import t5 as tt5
from comfyui_gguf_tpu_torch.models import testing
from comfyui_gguf_tpu_torch.models import vae as tvae
from comfyui_gguf_tpu_torch.nn.attention import attention_i8
from comfyui_gguf_tpu_torch.nn.layers import QuantConfig as TQuantConfig
from comfyui_gguf_tpu_torch.tokenizer import UnigramTokenizer
from comfyui_gguf_tpu_torch.tokenizer.clip_bpe import CLIPBPETokenizer

torch.set_num_threads(2)

CTX, VEC = 64, 32  # flux context/vec widths; the T5's d_model == CTX
JF32 = JQuantConfig(dequant_dtype=jnp.float32, compute_dtype=jnp.float32,
                    prefer_pallas=False)
TF32 = TQuantConfig(dequant_dtype=torch.float32, compute_dtype=torch.float32)
CPU = torch.device("cpu")
PROMPT = "a photo of a cat on the moon"
TOL, TOL_I8 = 1e-2, 2e-2


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _build(flux_dims, with_vae):
    """→ (reference FluxPipeline, port FluxPipeline) over the same arrays."""
    jflux_params = jtesting.quantize_flux_params(
        testing.flux_state_dict(flux_dims, seed=1), qtype=Q.Q8_0)
    jcfg = jtesting.TinyFluxDims(**dataclasses.asdict(flux_dims)).config()
    jmodel = jpipeline.DiffusionModel(arch="flux", params=jflux_params,
                                      config=jcfg, qcfg=JF32)
    tmodel = tpipeline.DiffusionModel(
        arch="flux",
        params=params_from_numpy(jax.tree.map(np.asarray, jflux_params),
                                 device="cpu"),
        config=flux_dims.config(), qcfg=TF32, device=CPU)

    spec = testing.unigram_spec(64)
    t5_sd = testing.t5_state_dict(
        testing.T5Dims(d_model=CTX, d_kv=16, n_heads=4, d_ff=128, n_layers=2,
                       vocab=64), seed=2)
    jt5e = jpipeline.TextEncoder(
        "t5", {k: jnp.asarray(v) for k, v in t5_sd.items()},
        jt5.T5Config.from_state_dict(t5_sd),
        JUnigram(JTokenizerSpec(**dataclasses.asdict(spec))), JF32)
    tt5e = tpipeline.TextEncoder(
        "t5", params_from_numpy(t5_sd, device="cpu"),
        tt5.T5Config.from_state_dict(t5_sd), UnigramTokenizer(spec), TF32,
        CPU)

    vocab, merges = testing.clip_vocab(600)
    clip_sd = testing.clip_state_dict(
        testing.CLIPDims(hidden=64, n_layers=2, n_heads=1, intermediate=96,
                         vocab=600, max_positions=16, proj=VEC), seed=3)
    jcle = jpipeline.TextEncoder(
        "clip_l", {k: jnp.asarray(v) for k, v in clip_sd.items()},
        jclip.CLIPTextConfig.from_state_dict(clip_sd),
        JCLIPBPE(vocab, merges), JF32)
    tcle = tpipeline.TextEncoder(
        "clip_l", params_from_numpy(clip_sd, device="cpu"),
        tclip.CLIPTextConfig.from_state_dict(clip_sd),
        CLIPBPETokenizer(vocab, merges), TF32, CPU)

    jvp = jvc = tvp = tvc = None
    if with_vae:
        vae_sd = testing.vae_state_dict(
            testing.VAEDims(z_channels=flux_dims.in_ch // 4, base_ch=32),
            seed=4)
        jvp = {k: jnp.asarray(v) for k, v in vae_sd.items()}
        jvc = jvae.VAEConfig.from_state_dict(vae_sd)
        tvp = params_from_numpy(vae_sd, device="cpu")
        tvc = tvae.VAEConfig.from_state_dict(vae_sd)
        assert dataclasses.asdict(jvc) == dataclasses.asdict(tvc)
    return (jpipeline.FluxPipeline(jmodel, jt5e, jcle, jvp, jvc),
            tpipeline.FluxPipeline(tmodel, tt5e, tcle, tvp, tvc))


@pytest.fixture(scope="module")
def pipes():
    return _build(testing.TinyFluxDims(ctx=CTX, vec=VEC), with_vae=True)


def _noise(seed, h_lat, w_lat, c):
    """The initial noise ``generate`` of the reference draws, as float32
    (the port rounds it back to the same bfloat16 values)."""
    return np.asarray(jax.random.normal(jax.random.key(seed),
                                        (1, h_lat, w_lat, c), jnp.bfloat16),
                      np.float32)


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
    kw = dict(width=size, height=size, steps=steps, max_t5_len=16, **kw)
    want = jp.generate(PROMPT, seed=seed, **kw)
    lat_c = tp.model.config.in_channels // 4
    got = tp.generate_from_noise(
        PROMPT, _noise(seed, size // 8, size // 8, lat_c),
        step_noise=_step_noise(seed), **kw)
    return np.asarray(want, np.float32), got


def test_txt2img_latent_matches(pipes):
    want, got = _both(pipes, seed=0, no_vae=True)
    assert got.shape == want.shape == (8, 8, 4)
    assert np.isfinite(got).all()
    assert _rel(got, want) <= TOL


def test_txt2img_image_matches(pipes):
    want, got = _both(pipes, seed=1)
    assert got.shape == want.shape == (64, 64, 3)
    assert got.min() >= 0.0 and got.max() <= 1.0
    assert _rel(got, want) <= TOL


def test_img2img_matches(pipes):
    rng = np.random.default_rng(5)
    init = rng.random((64, 64, 3)).astype(np.float32)
    want, got = _both(pipes, seed=2, steps=4, init_image=init, denoise=0.5)
    assert got.shape == want.shape == (64, 64, 3)
    assert _rel(got, want) <= TOL
    # only the last two of the four steps ran: a different request from
    # the full denoise of the same seed
    full, _ = _both(pipes, seed=2, steps=4)
    assert _rel(full, want) > 10 * _rel(got, want)


def test_inpaint_matches(pipes):
    rng = np.random.default_rng(6)
    init = rng.random((64, 64, 3)).astype(np.float32)
    mask = np.zeros((64, 64), np.float32)
    mask[16:48, 8:40] = 1.0
    want, got = _both(pipes, seed=3, steps=3, init_image=init, denoise=1.0,
                      inpaint_mask=mask)
    assert got.shape == want.shape == (64, 64, 3)
    assert _rel(got, want) <= TOL


def test_kontext_ref_latents_match(pipes):
    rng = np.random.default_rng(7)
    ref = rng.standard_normal((8, 8, 4)).astype(np.float32)
    want, got = _both(pipes, seed=4, no_vae=True, ref_latents=ref)
    assert got.shape == want.shape == (8, 8, 4)
    assert _rel(got, want) <= TOL
    # the reference span conditions the output (the same request without
    # it gives another latent, in the port as in the reference)
    base, got_base = _both(pipes, seed=4, no_vae=True)
    assert not np.allclose(got, got_base) and not np.allclose(want, base)


def test_generate_draws_from_the_seed(pipes):
    _, tp = pipes
    tp = dataclasses.replace(tp, vae_params=None, vae_config=None)
    kw = dict(width=64, height=64, steps=1, max_t5_len=16)
    a = tp.generate(PROMPT, seed=7, **kw)
    b = tp.generate(PROMPT, seed=7, **kw)
    c = tp.generate(PROMPT, seed=8, **kw)
    np.testing.assert_array_equal(a, b)
    assert not np.allclose(a, c)
    assert set(tp.last_timings) >= {"tokenize_s", "t5_s", "clip_s",
                                    "denoise_s", "vae_s", "total_s"}


def test_requests_that_need_a_vae_or_a_ported_part_raise(pipes):
    _, tp = pipes
    bare = dataclasses.replace(tp, vae_params=None, vae_config=None)
    noise = _noise(0, 8, 8, 4)
    kw = dict(width=64, height=64, steps=1, max_t5_len=16)
    with pytest.raises(ValueError, match="VAE"):
        bare.generate_from_noise(PROMPT, noise, init_image=np.zeros(
            (64, 64, 3), np.float32), denoise=0.5, **kw)
    with pytest.raises(ValueError, match="VAE"):
        bare.generate_from_noise(PROMPT, noise, ref_images=[np.zeros(
            (64, 64, 3), np.float32)], **kw)
    with pytest.raises(NotImplementedError, match="euler"):
        bare.generate_from_noise(PROMPT, noise, sampler="uni_pc", **kw)
    # text-encoder LoRA is ported: what is missing now is the file
    with pytest.raises(FileNotFoundError):
        tp.t5.apply_lora("nope.safetensors")


# -- under attention_i8, at a size inside the int8 gate ----------------------

I8_DIMS = testing.TinyFluxDims(hidden=256, heads=2, ctx=CTX, vec=VEC,
                               depth_double=1, depth_single=1,
                               axes_dim=(16, 56, 56))


@pytest.fixture(scope="module")
def i8_pipes():
    return _build(I8_DIMS, with_vae=False)


@pytest.mark.parametrize("mode", ["pv", "qk"])
def test_txt2img_under_attention_i8_matches(i8_pipes, mode, monkeypatch):
    """256² image = 256 image tokens + 256 text tokens = 512 joint tokens of
    head dim 128: inside the gate in both packages."""
    jp, tp = i8_pipes
    kw = dict(width=256, height=256, steps=1, max_t5_len=256)
    noise = _noise(0, 32, 32, 4)
    plain = tp.generate_from_noise(PROMPT, noise, **kw)
    with attention_i8(mode):
        got = tp.generate_from_noise(PROMPT, noise, **kw)
    # the scope changed the route, and only slightly the result
    assert 1e-6 < _rel(got, plain) < 5e-2
    again = tp.generate_from_noise(PROMPT, noise, **kw)
    np.testing.assert_array_equal(again, plain)  # nothing cached the route

    monkeypatch.setenv("GGUF_TPU_PALLAS_INTERPRET", "1")
    with jattention.attention_i8(mode):
        want = np.asarray(jp.generate(PROMPT, seed=0, **kw), np.float32)
    monkeypatch.delenv("GGUF_TPU_PALLAS_INTERPRET")
    jplain = np.asarray(jp.generate(PROMPT, seed=0, **kw), np.float32)
    assert 1e-6 < _rel(want, jplain) < 5e-2  # the reference took its kernel
    assert _rel(got, want) <= TOL_I8
    assert _rel(plain, jplain) <= TOL
