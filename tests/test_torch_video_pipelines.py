"""The port's ``WanPipeline`` (UMT5, CFG, the Wan VAE), ``CosmosPipeline``,
``HyVidPipeline`` (a llama-family encoder, guidance-distilled, the
HunyuanVideo VAE), ``LTXVPipeline`` (T5, CFG, the LTX-Video VAE) and
``load_vae``'s family detection against the reference, on the CPU; mirrors
the wan, cosmos, hyvid and ltxv cases of ``tests/test_pipelines_video.py``
with real tiny encoders in place of its stubs.

Files: the tiny Wan, Cosmos, HunyuanVideo and LTX-Video DiTs of
``test_torch_wan.py``, ``test_torch_cosmos.py``, ``test_torch_hyvid.py``
and ``test_torch_ltxv.py`` (Q4_K), a 2-layer Q8_0 UMT5 (a relative-bias
table in each layer) and a 2-layer Q8_0 T5, each with a unigram tokenizer,
a 2-layer Q8_0 llama-graph encoder with gpt2-BPE metadata, and small Wan,
HunyuanVideo and LTX-Video VAEs (``models/testing.py``) as safetensors
files. Both packages load the same files; the reference's noise is handed
to the port. Checked: the VAE family detection (wan, hyvid, ltxv, image,
and the diffusers-format image VAE refused); the Wan video (with
``latents_mean`` / ``latents_std``) and latent, at CFG 5.0 and 1.0, the
padded positions of the conditioning zeroed; ``dispatch_window`` leaving
the result as it is, with every flow sampler; the Cosmos latent; the
HunyuanVideo video and latent at guidance 6.0; the LTX-Video video and
latent at CFG 3.0 and 1.0.

Tolerances (relative L2): 1.5e-2 · max(1, cfg) for CFG results against the
reference (bf16 latents between steps, the rounding difference scaled by
the CFG mix, as the SD and AuraFlow pipelines' limit; the VAE decode of
the Wan video adds its own bf16 roundings under the same limit).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_gguf_tpu import pipeline as jpipeline
from comfyui_gguf_tpu_torch import _safetensors
from comfyui_gguf_tpu_torch import pipeline as tpipeline
from comfyui_gguf_tpu_torch.gguf.constants import GGMLQuantizationType as Q
from comfyui_gguf_tpu_torch.models import testing
from comfyui_gguf_tpu_torch.sampling import flow_match

torch.set_num_threads(2)

WAN = testing.WanDims(dim=512, ffn_dim=1024, n_heads=4, n_layers=2,
                      in_ch=16, text_dim=512)
COSMOS = testing.CosmosDims(dim=512, n_heads=4, n_layers=2, in_ch=16,
                            text_dim=512)
VAE = testing.WanVAEDims(base=16, z=16, mult=(1, 2, 4), num_res=1,
                         temporal_down=(True, False))
HYVID = testing.HyVidDims(hidden=512, n_heads=4, depth_double=2,
                          depth_single=2, refiner_depth=2, in_ch=16,
                          text_dim=512)
LTXV = testing.LTXVDims(dim=512, n_layers=2, in_ch=128, caption_dim=512)
LTXV_VAE = testing.LTXVVAEDims(latent=128)
PROMPT, NEG = "a photo of a cat on the moon", "rain at night"


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _cfg_tol(cfg):
    return 1.5e-2 * max(1.0, cfg)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("video")
    out = {}
    for name, dims, spec in (("wan", WAN, testing.wan_shape_spec),
                             ("cosmos", COSMOS, testing.cosmos_shape_spec)):
        out[name] = str(d / f"{name}.gguf")
        testing.write_spec_gguf(
            testing.random_flat_sd_from_spec(*spec(dims), seed=0),
            out[name], name, Q.Q4_K)
    for name, per_layer in (("umt5", True), ("t5", False)):
        out[name] = str(d / f"{name}.gguf")
        testing.write_t5_gguf(
            testing.t5_state_dict(testing.T5Dims(
                d_model=512, d_kv=64, n_heads=8, d_ff=1024, n_layers=2,
                vocab=64, per_layer_bias=per_layer), seed=2),
            out[name], qtype=Q.Q8_0, tokenizer=testing.unigram_spec(64))
    out["vae"] = str(d / "wan_vae.safetensors")
    _safetensors.save_file(testing.wan_vae_state_dict(VAE, seed=3),
                           out["vae"])
    for name, dims, spec in (("hyvid", HYVID, testing.hyvid_shape_spec),
                             ("ltxv", LTXV, testing.ltxv_shape_spec)):
        out[name] = str(d / f"{name}.gguf")
        testing.write_spec_gguf(
            testing.random_flat_sd_from_spec(*spec(dims), seed=0),
            out[name], name, Q.Q4_K)
    out["llama"] = str(d / "llama.gguf")
    testing.write_llama_gguf(
        testing.llama_state_dict(testing.LlamaDims(
            hidden=512, n_layers=2, n_heads=32, n_kv_heads=8, head_dim=4,
            intermediate=256, vocab=300), seed=4),
        out["llama"], qtype=Q.Q8_0, tokenizer=testing.bpe_spec(300))
    out["hyvid_vae"] = str(d / "hyvid_vae.safetensors")
    _safetensors.save_file(testing.hyvid_vae_state_dict(
        testing.HyVidVAEDims(), seed=5), out["hyvid_vae"])
    out["ltxv_vae"] = str(d / "ltxv_vae.safetensors")
    _safetensors.save_file(testing.ltxv_vae_state_dict(LTXV_VAE, seed=6),
                           out["ltxv_vae"])
    return out


def test_load_vae_detects_families(files, tmp_path):
    """A Wan, an LTX-Video and a HunyuanVideo VAE file are the same kind in
    both packages, with the same config and tensors (a "vae." prefix
    stripped); a diffusers-format image VAE (``decoder.mid_block.*`` with
    4-D convs) raises ``ValueError`` in both."""
    def both(path):
        kind, params, cfg = tpipeline.load_vae(path, device="cpu")
        jkind, jparams, jcfg = jpipeline.load_vae(path)
        assert kind == jkind
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert set(params) == set(jparams)
        for k in params:
            np.testing.assert_array_equal(params[k].numpy(),
                                          np.asarray(jparams[k]))
        return kind, params, cfg

    kind, params, cfg = both(files["vae"])
    assert kind == "wan" and cfg.z_channels == 16
    kind, params, cfg = both(files["ltxv_vae"])
    assert kind == "ltxv" and cfg.latent_channels == 128
    kind, params, cfg = both(files["hyvid_vae"])
    assert kind == "hyvid" and cfg.z_channels == 16
    f = str(tmp_path / "bundled.safetensors")
    _safetensors.save_file({"vae.decoder.middle.0.residual.0.gamma":
                            np.zeros(4, np.float32),
                            "vae.decoder.conv1.weight":
                            np.zeros((8, 4, 3, 3, 3), np.float32)}, f)
    kind, params, cfg = both(f)
    assert kind == "wan" and cfg.z_channels == 4
    assert "decoder.conv1.weight" in params
    hy = str(tmp_path / "hy.safetensors")
    _safetensors.save_file({"vae.decoder.mid_block.resnets.0.norm1.weight":
                            np.zeros(4, np.float32),
                            "vae.decoder.conv_in.conv.weight":
                            np.zeros((8, 5, 3, 3, 3), np.float32)}, hy)
    kind, params, cfg = both(hy)
    assert kind == "hyvid" and cfg.z_channels == 5
    assert "decoder.conv_in.conv.weight" in params
    img = str(tmp_path / "img_diffusers.safetensors")
    _safetensors.save_file({"decoder.mid_block.resnets.0.norm1.weight":
                            np.zeros(4, np.float32),
                            "decoder.conv_in.weight":
                            np.zeros((8, 4, 3, 3), np.float32)}, img)
    for load in (lambda: tpipeline.load_vae(img, device="cpu"),
                 lambda: jpipeline.load_vae(img)):
        with pytest.raises(ValueError, match="diffusers-format"):
            load()


@pytest.fixture(scope="module")
def wan_pipes(files):
    """(reference, port) WanPipeline over the tiny Wan, the UMT5 and the
    VAE, with per-channel latent statistics."""
    rng = np.random.default_rng(8)
    mean = (rng.standard_normal(16) * 0.1).astype(np.float32)
    std = (1.0 + rng.random(16) * 0.5).astype(np.float32)
    _, jvae, _ = jpipeline.load_vae(files["vae"])
    _, tvae, _ = tpipeline.load_vae(files["vae"], device="cpu")
    jp = jpipeline.WanPipeline(
        jpipeline.load_diffusion_model(files["wan"]),
        jpipeline.load_text_encoder(files["umt5"]), vae_params=jvae,
        latents_mean=mean, latents_std=std)
    tp = tpipeline.WanPipeline(
        tpipeline.load_diffusion_model(files["wan"], device="cpu"),
        tpipeline.load_text_encoder(files["umt5"], device="cpu"),
        vae_params=tvae, latents_mean=mean, latents_std=std)
    return jp, tp


WAN_KW = dict(latent_frames=3, latent_height=4, latent_width=6, steps=3,
              seed=4, max_t5_len=16)


def _noise(seed, shape):
    return np.asarray(jax.random.normal(jax.random.key(seed), shape,
                                        jnp.bfloat16), np.float32)


@pytest.mark.parametrize("cfg_scale", [5.0, 1.0])
def test_wan_pipeline_matches_reference(wan_pipes, cfg_scale):
    """generate() with the reference's noise: the same video (T = 1 + 2(F
    − 1) frames through the one time doubling of the small VAE, 4×
    spatial) within the CFG-scaled limit; without a VAE, the same latent."""
    jp, tp = wan_pipes
    assert tp.shift == jp.shift == 5.0 and tp.zero_masked
    kw = dict(WAN_KW, cfg_scale=cfg_scale, dispatch_window=None)
    want = np.asarray(jp.generate(PROMPT, NEG, **kw), np.float32)
    noise = _noise(4, (1, 3, 4, 6, 16))
    got = tp.generate(PROMPT, NEG, noise=noise, **kw)
    assert got.shape == want.shape == (5, 16, 24, 3)
    assert np.isfinite(got).all() and 0 <= got.min() and got.max() <= 1
    assert _rel(got, want) < _cfg_tol(cfg_scale)
    assert set(tp.last_timings) >= {"encode_s", "denoise_s", "vae_s"}
    if cfg_scale != 1.0:
        return
    jv, tv = jp.vae_params, tp.vae_params
    jp.vae_params = tp.vae_params = None
    try:
        want = np.asarray(jp.generate(PROMPT, NEG, **kw), np.float32)
        got = tp.generate(PROMPT, NEG, noise=noise, **kw)
    finally:
        jp.vae_params, tp.vae_params = jv, tv
    assert got.shape == want.shape == (3, 4, 6, 16)
    assert _rel(got, want) < _cfg_tol(cfg_scale)


def test_wan_conditioning_zeroes_padded_positions(wan_pipes):
    _, tp = wan_pipes
    enc = tp.encoder
    ids, mask = enc.tokenizer.encode_batch([PROMPT], max_length=16)
    states = tpipeline._text_states(enc, PROMPT, 16, zero_masked=True)
    pad = torch.as_tensor(np.asarray(mask)) == 0
    assert pad.any() and not states[pad].any()
    assert states[~pad].abs().sum() > 0


@pytest.mark.parametrize("sampler", sorted(flow_match.FLOW_SAMPLERS))
def test_wan_dispatch_window_is_identical(wan_pipes, sampler, monkeypatch):
    """The dispatch window only adds host syncs: windows of 2 over 5 steps
    (2 + 2 + 1), 0 and None give the same bits, with every flow sampler
    (the reference's window carries only the latent between dispatches
    and refuses history-carrying samplers; the port's carries the
    sampler's state as it is: ROADMAP queue 3)."""
    _, tp = wan_pipes
    monkeypatch.setattr(flow_match, "DEFAULT_FLOW_SAMPLER", sampler)
    vae, tp.vae_params = tp.vae_params, None
    try:
        kw = dict(WAN_KW, steps=5, cfg_scale=3.0)
        full = tp.generate(PROMPT, NEG, dispatch_window=None, **kw)
        for w in (2, 0):
            assert np.array_equal(tp.generate(PROMPT, NEG,
                                              dispatch_window=w, **kw), full)
    finally:
        tp.vae_params = vae
    assert full.shape == (3, 4, 6, 16) and np.isfinite(full).all()


@pytest.mark.parametrize("cfg_scale", [4.0, 1.0])
def test_cosmos_pipeline_matches_reference(files, cfg_scale):
    """CosmosPipeline: T5 states, shift 1.0, the (F, H, W, C) latent out,
    against the reference with its noise."""
    jp = jpipeline.CosmosPipeline(
        jpipeline.load_diffusion_model(files["cosmos"]),
        jpipeline.load_text_encoder(files["t5"]))
    tp = tpipeline.CosmosPipeline(
        tpipeline.load_diffusion_model(files["cosmos"], device="cpu"),
        tpipeline.load_text_encoder(files["t5"], device="cpu"))
    assert tp.shift == jp.shift == 1.0 and not tp.zero_masked
    kw = dict(latent_frames=2, latent_height=8, latent_width=8, steps=3,
              cfg_scale=cfg_scale, seed=5, negative_prompt=NEG, max_len=16)
    want = np.asarray(jp.generate(PROMPT, **kw), np.float32)
    got = tp.generate(PROMPT, noise=_noise(5, (1, 2, 8, 8, 16)), **kw)
    assert got.shape == want.shape == (2, 8, 8, 16)
    assert np.isfinite(got).all()
    assert _rel(got, want) < _cfg_tol(cfg_scale)


@pytest.fixture(scope="module")
def hyvid_pipes(files):
    """(reference, port) HyVidPipeline over the tiny HunyuanVideo, the
    llama-graph encoder and the small HunyuanVideo VAE."""
    _, jvae, _ = jpipeline.load_vae(files["hyvid_vae"])
    _, tvae, _ = tpipeline.load_vae(files["hyvid_vae"], device="cpu")
    jp = jpipeline.HyVidPipeline(
        jpipeline.load_diffusion_model(files["hyvid"]),
        jpipeline.load_text_encoder(files["llama"]), vae_params=jvae)
    tp = tpipeline.HyVidPipeline(
        tpipeline.load_diffusion_model(files["hyvid"], device="cpu"),
        tpipeline.load_text_encoder(files["llama"], device="cpu"),
        vae_params=tvae)
    return jp, tp


def test_hyvid_pipeline_matches_reference(hyvid_pipes):
    """generate() at guidance 6.0 (one forward a step) with the reference's
    noise: the same video (1 + 4(F − 1) frames through the small VAE's two
    time doublings, 4× spatial) and, without a VAE, the same latent; a
    dispatch window of 2 leaves the result as it is."""
    jp, tp = hyvid_pipes
    assert tp.shift == jp.shift == 7.0 and tp.encoder.kind == "llama"
    kw = dict(latent_frames=2, latent_height=4, latent_width=6, steps=3,
              guidance=6.0, seed=7, max_len=16)
    want = np.asarray(jp.generate(PROMPT, **kw), np.float32)
    noise = _noise(7, (1, 2, 4, 6, 16))
    got = tp.generate(PROMPT, noise=noise, dispatch_window=None, **kw)
    assert got.shape == want.shape == (5, 16, 24, 3)
    assert np.isfinite(got).all() and 0 <= got.min() and got.max() <= 1
    assert _rel(got, want) < _cfg_tol(1.0)
    assert set(tp.last_timings) >= {"encode_s", "denoise_s", "vae_s"}
    jv, tv = jp.vae_params, tp.vae_params
    jp.vae_params = tp.vae_params = None
    try:
        want = np.asarray(jp.generate(PROMPT, **kw), np.float32)
        got = tp.generate(PROMPT, noise=noise, dispatch_window=None, **kw)
        windowed = tp.generate(PROMPT, noise=noise, dispatch_window=2, **kw)
    finally:
        jp.vae_params, tp.vae_params = jv, tv
    assert got.shape == want.shape == (2, 4, 6, 16)
    assert _rel(got, want) < _cfg_tol(1.0)
    assert np.array_equal(windowed, got)


@pytest.fixture(scope="module")
def ltxv_pipes(files):
    """(reference, port) LTXVPipeline over the tiny LTX-Video, the T5 and
    the small LTX-Video VAE (128 latent channels)."""
    _, jvae, _ = jpipeline.load_vae(files["ltxv_vae"])
    _, tvae, _ = tpipeline.load_vae(files["ltxv_vae"], device="cpu")
    jp = jpipeline.LTXVPipeline(
        jpipeline.load_diffusion_model(files["ltxv"]),
        jpipeline.load_text_encoder(files["t5"]), vae_params=jvae)
    tp = tpipeline.LTXVPipeline(
        tpipeline.load_diffusion_model(files["ltxv"], device="cpu"),
        tpipeline.load_text_encoder(files["t5"], device="cpu"),
        vae_params=tvae)
    return jp, tp


@pytest.mark.parametrize("cfg_scale", [3.0, 1.0])
def test_ltxv_pipeline_matches_reference(ltxv_pipes, cfg_scale):
    """generate() with the reference's (1, L, C) voxel noise: the same
    video (1 + 8(F − 1) frames, 32× spatial) through the VAE and, without
    one, the same (F, H, W, C) latent, within the CFG-scaled limit."""
    jp, tp = ltxv_pipes
    assert tp.shift == jp.shift == 3.0 and tp.encoder.kind == "t5"
    kw = dict(latent_frames=2, latent_height=2, latent_width=3, steps=3,
              cfg_scale=cfg_scale, seed=8, negative_prompt=NEG,
              max_t5_len=16)
    noise = _noise(8, (1, 12, 128))
    want = np.asarray(jp.generate(PROMPT, **kw), np.float32)
    got = tp.generate(PROMPT, noise=noise, **kw)
    assert got.shape == want.shape == (9, 64, 96, 3)
    assert np.isfinite(got).all() and 0 <= got.min() and got.max() <= 1
    assert _rel(got, want) < _cfg_tol(cfg_scale)
    # the config read from the VAE's keys once, and kept, in both
    assert dataclasses.asdict(tp.vae_config) == dataclasses.asdict(
        jp.vae_config)
    jv, tv = jp.vae_params, tp.vae_params
    jp.vae_params = tp.vae_params = None
    try:
        want = np.asarray(jp.generate(PROMPT, **kw), np.float32)
        got = tp.generate(PROMPT, noise=noise, **kw)
    finally:
        jp.vae_params, tp.vae_params = jv, tv
    assert got.shape == want.shape == (2, 2, 3, 128)
    assert _rel(got, want) < _cfg_tol(cfg_scale)
