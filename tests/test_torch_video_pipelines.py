"""The port's ``WanPipeline`` (UMT5, CFG, the Wan VAE), ``CosmosPipeline``
and ``load_vae``'s wan branch against the reference, on the CPU; mirrors
the wan and cosmos cases of ``tests/test_pipelines_video.py`` with real
tiny encoders in place of its stubs.

Files: the tiny Wan and Cosmos DiTs of ``test_torch_wan.py`` and
``test_torch_cosmos.py`` (Q4_K), a 2-layer Q8_0 UMT5 (a relative-bias
table in each layer) and a 2-layer Q8_0 T5, each with a unigram tokenizer,
and a small Wan VAE (``testing.WanVAEDims`` with 16 latent channels) as a
safetensors file. Both packages load the same files; the reference's
noise is handed to the port. Checked: the VAE family detection; the Wan
video (with ``latents_mean`` / ``latents_std``) and latent, at CFG 5.0 and
1.0, the padded positions of the conditioning zeroed; ``dispatch_window``
leaving the result as it is, with every flow sampler; the Cosmos latent.

Tolerances (relative L2): 1.5e-2 · max(1, cfg) for CFG results against the
reference (bf16 latents between steps, the rounding difference scaled by
the CFG mix, as the SD and AuraFlow pipelines' limit; the VAE decode of
the Wan video adds its own bf16 roundings under the same limit).
"""

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
    return out


def test_load_vae_detects_families(files, tmp_path):
    """A Wan VAE file is kind "wan" in both packages, with the same config
    and tensors (a "vae." prefix stripped); the families not ported yet
    still raise."""
    kind, params, cfg = tpipeline.load_vae(files["vae"], device="cpu")
    jkind, jparams, jcfg = jpipeline.load_vae(files["vae"])
    assert kind == jkind == "wan" and cfg.z_channels == jcfg.z_channels == 16
    assert set(params) == set(jparams)
    for k in ("decoder.middle.1.to_qkv.weight", "decoder.conv1.weight"):
        np.testing.assert_array_equal(params[k].numpy(),
                                      np.asarray(jparams[k]))
    f = str(tmp_path / "bundled.safetensors")
    _safetensors.save_file({"vae.decoder.middle.0.residual.0.gamma":
                            np.zeros(4, np.float32),
                            "vae.decoder.conv1.weight":
                            np.zeros((8, 4, 3, 3, 3), np.float32)}, f)
    kind, params, cfg = tpipeline.load_vae(f, device="cpu")
    assert kind == "wan" and cfg.z_channels == 4
    assert "decoder.conv1.weight" in params
    hy = str(tmp_path / "hy.safetensors")
    _safetensors.save_file({"decoder.mid_block.resnets.0.norm1.weight":
                            np.zeros(4, np.float32)}, hy)
    with pytest.raises(NotImplementedError, match="hyvid"):
        tpipeline.load_vae(hy, device="cpu")


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
