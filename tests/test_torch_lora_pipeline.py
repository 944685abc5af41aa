"""LoRA and textual inversion through the port's ``FluxPipeline`` entry
points, against the reference's, on the CPU.

The pipeline pair of ``test_torch_pipeline.py`` (tiny flux in Q8_0 planar,
a 2-layer T5, a 2-layer CLIP, a 4-level VAE, the same arrays in both
packages) gets one LoRA file written by the port's own writer, with a
``lora_unet_`` slice over every flux block linear and ``lora_te1_`` (CLIP-L)
and ``lora_te3_`` (T5) slices over the encoders' linears; each package
attaches it through ``model.apply_lora``, ``clip_l.apply_lora`` and
``t5.apply_lora`` and generates the same request. A textual-inversion
embedding goes through an ``EmbeddingSet`` on each CLIP-L. Tolerance as in
``test_torch_pipeline.py``: 1e-2 relative L2 (bf16 latents between steps).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pipeline import TOL, _both, _build, _rel

from comfyui_gguf_tpu import textual_inversion as jti
from comfyui_gguf_tpu.models import clip as jclip
from comfyui_gguf_tpu_torch import _safetensors
from comfyui_gguf_tpu_torch import lora
from comfyui_gguf_tpu_torch import textual_inversion as ti
from comfyui_gguf_tpu_torch.models import clip as tclip
from comfyui_gguf_tpu_torch.models import testing

torch.set_num_threads(2)

CTX, VEC = 64, 32
DIMS = testing.TinyFluxDims(ctx=CTX, vec=VEC)


@pytest.fixture(scope="module")
def lora_path(tmp_path_factory):
    jp, tp = _build(DIMS, with_vae=False)
    sd = testing.kohya_lora_state_dict(testing.flux_lora_targets(DIMS),
                                       rank=4, alpha=4.0, seed=1, std=0.3)
    sd.update(testing.kohya_lora_state_dict(
        testing.encoder_lora_targets(tp.clip_l.params), rank=4, alpha=4.0,
        seed=2, std=0.1, prefix="lora_te1_"))
    sd.update(testing.kohya_lora_state_dict(
        testing.encoder_lora_targets(tp.t5.params), rank=8, alpha=4.0,
        seed=3, std=0.1, prefix="lora_te3_"))
    path = str(tmp_path_factory.mktemp("lora") / "style.safetensors")
    _safetensors.save_file(sd, path)
    return path


def test_pipeline_with_lora_matches_reference(lora_path):
    """apply_lora on the model and both encoders, then the same request in
    both packages; the LoRA moves the output, unapply_loras restores it."""
    pipes = _build(DIMS, with_vae=False)
    jp, tp = pipes
    base, base_t = _both(pipes, seed=0, no_vae=True)
    for p in (jp, tp):
        p.model.apply_lora(lora_path, strength=0.8)
        p.clip_l.apply_lora(lora_path, strength=0.8)
        p.t5.apply_lora(lora_path, strength=0.8)
    assert tp.model.base_params is not None
    n = {name: sum(isinstance(v, lora.PatchedWeight)
                   for v in enc.params.values())
         for name, enc in (("clip", tp.clip_l), ("t5", tp.t5),
                           ("flux", tp.model))}
    assert n == {"clip": 12, "t5": 14,
                 "flux": len(testing.flux_lora_targets(DIMS))}
    want, got = _both(pipes, seed=0, no_vae=True)
    assert np.isfinite(got).all()
    assert _rel(got, want) <= TOL
    assert _rel(got, base_t) > 3 * TOL  # the patches did work
    for enc in (tp.model, tp.clip_l, tp.t5):
        enc.unapply_loras()
    assert tp.model.base_params is None
    _, again = _both((jp, tp), seed=0, no_vae=True)
    np.testing.assert_array_equal(again, base_t)


def test_lora_after_stack_is_refused_and_patches_stack(lora_path):
    """apply_lora refuses a stacked tree (the kohya names are per block);
    attached before stack(), the patches stack with their blocks and the
    stacked model gives the flat model's output."""
    jp, tp = _build(DIMS, with_vae=False)
    with pytest.raises(ValueError, match="stack"):
        tp.model.stack().apply_lora(lora_path)
    tp.model.apply_lora(lora_path, strength=0.8)
    _, flat = _both((jp, tp), seed=4, no_vae=True)
    tp.model = tp.model.stack()
    assert tp.model.is_stacked
    leaf = tp.model.params["double_blocks"]["img_attn.qkv.weight"]
    assert isinstance(leaf, lora.PatchedWeight)
    _, stacked = _both((jp, tp), seed=4, no_vae=True)
    assert _rel(stacked, flat) <= 1e-5


def test_embedding_on_clip_matches_reference(tmp_path):
    """An ``embedding:name`` prompt through an EmbeddingSet on each
    package's CLIP-L: the same ids, the same pooled and hidden outputs."""
    jp, tp = _build(DIMS, with_vae=False)
    rng = np.random.default_rng(8)
    path = str(tmp_path / "cat.safetensors")
    vecs = rng.standard_normal((2, 64)).astype(np.float32)
    _safetensors.save_file({"clip_l": vecs}, path)
    es = ti.EmbeddingSet(tp.clip_l.params, hidden=64, slot="clip_l")
    jes = jti.EmbeddingSet(jp.clip_l.params, hidden=64, slot="clip_l")
    assert es.register("cat", path) == jes.register("cat", path) == [600, 601]
    prompt = "a photo of embedding:cat on the moon"
    ids = es.encode(tp.clip_l.tokenizer, prompt, 16)
    np.testing.assert_array_equal(ids, jes.encode(jp.clip_l.tokenizer,
                                                  prompt, 16))
    assert 600 in ids[0] and 601 in ids[0]
    # pool at the first EOS (a real CLIP-L vocabulary sets this itself):
    # the embedding's ids lie above the EOS id
    eos = tp.clip_l.tokenizer.eos_id
    cfg = dataclasses.replace(tp.clip_l.config, eos_token_id=eos)
    jcfg = dataclasses.replace(jp.clip_l.config, eos_token_id=eos)
    got = tclip.encode(es.params, cfg, torch.from_numpy(ids),
                       qcfg=tp.clip_l.qcfg)
    want = jclip.encode(jes.params, jcfg, jnp.asarray(ids),
                        qcfg=jp.clip_l.qcfg)
    for k in ("pooled", "last_hidden"):
        assert _rel(got[k].float().numpy(), np.asarray(want[k])) < 1e-5
    plain = tclip.encode(tp.clip_l.params, cfg, torch.from_numpy(
        tp.clip_l.tokenizer.encode_batch([prompt], max_length=16)[0]),
        qcfg=tp.clip_l.qcfg)
    assert _rel(got["pooled"].numpy(), plain["pooled"].numpy()) > 1e-3
