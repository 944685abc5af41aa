"""The port's textual inversion (``comfyui_gguf_tpu_torch/textual_inversion.py``)
against the reference package, on the cases of
``tests/test_textual_inversion.py``: the token table grows by the vectors
and the prompt splices their ids; a bank of the wrong width is skipped; an
unknown name tokenizes literally; the pooled output reads the first EOS, not
the highest id; a safetensors file written by the port's own writer and a
legacy ``.pt`` load in both packages; truncation keeps the EOS. Token ids
must be equal; float outputs within 1e-5 relative L2 (f32 CLIP, only the
summation order differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_gguf_tpu import textual_inversion as jti
from comfyui_gguf_tpu.models import clip as jclip
from comfyui_gguf_tpu_torch import _safetensors
from comfyui_gguf_tpu_torch import textual_inversion as ti
from comfyui_gguf_tpu_torch.models import clip

torch.set_num_threads(2)


class StubTok:
    bos_id, eos_id, pad_id = 90, 91, 91  # CLIP pads with EOT

    def encode(self, text, add_special=True):
        ids = [ord(c) % 80 for c in text.replace(" ", "")]
        if add_special:
            ids = [self.bos_id] + ids + [self.eos_id]
        return ids


def _rel_l2(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _tiny_clip_np(rng, vocab=92, hidden=64, layers=2, inter=128):
    p = {"text_model.embeddings.token_embedding.weight":
         rng.standard_normal((vocab, hidden)),
         "text_model.embeddings.position_embedding.weight":
         rng.standard_normal((77, hidden)) * 0.01,
         "text_model.final_layer_norm.weight": np.ones((hidden,)),
         "text_model.final_layer_norm.bias": np.zeros((hidden,))}
    for i in range(layers):
        pre = f"text_model.encoder.layers.{i}"
        for nm, shape in (("self_attn.q_proj", (hidden, hidden)),
                          ("self_attn.k_proj", (hidden, hidden)),
                          ("self_attn.v_proj", (hidden, hidden)),
                          ("self_attn.out_proj", (hidden, hidden)),
                          ("mlp.fc1", (inter, hidden)),
                          ("mlp.fc2", (hidden, inter))):
            p[f"{pre}.{nm}.weight"] = rng.standard_normal(shape) * 0.02
            p[f"{pre}.{nm}.bias"] = np.zeros((shape[0],))
        for ln in ("layer_norm1", "layer_norm2"):
            p[f"{pre}.{ln}.weight"] = np.ones((hidden,))
            p[f"{pre}.{ln}.bias"] = np.zeros((hidden,))
    return {k: np.asarray(v, np.float32) for k, v in p.items()}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def test_extend_and_splice():
    rng = np.random.default_rng(0)
    jp, tp = _both(_tiny_clip_np(rng))
    vecs = rng.standard_normal((3, 64)).astype(np.float32)
    es, jes = ti.EmbeddingSet(tp, hidden=64), jti.EmbeddingSet(jp, hidden=64)
    ids = es.register("cat", vecs)
    assert ids == jes.register("cat", vecs) == [92, 93, 94]
    assert es.register("cat", vecs) == ids  # registered once
    table = es.params[ti.TOKEN_TABLE_KEY]
    assert table.shape == (95, 64) and table.dtype == torch.float32
    np.testing.assert_array_equal(table[92:].numpy(), vecs)
    np.testing.assert_array_equal(
        table.numpy(), np.asarray(jes.params[jti.TOKEN_TABLE_KEY]))
    assert tp[ti.TOKEN_TABLE_KEY].shape[0] == 92  # the input tree is kept
    tok = StubTok()
    for prompt in ("a embedding:cat b", "embedding:cat", "x embedding:cat"):
        out = es.encode(tok, prompt, max_length=16)
        np.testing.assert_array_equal(out, jes.encode(tok, prompt,
                                                      max_length=16))
    row = es.encode(tok, "a embedding:cat b", max_length=16)[0].tolist()
    assert row[0] == tok.bos_id
    i = row.index(92)
    assert row[i:i + 3] == [92, 93, 94] and tok.eos_id in row[i + 3:]


def test_wrong_width_bank_skipped():
    rng = np.random.default_rng(1)
    _, tp = _both(_tiny_clip_np(rng))
    es = ti.EmbeddingSet(tp, hidden=64, slot="clip_g")
    bank = {"clip_l": rng.standard_normal((2, 48)).astype(np.float32)}
    assert es.register("x", bank) is None
    assert es.params is tp and es.token_ids == {}
    assert ti.pick_slot(bank, 64) is None


def test_unknown_name_tokenizes_literally():
    tok = StubTok()
    out = ti.encode_prompt_ids(tok, "embedding:nope", {}, max_length=24)
    assert out.shape == (1, 24) and out.dtype == np.int32
    np.testing.assert_array_equal(
        out, jti.encode_prompt_ids(tok, "embedding:nope", {}, max_length=24))


def test_truncation_keeps_eos():
    tok = StubTok()
    reg = {"cat": [92, 93, 94]}
    prompt = "a very long prompt embedding:cat and more text after it"
    out = ti.encode_prompt_ids(tok, prompt, reg, max_length=8)
    assert out[0, -1] == tok.eos_id and out[0, 0] == tok.bos_id
    np.testing.assert_array_equal(
        out, jti.encode_prompt_ids(tok, prompt, reg, max_length=8))


def test_pooled_uses_first_eos_not_argmax():
    """With TI tokens appended (ids above EOS), pooling at the first EOS
    reads the true EOT; the port's CLIP equals the reference's on the
    extended table."""
    rng = np.random.default_rng(2)
    jp, tp = _both(_tiny_clip_np(rng))
    kw = dict(hidden=64, n_layers=2, n_heads=2, intermediate=128,
              vocab_size=92, eos_token_id=91)
    cfg, jcfg = clip.CLIPTextConfig(**kw), jclip.CLIPTextConfig(**kw)
    vecs = rng.standard_normal((2, 64)).astype(np.float32)
    es, jes = ti.EmbeddingSet(tp, hidden=64), jti.EmbeddingSet(jp, hidden=64)
    es.register("cat", vecs)
    jes.register("cat", vecs)
    tok = StubTok()
    ids = es.encode(tok, "hi embedding:cat", max_length=12)
    out = clip.encode(es.params, cfg, torch.from_numpy(ids))
    eos_pos = ids[0].tolist().index(91)
    assert ids[0].max() > 91
    np.testing.assert_allclose(out["pooled"][0].numpy(),
                               out["last_hidden"][0, eos_pos].numpy(),
                               rtol=1e-6)
    want = jclip.encode(jes.params, jcfg, jnp.asarray(ids))
    for k in ("pooled", "last_hidden"):
        assert _rel_l2(out[k].numpy(), np.asarray(want[k])) < 1e-5


def test_safetensors_roundtrip(tmp_path):
    """Files written by the port's own writer load in both packages."""
    rng = np.random.default_rng(3)
    v = rng.standard_normal((4, 64)).astype(np.float32)
    f = str(tmp_path / "emb.safetensors")
    _safetensors.save_file({"emb_params": v}, f)
    banks = ti.load_embedding_file(f)
    assert set(banks) == {"any"}
    np.testing.assert_array_equal(banks["any"], v)
    np.testing.assert_array_equal(jti.load_embedding_file(f)["any"], v)

    f2 = str(tmp_path / "dual.safetensors")
    g = rng.standard_normal((4, 96)).astype(np.float32)
    _safetensors.save_file({"clip_l": torch.from_numpy(v).bfloat16(),
                            "clip_g": g}, f2)
    banks, jbanks = ti.load_embedding_file(f2), jti.load_embedding_file(f2)
    assert set(banks) == set(jbanks) == {"clip_l", "clip_g"}
    assert banks["clip_l"].dtype == np.float32
    for k in banks:
        np.testing.assert_array_equal(banks[k], jbanks[k])
    assert ti.pick_slot(banks, 96, "clip_g").shape == (4, 96)
    assert ti.pick_slot(banks, 64, "clip_l").shape == (4, 64)
    assert ti.pick_slot(banks, 64, "clip_g") is None
    with pytest.raises(ValueError, match="unrecognized"):
        bad = str(tmp_path / "bad.safetensors")
        _safetensors.save_file({"other": v}, bad)
        ti.load_embedding_file(bad)


def test_torch_pt_legacy(tmp_path):
    v = torch.randn(2, 64)
    f = str(tmp_path / "old.pt")
    torch.save({"string_to_param": {"*": v}}, f)
    banks = ti.load_embedding_file(f)
    np.testing.assert_allclose(banks["any"], v.numpy(), rtol=1e-6)
    np.testing.assert_array_equal(banks["any"],
                                  jti.load_embedding_file(f)["any"])
    f2 = str(tmp_path / "emb.pt")
    torch.save({"emb_params": v[0]}, f2)
    assert ti.load_embedding_file(f2)["any"].shape == (1, 64)


def test_packed_table_is_refused():
    """A packed (quantized) table is not extended, as in the reference."""
    with pytest.raises(TypeError):
        ti.extend_token_table({ti.TOKEN_TABLE_KEY: object()},
                              np.zeros((1, 4), np.float32))
