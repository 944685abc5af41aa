"""The port's copies of the native tokenizers against the reference's.

The same specification (a synthetic unigram ``TokenizerSpec``, a synthetic
CLIP vocabulary and merges, a byte-level BPE spec) builds a tokenizer in
each package; ids and masks must be EQUAL on every prompt, including
truncation and padding. The spec also round-trips through the port's GGUF
writer and reader (string, float and int arrays).
"""

import numpy as np
import pytest

from comfyui_gguf_tpu import loader as ref_loader
from comfyui_gguf_tpu import tokenizer as ref_tok
from comfyui_gguf_tpu.tokenizer.clip_bpe import \
    CLIPBPETokenizer as RefCLIPBPE
from comfyui_gguf_tpu_torch import loader as port_loader
from comfyui_gguf_tpu_torch import tokenizer as port_tok
from comfyui_gguf_tpu_torch.gguf.reader import GGUFReader
from comfyui_gguf_tpu_torch.models import testing

PROMPTS = [
    "a photo of a cat sitting on the moon",
    "an oil painting of a lighthouse in a storm at night",
    "  A   red_fox, in SNOW!  ",
    "zebra crossing 42 (city street)",
    "",
]


def _ref_spec(spec):
    return ref_loader.TokenizerSpec(**{
        f: getattr(spec, f) for f in spec.__dataclass_fields__})


@pytest.mark.parametrize("vocab", [64, 32128])
@pytest.mark.parametrize("max_length", [None, 8, 64])
def test_unigram_ids_and_masks_equal(vocab, max_length):
    spec = testing.unigram_spec(vocab)
    a = port_tok.build_tokenizer(spec)
    b = ref_tok.build_tokenizer(_ref_spec(spec))
    assert type(a).__name__ == type(b).__name__ == "UnigramTokenizer"
    ids_a, mask_a = a.encode_batch(PROMPTS, max_length=max_length)
    ids_b, mask_b = b.encode_batch(PROMPTS, max_length=max_length)
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_array_equal(mask_a, mask_b)
    assert ids_a.dtype == np.int32 and (ids_a < vocab).all()
    assert a.decode(a.encode(PROMPTS[0])) == b.decode(b.encode(PROMPTS[0]))


@pytest.mark.parametrize("vocab", [200, 49408])
@pytest.mark.parametrize("max_length", [None, 8, 77])
def test_clip_bpe_ids_and_masks_equal(vocab, max_length):
    v, merges = testing.clip_vocab(vocab)
    assert len(v) == vocab and v["<|endoftext|>"] == vocab - 1
    a = port_tok.CLIPBPETokenizer(v, merges)
    b = RefCLIPBPE(v, merges)
    ids_a, mask_a = a.encode_batch(PROMPTS, max_length=max_length)
    ids_b, mask_b = b.encode_batch(PROMPTS, max_length=max_length)
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_array_equal(mask_a, mask_b)
    assert ids_a[0, 0] == v["<|startoftext|>"]
    assert a.decode(ids_a[0]) == b.decode(ids_b[0])


def test_clip_vocab_files_round_trip(tmp_path):
    v, merges = testing.clip_vocab()
    testing.write_clip_vocab(str(tmp_path), v, merges)
    a = port_tok.CLIPBPETokenizer.from_files(str(tmp_path / "vocab.json"),
                                             str(tmp_path / "merges.txt"))
    b = RefCLIPBPE.from_files(str(tmp_path / "vocab.json"),
                              str(tmp_path / "merges.txt"))
    assert a.vocab == v and len(a.merge_ranks) == len(merges)
    for p in PROMPTS:
        assert a.encode(p) == b.encode(p)
    # merged words are single tokens: BOS, 5 words, EOS
    assert len(a.encode("a photo of the cat")) == 7


def test_byte_level_bpe_equal():
    from comfyui_gguf_tpu_torch.tokenizer.bpe import bytes_to_unicode

    syms = list(bytes_to_unicode().values())
    tokens = syms + ["ca", "cat", "Ġa", "Ġcat", "<|eos|>"]
    merges = ["c a", "ca t", "Ġ a", "Ġ cat"]
    kw = dict(model="gpt2", tokens=tokens, scores=None,
              token_types=[1] * (len(tokens) - 1) + [3], merges=merges,
              eos_id=len(tokens) - 1, pad_id=len(tokens) - 1,
              add_eos=False)
    a = port_tok.build_tokenizer(port_loader.TokenizerSpec(**kw))
    b = ref_tok.build_tokenizer(ref_loader.TokenizerSpec(**kw))
    for p in PROMPTS:
        assert a.encode(p) == b.encode(p)
    np.testing.assert_array_equal(a.encode_batch(PROMPTS, max_length=12)[0],
                                  b.encode_batch(PROMPTS, max_length=12)[0])


def test_tokenizer_metadata_round_trips_through_gguf(tmp_path):
    dims = testing.T5Dims(d_model=64, vocab=64)
    spec = testing.unigram_spec(dims.vocab)
    path = str(tmp_path / "t5.gguf")
    testing.write_t5_gguf(testing.t5_state_dict(dims), path,
                          tokenizer=spec)
    got = port_loader.gguf_tokenizer_spec(GGUFReader(path))
    assert got.model == "t5" and got.tokens == spec.tokens
    np.testing.assert_allclose(got.scores, spec.scores, rtol=1e-6)
    assert got.token_types == spec.token_types
    assert (got.eos_id, got.pad_id, got.unk_id) == (1, 0, 2)
    assert got.add_eos and not got.add_bos
    # and the reference's reader sees the same file the same way
    from comfyui_gguf_tpu.gguf.reader import GGUFReader as RefReader

    ref = ref_loader.gguf_tokenizer_spec(RefReader(path))
    assert ref.tokens == got.tokens and ref.token_types == got.token_types
    assert port_loader.strip_quant_suffix("t5xxl-Q8_0") == "t5xxl"
    assert port_loader.strip_quant_suffix("flux1-dev-Q4_K_M") == "flux1-dev"
