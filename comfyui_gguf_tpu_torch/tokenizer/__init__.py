"""Native tokenizers (the port's own copy of comfyui_gguf_tpu/tokenizer)."""

from .bpe import BPETokenizer
from .clip_bpe import CLIPBPETokenizer
from .unigram import UnigramTokenizer


def build_tokenizer(spec):
    """TokenizerSpec (loader.gguf_tokenizer_spec) → tokenizer instance."""
    if spec.model == "t5":
        return UnigramTokenizer(spec)
    if spec.model in ("gpt2", "llama-bpe"):
        # Mistral-family ("tekken") GGUFs ship NO merges list — the BPE
        # merge rule is implicit in vocab rank order
        if not spec.merges:
            # imported here: tekken needs the third-party ``regex`` module,
            # which the T5 and CLIP tokenizers do not
            from .tekken import TekkenTokenizer

            return TekkenTokenizer(spec)
        return BPETokenizer(spec)
    raise NotImplementedError(f"tokenizer model {spec.model!r}")


def __getattr__(name):
    if name == "TekkenTokenizer":
        from .tekken import TekkenTokenizer

        return TekkenTokenizer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["UnigramTokenizer", "BPETokenizer", "CLIPBPETokenizer",
           "TekkenTokenizer", "build_tokenizer"]
