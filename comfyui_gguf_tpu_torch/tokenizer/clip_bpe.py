"""CLIP BPE tokenizer (OpenAI variant) from vocab.json + merges.txt.

The SD1/SDXL CLIP encoders ship tokenizer files rather than GGUF
metadata (the reference's host bundles them; our GGUF loader only covers
tokenizers embedded in the file). CLIP BPE differs from GPT-2 BPE:

* text is lowercased and whitespace-collapsed before pre-tokenization;
* each word's final symbol carries an ``</w>`` end-of-word marker, and
  merges operate on those marked symbols;
* specials ``<|startoftext|>`` / ``<|endoftext|>`` wrap every prompt and
  EOT doubles as the pad token.

API-compatible with the GGUF-built tokenizers (encode / encode_batch /
bos_id / eos_id / pad_id) so pipelines and textual_inversion splice in
unchanged.
"""

from __future__ import annotations

import json
import re

import numpy as np

from .bpe import bytes_to_unicode

# letters are [^\W\d_] (NOT [^\s\d\W], which includes underscore):
# the OpenAI CLIP pattern splits on _ — "long_hair" must tokenize as
# "long" "_" "hair" or the merges table (built for the split form)
# produces different ids than the model was trained with
_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\W\d_]+|\d|[^\s\w]+|_+",
    re.IGNORECASE,
)


class CLIPBPETokenizer:
    def __init__(self, vocab: dict[str, int], merges: list[str]):
        self.vocab = vocab
        self.tokens = [t for t, _ in sorted(vocab.items(),
                                            key=lambda kv: kv[1])]
        self.merge_ranks = {}
        for rank, m in enumerate(merges):
            a, _, b = m.partition(" ")
            self.merge_ranks[(a, b)] = rank
        self.byte_enc = bytes_to_unicode()
        self.byte_dec = {v: k for k, v in self.byte_enc.items()}
        self.bos_id = vocab.get("<|startoftext|>")
        self.eos_id = vocab.get("<|endoftext|>")
        self.pad_id = self.eos_id  # CLIP pads with EOT
        self._cache: dict[str, list[str]] = {}

    @classmethod
    def from_files(cls, vocab_json: str, merges_txt: str
                   ) -> "CLIPBPETokenizer":
        with open(vocab_json, encoding="utf-8") as f:
            vocab = json.load(f)
        with open(merges_txt, encoding="utf-8") as f:
            lines = f.read().splitlines()
        # merges.txt starts with a "#version:" header line
        merges = [ln for ln in lines if ln and not ln.startswith("#")]
        return cls(vocab, merges)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def _bpe(self, word: str) -> list[str]:
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        parts = list(word[:-1]) + [word[-1] + "</w>"]
        while len(parts) > 1:
            best = best_rank = None
            for i in range(len(parts) - 1):
                r = self.merge_ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                break
            parts = (parts[:best] + [parts[best] + parts[best + 1]]
                     + parts[best + 2:])
        self._cache[word] = parts
        return parts

    def encode(self, text: str, add_special: bool = True) -> list[int]:
        text = re.sub(r"\s+", " ", text.strip()).lower()
        ids: list[int] = []
        for tok in _PAT.findall(text):
            if tok in ("<|startoftext|>", "<|endoftext|>"):
                ids.append(self.vocab[tok])
                continue
            word = "".join(self.byte_enc[b] for b in tok.encode("utf-8"))
            for piece in self._bpe(word):
                tid = self.vocab.get(piece)
                if tid is None:  # unmergeable symbol: per-char fallback
                    # strip the end-of-word marker first — iterating it
                    # would emit ids for the literal "<", "/", "w", ">"
                    chars = (piece[: -len("</w>")]
                             if piece.endswith("</w>") else piece)
                    if chars:
                        last = self.vocab.get(chars[-1] + "</w>",
                                              self.vocab.get(chars[-1], 0))
                        ids.extend(self.vocab.get(c, 0)
                                   for c in chars[:-1])
                        ids.append(last)
                else:
                    ids.append(tid)
        if add_special:
            ids = [self.bos_id] + ids + [self.eos_id]
        return ids

    def encode_batch(self, texts, max_length: int | None = None):
        enc = [self.encode(t) for t in texts]
        L = max_length or max(len(e) for e in enc)
        ids = np.full((len(enc), L), self.pad_id, dtype=np.int32)
        mask = np.zeros((len(enc), L), dtype=np.int32)
        for i, e in enumerate(enc):
            if len(e) > L:  # keep EOT when truncating
                e = e[: L - 1] + [self.eos_id]
            ids[i, : len(e)] = e
            mask[i, : len(e)] = 1
        return ids, mask

    def decode(self, ids) -> str:
        out = []
        for i in ids:
            i = int(i)
            if 0 <= i < len(self.tokens):
                t = self.tokens[i]
                if t in ("<|startoftext|>", "<|endoftext|>"):
                    continue
                word, _, _ = t.partition("</w>")
                data = bytes(self.byte_dec.get(c, ord("?")) for c in word)
                out.append(data.decode("utf-8", errors="replace"))
                if t.endswith("</w>"):
                    out.append(" ")
        return "".join(out).strip()
