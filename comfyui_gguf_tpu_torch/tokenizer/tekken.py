"""Tekken (Mistral) tokenizer rebuilt from GGUF metadata.

Mistral-family text encoders ship a rank-based byte-level BPE ("tekken"):
there is NO merges list — the merge rule is implicit in the vocab order.
Encoding repeatedly merges the adjacent byte-pair whose concatenation is
a vocab entry with the LOWEST rank (tiktoken's algorithm). The reference
reconstructs a tekken.json blob for the host tokenizer from the same GGUF
fields (reference loader.py:334-375, keyed on the (131072, 5120) Mistral
embedding); here the algorithm runs natively.

GGUF stores vocab strings in the GPT-2 byte↔unicode table; ranks are the
token ids themselves. Control tokens (token_type 3) match verbatim and
never participate in byte merges.
"""

from __future__ import annotations

import functools

import numpy as np
import regex

from .bpe import TT_CONTROL, bytes_to_unicode

# tekken pre-tokenization pattern (Mistral tekken.json / llama.cpp
# "tekken" pre-type): unicode-aware word/number/punct/whitespace splits
_TEKKEN_PAT = regex.compile(
    r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*"
    r"[\p{Ll}\p{Lm}\p{Lo}\p{M}]+|"
    r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+"
    r"[\p{Ll}\p{Lm}\p{Lo}\p{M}]*|"
    r"\p{N}{1,3}|"
    r" ?[^\s\p{L}\p{N}]+[\r\n/]*|"
    r"\s*[\r\n]+|"
    r"\s+(?!\S)|\s+"
)


class TekkenTokenizer:
    def __init__(self, spec):
        self.spec = spec
        self.tokens = spec.tokens
        self.token_types = spec.token_types or [1] * len(spec.tokens)
        byte_dec = {v: k for k, v in bytes_to_unicode().items()}
        self.byte_dec = byte_dec

        # vocab: raw byte sequence → rank (= token id); control tokens
        # kept separate for verbatim matching
        self.ranks: dict[bytes, int] = {}
        self.specials: dict[str, int] = {}
        for i, tok in enumerate(self.tokens):
            if self.token_types[i] == TT_CONTROL:
                self.specials[tok] = i
            else:
                try:
                    bs = bytes(byte_dec[c] for c in tok)
                except KeyError:  # non byte-unicode entry; match verbatim
                    self.specials[tok] = i
                    continue
                self.ranks.setdefault(bs, i)

        self.bos_id = spec.bos_id
        self.eos_id = spec.eos_id
        self.pad_id = spec.pad_id if spec.pad_id is not None else (
            spec.eos_id or 0)
        self.unk_id = spec.unk_id
        self._cache: dict[bytes, list[int]] = {}

    @property
    def vocab_size(self) -> int:
        return len(self.tokens)

    def _bpe_bytes(self, word: bytes) -> list[int]:
        """tiktoken-style rank BPE over one pre-token's bytes → ids."""
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        parts = [word[i: i + 1] for i in range(len(word))]
        while len(parts) > 1:
            best_i, best_rank = None, None
            for i in range(len(parts) - 1):
                r = self.ranks.get(parts[i] + parts[i + 1])
                if r is not None and (best_rank is None or r < best_rank):
                    best_i, best_rank = i, r
            if best_i is None:
                break
            parts = (parts[:best_i] + [parts[best_i] + parts[best_i + 1]]
                     + parts[best_i + 2:])
        ids = []
        for p in parts:
            r = self.ranks.get(p)
            if r is None:
                # single bytes should always exist in a tekken vocab;
                # fall back to unk for malformed vocabs
                r = self.unk_id if self.unk_id is not None else 0
            ids.append(r)
        self._cache[word] = ids
        return ids

    def encode(self, text: str, add_special: bool = True) -> list[int]:
        import re as _re

        ids: list[int] = []
        if self.specials:
            pat = "|".join(_re.escape(s) for s in
                           sorted(self.specials, key=len, reverse=True))
            chunks = _re.split(f"({pat})", text)
        else:
            chunks = [text]
        for chunk in chunks:
            if not chunk:
                continue
            sid = self.specials.get(chunk)
            if sid is not None:
                ids.append(sid)
                continue
            for word in _TEKKEN_PAT.findall(chunk):
                ids.extend(self._bpe_bytes(word.encode("utf-8")))
        if add_special:
            if self.spec.add_bos and self.bos_id is not None:
                ids = [self.bos_id] + ids
            if self.spec.add_eos and self.eos_id is not None:
                ids = ids + [self.eos_id]
        return ids

    def encode_batch(self, texts, max_length: int | None = None):
        enc = [self.encode(t) for t in texts]
        L = max_length or max(len(e) for e in enc)
        ids = np.full((len(enc), L), self.pad_id, dtype=np.int32)
        mask = np.zeros((len(enc), L), dtype=np.int32)
        for i, e in enumerate(enc):
            e = e[:L]
            ids[i, : len(e)] = e
            mask[i, : len(e)] = 1
        return ids, mask

    def decode(self, ids) -> str:
        data = b""
        for i in ids:
            i = int(i)
            if not (0 <= i < len(self.tokens)):
                continue
            if self.token_types[i] == TT_CONTROL:
                continue
            tok = self.tokens[i]
            data += bytes(self.byte_dec.get(c, ord("?")) for c in tok)
        return data.decode("utf-8", errors="replace")
