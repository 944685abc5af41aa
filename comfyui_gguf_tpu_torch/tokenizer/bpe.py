"""Byte-level BPE tokenizer built from GGUF metadata.

Covers the llama/qwen text-encoder tokenizers ("gpt2" model in
``tokenizer.ggml.model``). The reference instead re-serializes the vocab into
a tekken/JSON blob for the host (reference loader.py:334-375); here the BPE
merge algorithm runs natively.
"""

from __future__ import annotations

import functools
import re

import numpy as np

TT_CONTROL = 3


@functools.cache
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte ↔ printable-unicode-char table (public
    algorithm from the GPT-2 release; also what llama.cpp stores vocab in)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


# GPT-2 pre-tokenization regex (contractions, letter runs, number runs, ...)
_GPT2_PAT = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d| ?[^\s\d\W]+| ?\d+| ?[^\s\w]+|\s+(?!\S)|\s+"
)


class BPETokenizer:
    def __init__(self, spec):
        self.spec = spec
        self.tokens = spec.tokens
        self.token_types = spec.token_types or [1] * len(spec.tokens)
        self.vocab = {t: i for i, t in enumerate(spec.tokens)}
        merges = spec.merges or []
        self.merge_ranks: dict[tuple[str, str], int] = {}
        for rank, m in enumerate(merges):
            a, _, b = m.partition(" ")
            self.merge_ranks[(a, b)] = rank
        self.byte_enc = bytes_to_unicode()
        self.byte_dec = {v: k for k, v in self.byte_enc.items()}
        self.specials = {
            t: i for i, t in enumerate(spec.tokens)
            if self.token_types[i] == TT_CONTROL
        }
        self.eos_id = spec.eos_id
        self.bos_id = spec.bos_id
        self.pad_id = spec.pad_id if spec.pad_id is not None else (
            spec.eos_id or 0)
        self._cache: dict[str, list[str]] = {}

    @property
    def vocab_size(self) -> int:
        return len(self.tokens)

    def _bpe(self, word: str) -> list[str]:
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        parts = list(word)
        while len(parts) > 1:
            best = None
            best_rank = None
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
        ids: list[int] = []
        # split out control tokens verbatim
        if self.specials:
            pat = "|".join(re.escape(s) for s in
                           sorted(self.specials, key=len, reverse=True))
            chunks = re.split(f"({pat})", text)
        else:
            chunks = [text]
        for chunk in chunks:
            if not chunk:
                continue
            sid = self.specials.get(chunk)
            if sid is not None:
                ids.append(sid)
                continue
            for word in _GPT2_PAT.findall(chunk):
                enc = "".join(self.byte_enc[b] for b in word.encode("utf-8"))
                for piece in self._bpe(enc):
                    tid = self.vocab.get(piece)
                    if tid is None:
                        # fall back to per-char tokens
                        ids.extend(self.vocab.get(c, 0) for c in piece)
                    else:
                        ids.append(tid)
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
            if len(e) > L:
                # keep the final special (eos) when truncating — CLIP
                # pooling reads the first-eos position and SD prompts
                # longer than the context window would otherwise lose it
                e = e[: L - 1] + [e[-1]]
            ids[i, : len(e)] = e
            mask[i, : len(e)] = 1
        return ids, mask

    def decode(self, ids) -> str:
        out = []
        for i in ids:
            i = int(i)
            if 0 <= i < len(self.tokens) and self.token_types[i] != TT_CONTROL:
                out.append(self.tokens[i])
        text = "".join(out)
        data = bytes(self.byte_dec.get(c, ord("?")) for c in text)
        return data.decode("utf-8", errors="replace")
