"""Unigram (sentencepiece-style) tokenizer built from GGUF metadata.

The reference reconstructs a serialized sentencepiece proto from the GGUF
``tokenizer.ggml.*`` fields and hands it to the host (reference
loader.py:286-332). This framework has no host, so it implements the Unigram
algorithm natively: Viterbi segmentation over the piece vocabulary with byte
fallback — the exact inference-time semantics of a sentencepiece Unigram
model (T5/UMT5).

Normalization implemented: whitespace → ▁ (U+2581), optional dummy prefix,
optional extra-whitespace collapsing. (Full NFKC/precompiled charsmap
normalization is not applied; T5's spiece models use identity-adjacent
normalizers for the characters that matter in prompts.)
"""

from __future__ import annotations

import numpy as np

_SPACE = "▁"  # ▁

# llama.cpp token_type values
TT_NORMAL = 1
TT_UNKNOWN = 2
TT_CONTROL = 3
TT_USER_DEFINED = 4
TT_UNUSED = 5
TT_BYTE = 6


class UnigramTokenizer:
    def __init__(self, spec):
        self.spec = spec
        self.tokens = spec.tokens
        self.scores = spec.scores or [0.0] * len(spec.tokens)
        types = spec.token_types or [TT_NORMAL] * len(spec.tokens)
        self.token_types = types

        self.piece_to_id: dict[str, int] = {}
        self.byte_to_id: dict[int, int] = {}
        self.max_piece_len = 1
        for i, (tok, tt) in enumerate(zip(self.tokens, types)):
            if tt == TT_BYTE:
                # pieces like "<0x0A>"
                try:
                    self.byte_to_id[int(tok[1:-1], 16)] = i
                except ValueError:
                    pass
                continue
            if tt in (TT_NORMAL, TT_USER_DEFINED, TT_UNKNOWN):
                if tok not in self.piece_to_id:
                    self.piece_to_id[tok] = i
                    self.max_piece_len = max(self.max_piece_len, len(tok))

        self.unk_id = spec.unk_id if spec.unk_id is not None else 2
        self.eos_id = spec.eos_id if spec.eos_id is not None else 1
        self.pad_id = spec.pad_id if spec.pad_id is not None else 0
        self.bos_id = spec.bos_id

    @property
    def vocab_size(self) -> int:
        return len(self.tokens)

    # -- normalization ------------------------------------------------------

    def _normalize(self, text: str) -> str:
        if self.spec.remove_extra_whitespaces:
            text = " ".join(text.split())
        if self.spec.add_space_prefix and not text.startswith((" ", _SPACE)):
            text = " " + text
        return text.replace(" ", _SPACE)

    # -- Viterbi segmentation -----------------------------------------------

    def _segment(self, text: str) -> list[int]:
        n = len(text)
        if n == 0:
            return []
        NEG = -1e18
        best = [NEG] * (n + 1)
        back: list[tuple[int, int] | None] = [None] * (n + 1)
        best[0] = 0.0
        unk_penalty = -20.0
        for i in range(n):
            if best[i] == NEG:
                continue
            limit = min(n, i + self.max_piece_len)
            for j in range(i + 1, limit + 1):
                tid = self.piece_to_id.get(text[i:j])
                if tid is not None:
                    s = best[i] + self.scores[tid]
                    if s > best[j]:
                        best[j] = s
                        back[j] = (i, tid)
            # single-char unk/byte-fallback edge keeps the lattice connected
            j = i + 1
            s = best[i] + unk_penalty
            if s > best[j]:
                best[j] = s
                back[j] = (i, -1)

        ids: list[int] = []
        pos = n
        rev: list[int] = []
        while pos > 0:
            i, tid = back[pos]
            if tid == -1:
                ch = text[i:pos]
                bs = ch.encode("utf-8")
                if self.byte_to_id:
                    rev.extend(self.byte_to_id.get(b, self.unk_id)
                               for b in reversed(bs))
                else:
                    rev.append(self.unk_id)
            else:
                rev.append(tid)
            pos = i
        ids = list(reversed(rev))
        return ids

    # -- public API ---------------------------------------------------------

    def encode(self, text: str, add_eos: bool | None = None) -> list[int]:
        ids = self._segment(self._normalize(text))
        add_eos = self.spec.add_eos if add_eos is None else add_eos
        if self.spec.add_bos and self.bos_id is not None:
            ids = [self.bos_id] + ids
        if add_eos:
            ids = ids + [self.eos_id]
        return ids

    def encode_batch(self, texts, max_length: int | None = None,
                     pad: bool = True):
        """→ (ids, mask) int32 arrays, padded to max_length (or batch max)."""
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
        out: list[str] = []
        byte_buf: list[int] = []

        def flush():
            if byte_buf:
                out.append(bytes(byte_buf).decode("utf-8", errors="replace"))
                byte_buf.clear()

        for i in ids:
            i = int(i)
            if i < 0 or i >= len(self.tokens):
                continue
            tt = self.token_types[i]
            if tt == TT_BYTE:
                try:
                    byte_buf.append(int(self.tokens[i][1:-1], 16))
                    continue
                except ValueError:
                    pass
            flush()
            if tt == TT_CONTROL:
                continue
            out.append(self.tokens[i])
        flush()
        return "".join(out).replace(_SPACE, " ").lstrip(" ")
