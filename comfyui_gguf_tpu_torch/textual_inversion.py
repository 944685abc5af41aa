"""Textual-inversion embeddings (PyTorch port of
comfyui_gguf_tpu/textual_inversion.py): learned token vectors spliced into a
text encoder's vocabulary.

The role of the ComfyUI ``embedding:name`` prompt syntax: the name resolves
to a file of vectors. Instead of editing the token stream per call, the
vectors are appended to the encoder's token table once (on the table's
device) and the prompt parser emits the new token ids, so the encoder graph
is untouched.

File formats accepted (the public conventions):
* safetensors with ``emb_params`` (A1111 SD1) → slot ``"any"``;
* safetensors with ``clip_l`` / ``clip_g`` keys (SDXL dual encoder);
* a torch ``.pt`` with ``string_to_param: {"*": tensor}`` (legacy A1111),
  read with ``torch.load(..., weights_only=True)``.
"""

from __future__ import annotations

import logging
import re

import numpy as np
import torch

from . import _safetensors

log = logging.getLogger(__name__)

EMB_RE = re.compile(r"embedding:([\w.\-]+)")

TOKEN_TABLE_KEY = "text_model.embeddings.token_embedding.weight"


def _f32(t) -> np.ndarray:
    return np.atleast_2d(torch.as_tensor(t).float().numpy())


def load_embedding_file(path: str) -> dict[str, np.ndarray]:
    """→ {slot: (n_vectors, dim) float32}; slots "clip_l", "clip_g",
    "any"."""
    out: dict[str, np.ndarray] = {}
    if path.endswith(".safetensors"):
        tensors = _safetensors.load_file(path)
        for key, slot in (("clip_l", "clip_l"), ("clip_g", "clip_g"),
                          ("emb_params", "any")):
            if key in tensors:
                out[slot] = _f32(tensors[key])
    else:
        obj = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(obj, dict):
            if "string_to_param" in obj:
                out["any"] = _f32(next(iter(
                    obj["string_to_param"].values())))
            elif "emb_params" in obj:
                out["any"] = _f32(obj["emb_params"])
    if not out:
        raise ValueError(f"unrecognized embedding file format: {path}")
    return out


def pick_slot(vectors: dict[str, np.ndarray], hidden: int,
              slot: str | None = None) -> np.ndarray | None:
    """The vector bank that matches an encoder's hidden size."""
    if slot and slot in vectors:
        v = vectors[slot]
        return v if v.shape[-1] == hidden else None
    for v in vectors.values():
        if v.shape[-1] == hidden:
            return v
    return None


def extend_token_table(params: dict, vecs: np.ndarray,
                       key: str = TOKEN_TABLE_KEY) -> tuple[dict, int]:
    """Append embedding rows to the (dense) token table, on its device and
    in its dtype. Returns (new params dict, first new token id)."""
    table = params[key]
    if not isinstance(table, torch.Tensor):
        raise TypeError(f"{key} is not a dense tensor")
    first = int(table.shape[0])
    new = dict(params)
    new[key] = torch.cat([table, torch.as_tensor(
        np.asarray(vecs, np.float32)).to(device=table.device,
                                         dtype=table.dtype)], dim=0)
    return new, first


class EmbeddingSet:
    """Registered textual inversions for ONE text encoder.

    >>> es = EmbeddingSet(clip.params, hidden=768, slot="clip_l")
    >>> es.register("mycat", "/path/mycat.safetensors")
    >>> ids = es.encode(tokenizer, "a photo of embedding:mycat", 77)
    >>> out = clip_model.encode(es.params, cfg, torch.as_tensor(ids))
    """

    def __init__(self, params: dict, hidden: int, slot: str | None = None,
                 table_key: str = TOKEN_TABLE_KEY):
        self.params = params
        self.hidden = hidden
        self.slot = slot
        self.table_key = table_key
        self.token_ids: dict[str, list[int]] = {}

    def register(self, name: str, path_or_vectors) -> list[int] | None:
        """Load and append one concept; returns its token ids (None if the
        file has no bank of this encoder's width: the other encoder's bank
        is skipped, as in the reference)."""
        if name in self.token_ids:
            return self.token_ids[name]
        if isinstance(path_or_vectors, str):
            banks = load_embedding_file(path_or_vectors)
        elif isinstance(path_or_vectors, dict):
            banks = path_or_vectors
        else:
            banks = {"any": np.atleast_2d(
                np.asarray(path_or_vectors, np.float32))}
        vecs = pick_slot(banks, self.hidden, self.slot)
        if vecs is None:
            log.info("embedding %s: no %d-dim bank, skipped", name,
                     self.hidden)
            return None
        self.params, first = extend_token_table(self.params, vecs,
                                                self.table_key)
        ids = list(range(first, first + vecs.shape[0]))
        self.token_ids[name] = ids
        return ids

    def encode(self, tokenizer, prompt: str,
               max_length: int | None = None) -> np.ndarray:
        """Tokenize with ``embedding:name`` splicing → (1, L) int32 ids."""
        return encode_prompt_ids(tokenizer, prompt, self.token_ids,
                                 max_length)


def _enc_plain(tokenizer, text: str) -> list[int]:
    try:
        return tokenizer.encode(text, add_special=False)
    except TypeError:  # unigram tokenizers use add_eos
        return tokenizer.encode(text, add_eos=False)


def encode_prompt_ids(tokenizer, prompt: str,
                      registry: dict[str, list[int]],
                      max_length: int | None = None) -> np.ndarray:
    """Encode a prompt, replacing ``embedding:name`` spans with the
    registered token ids. Unknown names tokenize as literal text (with a
    warning). Truncation never drops the EOS token."""
    body: list[int] = []
    pos = 0
    for m in EMB_RE.finditer(prompt):
        frag = prompt[pos:m.start()]
        if frag.strip():
            body.extend(_enc_plain(tokenizer, frag.strip()))
        name = m.group(1)
        if name in registry:
            body.extend(registry[name])
        else:
            log.warning("unknown embedding %r; tokenized literally", name)
            body.extend(_enc_plain(tokenizer, m.group(0)))
        pos = m.end()
    tail = prompt[pos:]
    if tail.strip():
        body.extend(_enc_plain(tokenizer, tail.strip()))

    bos = getattr(tokenizer, "bos_id", None)
    eos = getattr(tokenizer, "eos_id", None)
    if bos is not None:
        body = [bos] + body
    if eos is not None:
        body = body + [eos]
    L = max_length or len(body)
    pad = getattr(tokenizer, "pad_id", 0) or 0
    out = np.full((1, L), pad, dtype=np.int32)
    out[0, : min(len(body), L)] = body[:L]
    if eos is not None and len(body) > L:
        out[0, -1] = eos  # never truncate away the EOT token
    return out
