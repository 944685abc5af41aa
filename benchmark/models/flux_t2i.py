"""FLUX.1 text to image in the benchmark: the transformer (as
``flux.py``), the T5-v1.1-xxl encoder (Q8_0), CLIP-L and the VAE decoder;
a seed-made vocabulary for both tokenizers; prompts; the work of an image;
and how the program's ``FluxPipeline`` is built. The references are
``flux_ref.py`` (the transformer) and ``flux_t2i_ref.py`` (the
tokenizers, the encoders and the decoder)."""

from __future__ import annotations

import numpy as np
import torch

import flux as dit
from weights import Group
from work import conv_work, gemm_work, linear_work

FORWARD = ("models.flux", "forward")  # the flat tree's forward
DECODE = ("models.vae", "decode_auto")
ENCODE = {"t5": ("models.t5", "encode"), "clip": ("models.clip", "encode")}
OP_MODULES = {"dit": "models.flux", "t5": "models.t5", "clip": "models.clip",
              "vae": "models.vae"}
SPACE = "▁"
T5_SPECIAL = ("<pad>", "</s>", "<unk>")  # ids 0, 1, 2
CLIP_SPECIAL = ("<|startoftext|>", "<|endoftext|>")  # the last two ids


def part(cfg: dict, name: str) -> dict:
    """The configuration of one part in the form its adapter takes
    (``dit``: ``flux.py``'s)."""
    if name == "dit":
        return {"config": cfg["config"]["transformer"],
                "formats": cfg["formats"], "tree": cfg["tree"]}
    return cfg["config"][name]


# -- the vocabulary -----------------------------------------------------------

def words(cfg: dict) -> list[str]:
    """The prompts' vocabulary: ``vocab_words`` lower-case pseudo-words,
    drawn once from a fixed generator (part of the yardstick)."""
    rng = np.random.default_rng(20260)
    out, seen = [], set()
    while len(out) < cfg["vocab_words"]:
        n = int(rng.integers(3, 10))
        w = "".join(chr(97 + int(c)) for c in rng.integers(0, 26, n))
        if w not in seen:
            seen.add(w)
            out.append(w)
    return out


def t5_pieces(cfg: dict) -> tuple[list[str], list[float]]:
    """A unigram vocabulary of the encoder's size: the specials, "▁", a
    whole-word piece "▁w" per word (scores -1 ... -2 by rank), the
    printable ASCII characters (-8), unused fillers."""
    ws = words(cfg)
    pieces = list(T5_SPECIAL) + [SPACE] + [SPACE + w for w in ws] \
        + [chr(c) for c in range(33, 127)]
    scores = [0.0] * 3 + [-8.0] + [-1.0 - r / len(ws) for r in range(len(ws))] \
        + [-8.0] * 94
    n = cfg["config"]["t5"]["vocab_size"]
    pieces += [f"<unused_{i}>" for i in range(len(pieces), n)]
    scores += [0.0] * (n - len(scores))
    return pieces, scores


def byte_symbols() -> list[str]:
    """GPT-2's byte → printable-character table, as CLIP's BPE uses it."""
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
    table = dict(zip(bs, cs))
    return [chr(table[b]) for b in range(256)]


def clip_vocab(cfg: dict) -> tuple[dict, list[str]]:
    """A CLIP BPE vocabulary of the encoder's size, in the real file's
    order: the byte symbols, their end-of-word forms, the products of each
    word's merges (left to right), fillers, the two specials last."""
    syms = byte_symbols()
    tokens = syms + [s + "</w>" for s in syms]
    merges, known = [], set(tokens)
    for w in words(cfg):
        parts = list(w[:-1]) + [w[-1] + "</w>"]
        while len(parts) > 1:
            merged = parts[0] + parts[1]
            if merged not in known:
                merges.append(f"{parts[0]} {parts[1]}")
                tokens.append(merged)
                known.add(merged)
            parts = [merged] + parts[2:]
    n = cfg["config"]["clip"]["vocab_size"]
    tokens += [f"<filler_{i}>" for i in range(len(tokens), n - 2)]
    tokens += list(CLIP_SPECIAL)
    return {t: i for i, t in enumerate(tokens)}, merges


def prompt(rng: np.random.Generator, cfg: dict, traffic: dict) -> str:
    lo, hi = traffic["prompt_words"]
    ws = words(cfg)
    n = int(rng.integers(lo, hi + 1))
    return " ".join(ws[int(i)] for i in rng.integers(0, len(ws), n))


# -- the tensors --------------------------------------------------------------

def groups(cfg: dict) -> dict:
    """{part: its tensors} as the configuration stores them."""
    t5, clip, vae = (cfg["config"][k] for k in ("t5", "clip", "vae"))
    fmt = cfg["formats"]
    out = {"dit": dit.groups(part(cfg, "dit"))}

    D, F, n = t5["d_model"], t5["d_ff"], t5["num_layers"]
    inner = t5["num_heads"] * t5["d_kv"]
    p = "encoder.block.{i}."
    g = [Group("shared.weight", (t5["vocab_size"], D), fmt["t5"], "matrix"),
         Group("encoder.block.0.layer.0.SelfAttention.relative_attention_"
               "bias.weight", (t5["relative_attention_num_buckets"],
                               t5["num_heads"]), "F32", "table"),
         Group("encoder.final_layer_norm.weight", (D,), "F32", "gain")]
    # T5 scales no score by 1/sqrt(d_kv): its query projection is drawn
    # that much smaller, as T5's own initialisation does (else the scores
    # spread by 8, and 24 layers of such attention amplify every rounding)
    for m, scale in (("q", t5["d_kv"] ** -0.5), ("k", 1.0), ("v", 1.0)):
        g.append(Group(p + f"layer.0.SelfAttention.{m}.weight", (inner, D),
                       fmt["t5"], "matrix", n, scale))
    g.append(Group(p + "layer.0.SelfAttention.o.weight", (D, inner),
                   fmt["t5"], "matrix", n))
    for m in ("wi_0", "wi_1"):
        g.append(Group(p + f"layer.1.DenseReluDense.{m}.weight", (F, D),
                       fmt["t5"], "matrix", n))
    g.append(Group(p + "layer.1.DenseReluDense.wo.weight", (D, F), fmt["t5"],
                   "matrix", n))
    for j in (0, 1):
        g.append(Group(p + f"layer.{j}.layer_norm.weight", (D,), "F32",
                       "gain", n))
    out["t5"] = g

    H, I, n = clip["hidden_size"], clip["intermediate_size"], \
        clip["num_hidden_layers"]
    p = "text_model.encoder.layers.{i}."
    g = [Group("text_model.embeddings.token_embedding.weight",
               (clip["vocab_size"], H), fmt["clip"], "table"),
         Group("text_model.embeddings.position_embedding.weight",
               (clip["max_position_embeddings"], H), fmt["clip"], "table"),
         Group("text_model.final_layer_norm.weight", (H,), "F32", "gain"),
         Group("text_model.final_layer_norm.bias", (H,), "F32", "bias")]

    def lin(key, r, k, f, depth=None):
        g.append(Group(key + ".weight", (r, k), f, "matrix", depth))
        g.append(Group(key + ".bias", (r,), "F32", "bias", depth))

    for m in ("q_proj", "k_proj", "v_proj", "out_proj"):
        lin(p + f"self_attn.{m}", H, H, fmt["clip"], n)
    lin(p + "mlp.fc1", I, H, fmt["clip"], n)
    lin(p + "mlp.fc2", H, I, fmt["clip"], n)
    for m in ("layer_norm1", "layer_norm2"):
        g.append(Group(p + m + ".weight", (H,), "F32", "gain", n))
        g.append(Group(p + m + ".bias", (H,), "F32", "bias", n))
    out["clip"] = g

    g = []

    def conv(name, o, i, k=3):
        g.append(Group(name + ".weight", (o, i, k, k), fmt["vae"], "matrix"))
        g.append(Group(name + ".bias", (o,), "F32", "bias"))

    def norm(name, c):
        g.append(Group(name + ".weight", (c,), "F32", "gain"))
        g.append(Group(name + ".bias", (c,), "F32", "bias"))

    for name, cin, cout in vae_resnets(cfg):
        norm(f"{name}.norm1", cin)
        conv(f"{name}.conv1", cout, cin)
        norm(f"{name}.norm2", cout)
        conv(f"{name}.conv2", cout, cout)
        if cin != cout:
            conv(f"{name}.nin_shortcut", cout, cin, 1)
    base, top = vae["block_out_channels"][0], vae["block_out_channels"][-1]
    conv("decoder.conv_in", top, vae["latent_channels"])
    norm("decoder.mid.attn_1.norm", top)
    for m in ("q", "k", "v", "proj_out"):
        conv(f"decoder.mid.attn_1.{m}", top, top, 1)
    for i in range(1, len(vae["block_out_channels"])):
        c = vae["block_out_channels"][i]
        conv(f"decoder.up.{i}.upsample.conv", c, c)
    norm("decoder.norm_out", base)
    conv("decoder.conv_out", vae["out_channels"], base)
    out["vae"] = g
    return out


def vae_resnets(cfg: dict) -> list[tuple[str, int, int]]:
    """(name, in, out channels) of the decoder's resnet blocks, in order."""
    vae = cfg["config"]["vae"]
    chans = vae["block_out_channels"]
    top = chans[-1]
    out = [("decoder.mid.block_1", top, top),
           ("decoder.mid.block_2", top, top)]
    cur = top
    for i in reversed(range(len(chans))):
        for j in range(vae["layers_per_block"] + 1):
            out.append((f"decoder.up.{i}.block.{j}", cur, chans[i]))
            cur = chans[i]
    return out


# -- the program --------------------------------------------------------------

def load(raw: dict, device) -> dict:
    """Each part's stored tensors as the program loads them: the
    transformer and the encoders through its GGUF loader, the VAE as
    ``load_vae`` reads a safetensors file (widened to float32)."""
    import program

    params = {k: program.load_params(raw[k], device)
              for k in ("dit", "t5", "clip")}
    params["vae"] = {k: torch.from_numpy(a).to(device=device,
                                            dtype=torch.float32)
                     .reshape(shape)
                     for k, (_, shape, a) in raw["vae"].items()}
    return params


def build(params: dict, cfg: dict, device):
    """The program's ``FluxPipeline`` over the loaded parts, on the flat
    tree as ``examples/torch_generate_flux.py`` builds it."""
    from comfyui_gguf_tpu_torch.loader import TokenizerSpec
    from comfyui_gguf_tpu_torch.models import clip, t5, vae
    from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
    from comfyui_gguf_tpu_torch.pipeline import FluxPipeline, TextEncoder
    from comfyui_gguf_tpu_torch.tokenizer import (CLIPBPETokenizer,
                                                  UnigramTokenizer)

    device = torch.device(device)
    model = dit.build(params["dit"], part(cfg, "dit"), device)
    pieces, scores = t5_pieces(cfg)
    spec = TokenizerSpec(model="t5", tokens=pieces, scores=scores,
                         token_types=[3, 3, 2] + [1] * (len(pieces) - 3),
                         eos_id=1, pad_id=0, unk_id=2)
    t5_enc = TextEncoder("t5", params["t5"],
                         t5.T5Config.from_state_dict(params["t5"]),
                         UnigramTokenizer(spec), QuantConfig(), device)
    clip_enc = TextEncoder("clip_l", params["clip"],
                           clip.CLIPTextConfig.from_state_dict(
                               params["clip"]),
                           CLIPBPETokenizer(*clip_vocab(cfg)), QuantConfig(),
                           device)
    return FluxPipeline(model, t5_enc, clip_enc, params["vae"],
                        vae.VAEConfig.from_state_dict(params["vae"]))


def dit_reference(W, cfg: dict, traffic: dict, x, t, txt, y):
    """The reference transformer's velocity at the program's latent tokens
    ``x`` (1, L, C·4) and sigma ``t``, from the reference's own text states
    ``txt`` and pooled vector ``y``."""
    g = torch.tensor(float(traffic["guidance"]), device=x.device)
    req = {"cond": {"txt": txt[0], "y": y[0], "guidance": g}}
    outs, _ = dit.reference(W, part(cfg, "dit"), traffic, [req], x,
                            t.reshape(1))
    return outs[0]


# -- the work of an image -----------------------------------------------------

def work(cfg: dict, traffic: dict, lanes: int) -> dict:
    """The work of one image (``lanes`` is 1): T5 over its padded tokens,
    CLIP over 77, the transformer's ``steps`` forwards, the VAE decode;
    the encoders' and the decoder's attention is written out in the
    program as GEMMs, counted with the linears (their kernels are library
    GEMMs)."""
    t5, clip, vae = (cfg["config"][k] for k in ("t5", "clip", "vae"))
    fmt = cfg["formats"]
    lin, att, conv = [], [], []
    step = dit.work(part(cfg, "dit"), traffic, lanes)
    for _ in range(traffic["steps"]):
        lin += step["linear"]
        att += step["attention"]
    L, D, F, nh, dk = (traffic["text_tokens"], t5["d_model"], t5["d_ff"],
                       t5["num_heads"], t5["d_kv"])
    for _ in range(t5["num_layers"]):
        lin += [linear_work(L, D, nh * dk, fmt["t5"])] * 3
        lin.append(linear_work(L, nh * dk, D, fmt["t5"]))
        lin += [linear_work(L, D, F, fmt["t5"])] * 2
        lin.append(linear_work(L, F, D, fmt["t5"]))
        lin += [gemm_work(nh, L, dk, L), gemm_work(nh, L, L, dk)]
    L, H, I, nh = (clip["max_position_embeddings"], clip["hidden_size"],
                   clip["intermediate_size"], clip["num_attention_heads"])
    for _ in range(clip["num_hidden_layers"]):
        lin += [linear_work(L, H, H, fmt["clip"])] * 4
        lin += [linear_work(L, H, I, fmt["clip"]),
                linear_work(L, I, H, fmt["clip"])]
        lin += [gemm_work(nh, L, H // nh, L), gemm_work(nh, L, L, H // nh)]
    h, w = traffic["height"] // 8, traffic["width"] // 8
    chans = vae["block_out_channels"]
    top = chans[-1]
    conv.append(conv_work(h, w, vae["latent_channels"], top, 3))
    res = {name: (cin, cout) for name, cin, cout in vae_resnets(cfg)}
    level = len(chans) - 1

    def resnet(name, s):
        cin, cout = res[name]
        conv.extend([conv_work(s[0], s[1], cin, cout, 3),
                     conv_work(s[0], s[1], cout, cout, 3)])
        if cin != cout:
            conv.append(conv_work(s[0], s[1], cin, cout, 1))

    resnet("decoder.mid.block_1", (h, w))
    conv.extend([conv_work(h, w, top, top, 1)] * 4)
    lin += [gemm_work(1, h * w, top, h * w),
            gemm_work(1, h * w, h * w, top)]
    resnet("decoder.mid.block_2", (h, w))
    for i in reversed(range(len(chans))):
        s = (h * 2 ** (level - i), w * 2 ** (level - i))
        for j in range(vae["layers_per_block"] + 1):
            resnet(f"decoder.up.{i}.block.{j}", s)
        if i > 0:
            conv.append(conv_work(2 * s[0], 2 * s[1], chans[i], chans[i], 3))
    s = (h * 2 ** level, w * 2 ** level)
    conv.append(conv_work(s[0], s[1], chans[0], vae["out_channels"], 3))
    return {"linear": lin, "attention": att, "conv": conv}
