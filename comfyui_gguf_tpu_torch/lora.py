"""LoRA patch pipeline (PyTorch port of comfyui_gguf_tpu/lora.py): load,
map keys, attach to packed weights, apply at matmul time.

A patched weight stays packed. The patch is applied as a rank-factored term
on the output,

    y = x @ (W + s·B·A)ᵀ  =  qmm(x, W_packed) + s·((x @ Aᵀ) @ Bᵀ),

the same linear map at O(r·(K+R)) extra operations, and the patched weight
is never materialized. On the card the rank term runs inside the fused
kernels' epilogues (K1/K2 ``csrc/qmm*.cu``, K4 ``csrc/i8mm.cu``): only the
small rank intermediate ``h = x @ downᵀ`` is computed outside them, here.
Full-rank patch types (diff, LoHa, LoKr) fold into a dense delta added after
the kernel. GLoRA's weight-dependent term rewrites the kernel's input.

The factors of a patch live on the device of the weight they patch, in the
patch dtype (``QuantConfig.effective_patch_dtype``, bfloat16 by default).
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from . import _safetensors

log = logging.getLogger(__name__)


def _sl(t, i):
    return None if t is None else t[i]


@dataclasses.dataclass(frozen=True)
class LoRAPatch:
    """One additive patch: ΔW = scale · up @ (mid @)? down, or dense diff.

    GLoRA additionally carries a weight-dependent term ΔW += scale · W @ a2
    @ a1, applied as an input-side rank rewrite (``apply_patch_prologue``),
    so the packed base weight is reused and never dequantized. Tensor fields
    may carry a leading depth axis (a depth-stacked group); ``self[i]`` is
    block i as views."""

    up: torch.Tensor | None  # (R, r)
    down: torch.Tensor | None  # (r, K)
    mid: torch.Tensor | None  # (r, r) LoCon mid block, rarely present
    diff: torch.Tensor | None  # dense (R, K) delta
    scale: float
    a1: torch.Tensor | None = None  # glora (r, K)
    a2: torch.Tensor | None = None  # glora (K, r)

    def __getitem__(self, i: int) -> "LoRAPatch":
        return dataclasses.replace(
            self, up=_sl(self.up, i), down=_sl(self.down, i),
            mid=_sl(self.mid, i), diff=_sl(self.diff, i),
            a1=_sl(self.a1, i), a2=_sl(self.a2, i))


@dataclasses.dataclass(frozen=True)
class PatchedWeight:
    """A weight leaf (dense tensor, PlanarQuant or I8Planar) + pending LoRA
    patches; ``self[i]`` is block i of a depth-stacked one, as views."""

    base: object
    patches: tuple[LoRAPatch, ...]

    def __getitem__(self, i: int) -> "PatchedWeight":
        return PatchedWeight(self.base[i], tuple(p[i] for p in self.patches))


def _dot(a: torch.Tensor, b: torch.Tensor, dt) -> torch.Tensor:
    """a @ b over operands rounded to ``dt``, accumulated in float32 (the
    reference's ``preferred_element_type=float32``); a float32 result."""
    return torch.matmul(a.to(dt).to(torch.float32),
                        b.to(dt).to(torch.float32))


def _dot_round(a: torch.Tensor, b: torch.Tensor, dt) -> torch.Tensor:
    """``_dot`` rounded to ``dt``. On the card a half-precision product is
    one library matmul in ``dt``, which accumulates in float32 itself."""
    if a.is_cuda and dt in (torch.bfloat16, torch.float16):
        return torch.matmul(a.to(dt), b.to(dt))
    return _dot(a, b, dt).to(dt)


def _scaled(t: torch.Tensor, scale: float, dt) -> torch.Tensor:
    """(scale · t in float32) rounded to ``dt``. For a ``dt`` tensor that
    is one multiply: torch computes a bf16/f16 product in float32 (the
    scalar rounded to float32) and rounds it once, which is the same
    value."""
    if t.dtype == dt:
        return t * scale
    return (scale * t.to(torch.float32)).to(dt)


def apply_patch_prologue(x: torch.Tensor, patches: tuple[LoRAPatch, ...],
                         patch_dtype=None) -> torch.Tensor:
    """GLoRA input rewrite: x' = x + Σ scale · (x @ a1ᵀ) @ a2ᵀ.

    Running x' through the base weight yields exactly the scale·W@a2@a1
    term of the GLoRA delta at O(r·K). Every patch rewrites the ORIGINAL
    input, so stacked GLoRAs sum independent deltas as the folded
    ``materialize`` does."""
    dt = patch_dtype or x.dtype
    x0 = x
    for p in patches:
        if p.a1 is None:
            continue
        h = _dot_round(x0, p.a1.T, dt)
        h = _dot(h, p.a2.T, dt)
        x = x + (p.scale * h).to(x.dtype)
    return x


def rank_factorize(x: torch.Tensor, patches: tuple[LoRAPatch, ...],
                   patch_dtype=None):
    """Reduce a patch list to ONE (h, upᵀ) pair for the fused kernel
    epilogue: Σ scale·x@ΔWᵀ = h @ upᵀ, with h = [x@downᵀ(@midᵀ)?…] the
    column-concatenated rank intermediates (in the patch dtype) and upᵀ
    (Σr, R) the scale-folded up factors. None when any patch needs the
    dense path (diff / LoHa / LoKr) — callers then take
    ``apply_patch_epilogue``. GLoRA patches take part with their b-branch
    only (the a-branch rides ``apply_patch_prologue`` on the kernel's
    input)."""
    dt = patch_dtype or x.dtype
    hs, ups = [], []
    for p in patches:
        if p.diff is not None:
            return None
        if p.up is None:
            continue  # prologue-only GLoRA: nothing for the epilogue
        h = _dot_round(x, p.down.T, dt)
        if p.mid is not None:
            h = _dot_round(h, p.mid.T, dt)
        hs.append(h)
        ups.append(_scaled(p.up, p.scale, dt))
    if not hs:
        return None
    # upᵀ as a view of the (R, Σr) scale-folded up factors, the layout the
    # CUDA kernels read
    return (torch.cat(hs, dim=-1) if len(hs) > 1 else hs[0],
            (torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]).T)


def apply_patch_epilogue(x: torch.Tensor, out: torch.Tensor,
                         patches: tuple[LoRAPatch, ...],
                         patch_dtype=None) -> torch.Tensor:
    """out += Σ scale · x @ ΔWᵀ, rank-factored where possible; several
    plain rank patches batch into one concatenated rank-Σr product pair
    (scales folded into the up factor). The (M, R) delta of a rank patch is
    emitted in the patch dtype."""
    dt = patch_dtype or x.dtype
    acc = out
    plain = [p for p in patches
             if p.diff is None and p.up is not None and p.mid is None]
    if len(plain) > 1:
        down_cat = torch.cat([p.down.to(dt) for p in plain], dim=0)
        up_cat = torch.cat([_scaled(p.up, p.scale, dt) for p in plain],
                           dim=1)
        h = _dot_round(x, down_cat.T, dt)
        acc = acc + _dot_round(h, up_cat.T, dt).to(acc.dtype)
        plain_ids = {id(p) for p in plain}
        patches = tuple(p for p in patches if id(p) not in plain_ids)
    for p in patches:
        if p.diff is None and p.up is None:
            continue  # prologue-only GLoRA
        if p.diff is not None:
            delta = _dot(x, p.diff.T, dt)
            acc = acc + (p.scale * delta).to(acc.dtype)
            continue
        h = _dot_round(x, p.down.T, dt)
        if p.mid is not None:
            h = _dot_round(h, p.mid.T, dt)
        delta = _dot_round(_scaled(h, p.scale, dt), p.up.T, dt)
        acc = acc + delta.to(acc.dtype)
    return acc


# ---------------------------------------------------------------------------
# LoRA file loading + key mapping
# ---------------------------------------------------------------------------

def load_lora_safetensors(path: str) -> dict[str, np.ndarray]:
    """A LoRA file as numpy arrays, bf16/f16 widened to f32."""
    return _safetensors.load_state_dict(path)


_PREFIXES = ("lora_unet_", "lora_transformer_", "lora_te_", "")
_SUFFIX_SETS = (
    # kohya: lora_up/lora_down/alpha
    (".lora_up.weight", ".lora_down.weight", ".alpha"),
    # PEFT/diffusers: lora_B/lora_A
    (".lora_B.weight", ".lora_A.weight", ".alpha"),
    (".lora.up.weight", ".lora.down.weight", ".alpha"),
)

# LoHa (Hadamard) / LoKr (Kronecker) / GLoRA component suffixes → slots
_EXTRA_SUFFIXES = {
    ".diff": "diff",
    ".lora_mid.weight": "mid",
    ".hada_w1_a": "hada_w1_a", ".hada_w1_b": "hada_w1_b",
    ".hada_w2_a": "hada_w2_a", ".hada_w2_b": "hada_w2_b",
    ".lokr_w1": "lokr_w1", ".lokr_w2": "lokr_w2",
    ".lokr_w1_a": "lokr_w1_a", ".lokr_w1_b": "lokr_w1_b",
    ".lokr_w2_a": "lokr_w2_a", ".lokr_w2_b": "lokr_w2_b",
    ".a1.weight": "glora_a1", ".a2.weight": "glora_a2",
    ".b1.weight": "glora_b1", ".b2.weight": "glora_b2",
}


def group_lora_keys(lora_sd: dict[str, np.ndarray]):
    """Group raw LoRA keys → {base_name: {slot: array}} (lora/LoCon, diff,
    LoHa, LoKr and GLoRA component slots)."""
    groups: dict[str, dict[str, np.ndarray]] = {}
    for k, v in lora_sd.items():
        for up_s, down_s, alpha_s in _SUFFIX_SETS:
            if k.endswith(up_s):
                groups.setdefault(k[: -len(up_s)], {})["up"] = v
                break
            if k.endswith(down_s):
                groups.setdefault(k[: -len(down_s)], {})["down"] = v
                break
            if k.endswith(alpha_s):
                groups.setdefault(k[: -len(alpha_s)], {})["alpha"] = v
                break
        else:
            for suf, slot in _EXTRA_SUFFIXES.items():
                if k.endswith(suf):
                    groups.setdefault(k[: -len(suf)], {})[slot] = v
                    break
    return groups


def _loha_delta(parts, strength: float) -> tuple[np.ndarray, float]:
    """LoHa: ΔW = (w1a·w1b) ⊙ (w2a·w2b), scale = strength·alpha/rank."""
    w1 = np.asarray(parts["hada_w1_a"], np.float32) @ np.asarray(
        parts["hada_w1_b"], np.float32)
    w2 = np.asarray(parts["hada_w2_a"], np.float32) @ np.asarray(
        parts["hada_w2_b"], np.float32)
    rank = np.asarray(parts["hada_w1_b"]).shape[0]
    alpha = float(np.asarray(parts.get("alpha", rank)))
    return w1 * w2, strength * alpha / rank


def _lokr_delta(parts, strength: float) -> tuple[np.ndarray, float]:
    """LoKr: ΔW = kron(w1, w2); factored components recomposed first."""
    if "lokr_w1" in parts:
        w1 = np.asarray(parts["lokr_w1"], np.float32)
        rank = None
    else:
        a = np.asarray(parts["lokr_w1_a"], np.float32)
        b = np.asarray(parts["lokr_w1_b"], np.float32)
        w1 = a @ b
        rank = a.shape[1]
    if "lokr_w2" in parts:
        w2 = np.asarray(parts["lokr_w2"], np.float32)
    else:
        a = np.asarray(parts["lokr_w2_a"], np.float32)
        b = np.asarray(parts["lokr_w2_b"], np.float32)
        w2 = a @ b
        rank = rank or a.shape[1]
    if w2.ndim > 2:
        w2 = w2.reshape(w2.shape[0], -1)
    alpha = float(np.asarray(parts.get("alpha", rank or 1)))
    scale = strength * (alpha / rank if rank else 1.0)
    return np.kron(w1, w2), scale


def map_lora_to_model_keys(groups: dict, model_keys) -> dict:
    """Resolve LoRA base names to model weight keys: kohya
    underscore-mangled names (``lora_unet_double_blocks_0_…``) match
    underscore-collapsed model keys, plain and ``transformer.``-prefixed
    dotted names match as they are."""
    by_mangled: dict[str, str] = {}
    for mk in model_keys:
        if not mk.endswith(".weight"):
            continue
        stem = mk[: -len(".weight")]
        by_mangled[stem.replace(".", "_")] = mk
        by_mangled[stem] = mk

    mapped = {}
    unmatched = []
    for base, parts in groups.items():
        cand = base
        for pfx in _PREFIXES:
            if base.startswith(pfx):
                cand = base[len(pfx):]
                break
        if cand.startswith("transformer."):
            cand = cand[len("transformer."):]
        mk = by_mangled.get(cand) or by_mangled.get(cand.replace(".", "_"))
        if mk is None:
            unmatched.append(base)
            continue
        mapped[mk] = parts
    if unmatched:
        log.warning("LoRA: %d unmatched keys (e.g. %s)", len(unmatched),
                    unmatched[:3])
    return mapped


def build_patches(mapped: dict, strength: float = 1.0, dtype=torch.bfloat16,
                  device="cpu") -> dict[str, tuple[LoRAPatch, ...]]:
    """→ {model_key: (LoRAPatch, ...)} with factors in ``dtype`` on
    ``device``; scale = strength · alpha / rank."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            device=device, dtype=dtype)

    out: dict[str, tuple[LoRAPatch, ...]] = {}
    for mk, parts in mapped.items():
        if "diff" in parts:
            patch = LoRAPatch(up=None, down=None, mid=None,
                              diff=t(parts["diff"]), scale=float(strength))
        elif "hada_w1_a" in parts:
            delta, scale = _loha_delta(parts, strength)
            patch = LoRAPatch(up=None, down=None, mid=None, diff=t(delta),
                              scale=scale)
        elif "lokr_w1" in parts or "lokr_w1_a" in parts:
            delta, scale = _lokr_delta(parts, strength)
            patch = LoRAPatch(up=None, down=None, mid=None, diff=t(delta),
                              scale=scale)
        elif "glora_a1" in parts:
            # GLoRA, OLD layout: ΔW = s·(b2@b1 + W@a2@a1) with a1 (r, K),
            # a2 (K, r), b1 (r, K), b2 (R, r). The NEW layout transposes
            # every factor and swaps the roles (ΔW = s·(b1@b2 + W@a1@a2));
            # it is told by a1's orientation (rank < K; a square a1 counts
            # as old, as in the reference) and normalized to the old form
            a1 = np.asarray(parts["glora_a1"], np.float32)
            if a1.shape[0] > a1.shape[1]:  # (K, r): new layout
                parts = dict(parts,
                             glora_a1=parts["glora_a2"],
                             glora_a2=parts["glora_a1"],
                             glora_b1=parts["glora_b2"],
                             glora_b2=parts["glora_b1"])
            b1 = np.asarray(parts["glora_b1"], np.float32)
            rank = b1.shape[0]
            alpha = float(np.asarray(parts.get("alpha", rank)))
            patch = LoRAPatch(
                up=t(parts["glora_b2"]), down=t(b1), mid=None, diff=None,
                scale=float(strength) * alpha / rank,
                a1=t(parts["glora_a1"]), a2=t(parts["glora_a2"]))
        elif "up" in parts and "down" in parts:
            up = np.asarray(parts["up"])
            down = np.asarray(parts["down"])
            rank = down.shape[0]
            alpha = float(np.asarray(parts.get("alpha", rank)))
            patch = LoRAPatch(
                up=t(up.reshape(up.shape[0], -1)),
                down=t(down.reshape(down.shape[0], -1)),
                mid=t(parts["mid"]) if "mid" in parts else None,
                diff=None, scale=float(strength) * alpha / rank)
        else:
            continue
        out[mk] = out.get(mk, ()) + (patch,)
    return out


# ---------------------------------------------------------------------------
# params-level attach / detach (the reference plugin's GGUFModelPatcher)
# ---------------------------------------------------------------------------

def attach_patches(params: dict, patches: dict[str, tuple[LoRAPatch, ...]]
                   ) -> dict:
    """Non-destructively wrap patched weights; packed weights stay packed.
    A weight that is already patched gains the new patches after its
    own."""
    out = dict(params)
    for mk, plist in patches.items():
        if mk not in out:
            log.warning("LoRA patch for missing weight %s", mk)
            continue
        base = out[mk]
        if isinstance(base, PatchedWeight):
            out[mk] = PatchedWeight(base.base, base.patches + tuple(plist))
        else:
            out[mk] = PatchedWeight(base, tuple(plist))
    return out


def detach_patches(params: dict) -> dict:
    """Drop all patches (the reference plugin's unpatch_model), in nested
    subtrees too: a depth-stacked group carries its patches one level down
    (the reference's ``detach_patches`` reads the top level only, and so
    leaves a stacked tree patched)."""
    return {k: (v.base if isinstance(v, PatchedWeight)
                else detach_patches(v) if isinstance(v, dict) else v)
            for k, v in params.items()}


def _device_of(params: dict):
    for v in params.values():
        v = v.base if isinstance(v, PatchedWeight) else v
        t = getattr(v, "qs", v)
        if isinstance(t, torch.Tensor):
            return t.device
    return torch.device("cpu")


def load_and_attach(params: dict, path: str, strength: float = 1.0,
                    dtype=torch.bfloat16) -> dict:
    """A LoRA safetensors file → patched params (factors on the params'
    device)."""
    groups = group_lora_keys(load_lora_safetensors(path))
    mapped = map_lora_to_model_keys(groups, params.keys())
    patches = build_patches(mapped, strength=strength, dtype=dtype,
                            device=_device_of(params))
    return attach_patches(params, patches)


def load_and_attach_te(params: dict, path: str, strength: float = 1.0,
                       dtype=torch.bfloat16,
                       prefixes: tuple[str, ...] = ("te", "te1")) -> dict:
    """Attach the TEXT-ENCODER slice of a LoRA file to encoder params.

    kohya files patch encoders under ``lora_te_…`` (SD1's one encoder),
    ``lora_te1_…``/``lora_te2_…`` (SDXL's CLIP-L/CLIP-G) or ``lora_te3_…``
    (T5) bases, with the underscore-mangled names of the encoder's params.
    The diffusion slice (``lora_unet_…``) is ignored here; ``prefixes``
    picks the slice this tree receives. Returns ``params`` itself when the
    file carries no such slice."""
    groups = group_lora_keys(load_lora_safetensors(path))
    sel = {}
    for base, parts in groups.items():
        for p in prefixes:
            pfx = f"lora_{p}_"
            if base.startswith(pfx):
                sel[base[len(pfx):]] = parts
                break
    if not sel:
        log.info("LoRA %s carries no lora_{%s}_ text-encoder keys", path,
                 "|".join(prefixes))
        return params
    mapped = map_lora_to_model_keys(sel, params.keys())
    patches = build_patches(mapped, strength=strength, dtype=dtype,
                            device=_device_of(params))
    return attach_patches(params, patches)
