"""Checkpoint pre-flight validator: diff a GGUF against the arch's
expected key/shape spec before any payload decode (CLI + library; PyTorch
port of comfyui_gguf_tpu/tools/validate_checkpoint.py, the same report).

A wrong key layout (converter drift, truncated files) would otherwise
surface minutes later, deep inside a forward. This tool reads tensor infos
only (names/shapes/qtypes — no payload), introspects the arch config from
the shapes (the port's ``Config.from_state_dict``), builds the full
expected key/shape set from the shape specs of ``models/testing.py``, and
reports:

* missing required keys / missing ``.bias`` keys (reported separately —
  several arches ship biasless variants)
* unexpected keys (harmless to load, but a converter-drift signal)
* shape mismatches (the certain-failure class)
* codebook-blocked tensors (IQ1/IQ2/IQ3 — ``quant.codecs.can_decode``)

Usage:
    python -m comfyui_gguf_tpu_torch.tools.validate_checkpoint model.gguf
    python -m comfyui_gguf_tpu_torch.tools.validate_checkpoint model.gguf --json

Exit status: 0 clean (or warnings only), 1 hard problems (mismatched
shapes / missing required keys / blocked tensors), 2 unsupported file.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from ..archs import IMG_ARCH_LIST, detect_arch
from ..gguf.constants import GGMLQuantizationType as Q
from ..gguf.reader import GGUFReader
from ..quant import codecs


@dataclasses.dataclass
class _ShapeRec:
    """Shape-only stand-in so Config.from_state_dict introspection works
    without any tensor data."""

    shape: tuple[int, ...]


@dataclasses.dataclass
class Report:
    path: str
    arch: str
    compat: str | None
    n_tensors: int
    spec: str  # "full" (key/shape diff ran) | "structural" (arch-only)
    missing: list
    missing_bias: list
    unexpected: list
    misshaped: list  # (key, got_shape, want_shape)
    blocked: list  # (key, qtype_name)

    @property
    def ok(self) -> bool:
        return not (self.missing or self.misshaped or self.blocked)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["ok"] = self.ok
        return d


def read_shape_infos(path: str,
                     handle_prefix: str = "model.diffusion_model."):
    """(sd_shapes {key: _ShapeRec}, qtypes {key: Q}, arch, compat) from
    tensor infos only — ``loader.gguf_sd_loader``'s prefix/arch handling
    without touching payloads."""
    reader = GGUFReader(path)
    names = {t.name for t in reader.tensors}
    has_prefix = any(n.startswith(handle_prefix) for n in names)

    sd_shapes, qtypes = {}, {}
    for t in reader.tensors:
        key = t.name
        if has_prefix:
            if not key.startswith(handle_prefix):
                continue
            key = key[len(handle_prefix):]
        shape = reader.get_orig_shape(t.name) or t.shape
        sd_shapes[key] = _ShapeRec(tuple(int(s) for s in shape))
        qtypes[key] = t.qtype

    compat = None
    arch = reader.get_str("general.architecture")
    if arch in (None, "pig", "cow"):
        compat = "sd.cpp" if arch is None else arch
        arch = detect_arch(set(sd_shapes)).arch
    return sd_shapes, qtypes, arch, compat


def _count_blocks(sd, prefix: str) -> int:
    n = 0
    while any(k.startswith(f"{prefix}.{n}.") for k in sd):
        n += 1
    return n


def expected_shapes(arch: str, sd) -> dict | None:
    """Full expected {key: shape} for ``arch``, dims introspected from
    the checkpoint's own shapes; None when only structural checks are
    available (sd1/sdxl — sgm-UNet layouts)."""
    from ..models import testing as T

    def flat(nonblock, groups):
        out = dict(nonblock)
        for out_key, (depth, suffixes) in groups.items():
            for i in range(depth):
                out.update({f"{out_key}.{i}.{s}": sh
                            for s, sh in suffixes.items()})
        return out

    if arch == "flux":
        from ..models.flux import FluxConfig

        cfg = FluxConfig.from_state_dict(sd)
        dims = T.TinyFluxDims(
            hidden=cfg.hidden, heads=cfg.n_heads, ctx=cfg.context_dim,
            vec=cfg.vec_dim, in_ch=cfg.in_channels,
            depth_double=cfg.depth_double, depth_single=cfg.depth_single,
            axes_dim=cfg.axes_dim)
        return flat(*T.flux_shape_spec(dims, guidance=cfg.guidance_embed))
    if arch == "sd3":
        from ..models.sd3 import SD3Config

        cfg = SD3Config.from_state_dict(sd)
        if cfg.dual_attn_layers:
            return None  # sd3.5-medium heterogeneity: structural only
        dims = T.TinySD3Dims(
            hidden=cfg.hidden, heads=cfg.n_heads, depth=cfg.depth,
            ctx_dim=cfg.context_dim, pooled=cfg.pooled_dim,
            in_ch=cfg.in_channels, pos_max=cfg.pos_embed_max,
            qk_norm=cfg.qk_norm)
        return T.sd3_shape_spec(dims)
    if arch == "qwen_image":
        from ..models.qwen_image import QwenImageConfig

        cfg = QwenImageConfig.from_state_dict(sd)
        dims = T.QwenImageDims(
            hidden=cfg.hidden, n_heads=cfg.n_heads, n_layers=cfg.n_layers,
            in_ch=cfg.in_channels, context_dim=cfg.context_dim)
        return flat(*T.qwen_image_shape_spec(dims))
    if arch == "wan":
        from ..models.wan import WanConfig

        cfg = WanConfig.from_state_dict(sd)
        dims = T.WanDims(dim=cfg.dim, ffn_dim=cfg.ffn_dim,
                         n_heads=cfg.n_heads, n_layers=cfg.n_layers,
                         in_ch=cfg.in_channels, text_dim=cfg.text_dim)
        return flat(*T.wan_shape_spec(dims))
    if arch == "hyvid":
        from ..models.hyvid import HyVidConfig

        cfg = HyVidConfig.from_state_dict(sd)
        dims = T.HyVidDims(
            hidden=cfg.hidden, n_heads=cfg.n_heads,
            depth_double=cfg.depth_double, depth_single=cfg.depth_single,
            refiner_depth=_count_blocks(
                sd, "txt_in.individual_token_refiner.blocks"),
            in_ch=cfg.in_channels, text_dim=cfg.text_dim)
        return flat(*T.hyvid_shape_spec(dims))
    if arch == "lumina2":
        from ..models.lumina2 import Lumina2Config

        cfg = Lumina2Config.from_state_dict(sd)
        dims = T.Lumina2Dims(
            dim=cfg.dim, n_heads=cfg.n_heads, n_layers=cfg.n_layers,
            n_refiner=_count_blocks(sd, "noise_refiner"),
            n_context_refiner=_count_blocks(sd, "context_refiner"),
            ffn=sd["layers.0.feed_forward.w1.weight"].shape[0],
            in_ch=cfg.in_channels, cap_dim=cfg.cap_dim)
        return flat(*T.lumina2_shape_spec(dims))
    if arch == "aura":
        from ..models.aura import AuraConfig

        cfg = AuraConfig.from_state_dict(sd)
        dims = T.AuraDims(
            hidden=cfg.hidden, depth_double=cfg.depth_double,
            depth_single=cfg.depth_single,
            mlp=sd["double_layers.0.mlpX.c_fc1.weight"].shape[0],
            in_ch=cfg.in_channels, cond_dim=cfg.cond_dim,
            n_register_tokens=cfg.n_register_tokens,
            max_tokens=sd["positional_encoding"].shape[1])
        return flat(*T.aura_shape_spec(dims))
    if arch == "ltxv":
        from ..models.ltxv import LTXVConfig

        cfg = LTXVConfig.from_state_dict(sd)
        dims = T.LTXVDims(dim=cfg.dim, n_layers=cfg.n_layers,
                          in_ch=cfg.in_channels,
                          caption_dim=cfg.caption_dim)
        return flat(*T.ltxv_shape_spec(dims))
    if arch == "cosmos":
        from ..models.cosmos import CosmosConfig

        cfg = CosmosConfig.from_state_dict(sd)
        dims = T.CosmosDims(dim=cfg.dim, n_heads=cfg.n_heads,
                            n_layers=cfg.n_layers, in_ch=cfg.in_channels,
                            text_dim=cfg.text_dim)
        return flat(*T.cosmos_shape_spec(dims))
    if arch == "hidream":
        from ..models.hidream import HiDreamConfig

        cfg = HiDreamConfig.from_state_dict(sd)
        shared = "double_stream_blocks.0.block.ff_i.shared_experts"
        C4 = sd["x_embedder.proj.weight"].shape[1]
        dims = T.TinyHiDreamDims(
            hidden=cfg.hidden, heads=cfg.n_heads,
            depth_double=cfg.depth_double,
            depth_single=cfg.depth_single,
            ffn=sd[f"{shared}.w1.weight"].shape[0],
            n_experts=cfg.n_experts, top_k=cfg.top_k,
            t5_dim=64, llama_dim=64,  # overridden from the file below
            pooled=sd["p_embedder.mlp.0.weight"].shape[1],
            in_ch=C4 // cfg.patch_size ** 2, patch=cfg.patch_size)
        want = flat(*T.hidream_shape_spec(dims))
        # caption projections vary in count and per-tap input width
        # (published layout: 0..N-2 llama taps, last t5) — take both
        # from the file itself, only the out-width is spec-checked
        want = {k: v for k, v in want.items()
                if not k.startswith("caption_projection.")}
        i = 0
        while f"caption_projection.{i}.linear.weight" in sd:
            k = f"caption_projection.{i}.linear.weight"
            want[k] = (cfg.hidden, sd[k].shape[1])
            i += 1
        # routed-expert and ff_t FFN widths may differ from the shared
        # expert's — introspect each family separately
        for probe, match in (
                ("double_stream_blocks.0.block.ff_i.experts.0.w1.weight",
                 ".ff_i.experts."),
                ("double_stream_blocks.0.block.ff_t.w1.weight",
                 ".ff_t.")):
            if probe not in sd:
                continue
            fw = sd[probe].shape[0]
            for k in want:
                if match in k and k.endswith((".w1.weight",
                                              ".w3.weight")):
                    want[k] = (fw, cfg.hidden)
                elif match in k and k.endswith(".w2.weight"):
                    want[k] = (cfg.hidden, fw)
        return want
    return None


def validate(path: str) -> Report:
    sd, qtypes, arch, compat = read_shape_infos(path)
    if arch not in IMG_ARCH_LIST:
        raise ValueError(f"not a supported diffusion-model GGUF "
                         f"(arch {arch!r}); text encoders load through "
                         "loader.gguf_clip_loader")

    blocked = sorted((k, Q(q).name) for k, q in qtypes.items()
                     if not codecs.can_decode(q))

    try:
        want = expected_shapes(arch, sd)
    except KeyError as e:
        # the anchor keys the config introspection needs are themselves
        # missing — report as the hard failure it is
        return Report(path=path, arch=arch, compat=compat,
                      n_tensors=len(sd), spec="full",
                      missing=[f"<config anchor> {e}"], missing_bias=[],
                      unexpected=[], misshaped=[], blocked=blocked)
    if want is None:
        return Report(path=path, arch=arch, compat=compat,
                      n_tensors=len(sd), spec="structural",
                      missing=[], missing_bias=[], unexpected=[],
                      misshaped=[], blocked=blocked)

    got_keys, want_keys = set(sd), set(want)
    missing_all = sorted(want_keys - got_keys)
    missing_bias = [k for k in missing_all
                    if k.endswith((".bias", ".scale_shift_table"))]
    missing = [k for k in missing_all if k not in missing_bias]
    unexpected = sorted(got_keys - want_keys)
    misshaped = sorted(
        (k, sd[k].shape, tuple(want[k]))
        for k in got_keys & want_keys
        if tuple(sd[k].shape) != tuple(want[k]))
    return Report(path=path, arch=arch, compat=compat, n_tensors=len(sd),
                  spec="full", missing=missing, missing_bias=missing_bias,
                  unexpected=unexpected, misshaped=misshaped,
                  blocked=blocked)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("path")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report")
    args = ap.parse_args(argv)

    try:
        rep = validate(args.path)
    except Exception as e:  # unreadable / unsupported
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.json:
        print(json.dumps(rep.to_json()))
        return 0 if rep.ok else 1

    print(f"{rep.path}: arch={rep.arch}"
          + (f" (compat {rep.compat})" if rep.compat else "")
          + f", {rep.n_tensors} tensors, spec={rep.spec}")
    for label, rows in (("MISSING", rep.missing),
                        ("missing bias (may be biasless variant)",
                         rep.missing_bias),
                        ("unexpected", rep.unexpected)):
        for k in rows:
            print(f"  {label}: {k}")
    for k, got, want in rep.misshaped:
        print(f"  SHAPE MISMATCH: {k}: file {got} vs expected {want}")
    for k, qn in rep.blocked:
        print(f"  BLOCKED ({qn}): {k} — needs llama.cpp codebook tables "
              "(quant.codecs.register_decoder)")
    if rep.ok:
        extras = len(rep.unexpected) + len(rep.missing_bias)
        print("OK" + (f" ({extras} warnings)" if extras else ""))
        return 0
    print(f"FAIL: {len(rep.missing)} missing, {len(rep.misshaped)} "
          f"misshaped, {len(rep.blocked)} blocked")
    return 1


if __name__ == "__main__":
    sys.exit(main())
