"""Model-architecture registry: detection fingerprints + conversion policy.

Single source of truth shared by the loader's compat mode (role of reference
loader.py:74-94 importing tools/convert.py:163-170) and the converter
(tools/convert.py). Each entry records the key-set fingerprints that identify
an architecture in a safetensors state dict, plus the per-arch quantization
policy the reference keeps split between tools/convert.py:26-149 (hiprec /
ignore / banned / shape_fix / nd-tensor handling) and the C++ quantizer patch
(tools/lcpp.patch:327-425 exclusion lists).
"""

from __future__ import annotations

import dataclasses

# arch allowlists (reference loader.py:12-14)
IMG_ARCH_LIST = {"flux", "sd1", "sdxl", "sd3", "aura", "hidream", "cosmos",
                 "ltxv", "hyvid", "wan", "lumina2", "qwen_image"}
TXT_ARCH_LIST = {"t5", "t5encoder", "llama", "qwen2vl", "qwen3", "qwen3vl"}
VIS_TYPE_LIST = {"clip-vision", "mmproj"}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """Detection + conversion policy for one model family."""

    arch: str
    # each tuple is a key-set fingerprint; any full match identifies the arch
    keys_detect: tuple[tuple[str, ...], ...]
    # presence of any of these marks the dict as a rejected variant
    # (diffusers-format duplicates, reference tools/convert.py:31,40,49)
    keys_banned: tuple[str, ...] = ()
    # substrings forcing fp32 storage (nn.Parameter tensors that can't load
    # from bf16, reference tools/convert.py keys_hiprec)
    keys_hiprec: tuple[str, ...] = ()
    # substrings of keys to drop entirely
    keys_ignore: tuple[str, ...] = ()
    # rearrange 2-D tensors whose last dim % 256 != 0 into (N/256, 256) with
    # orig-shape metadata (SD1/SDXL, reference tools/convert.py:279-295)
    shape_fix: bool = False
    # arch emits >4-D tensors needing the sidecar flow (HyVid/Wan conv3d,
    # reference tools/convert.py:84-91 + tools/fix_5d_tensors.py)
    has_nd_tensors: bool = False
    # substrings of tensors that must never be quantized (embedders /
    # modulation / final layers, reference tools/lcpp.patch:327-425)
    keys_noquant: tuple[str, ...] = ()
    # exact-match tensor names that must never be quantized
    keys_noquant_exact: tuple[str, ...] = ()


ARCH_SPECS: tuple[ArchSpec, ...] = (
    # qwen_image MUST precede flux and sd3: its state dict contains
    # `attn.norm_added_k` and `attn.add_q_proj` keys that those specs use
    # as BANNED diffusers-variant fingerprints — ordering makes the
    # joint-stream MMDiT match here first. (The reference has no
    # qwen_image conversion template at all — tools/convert.py:26-149 —
    # its loader only accepts pre-converted GGUFs; this entry closes
    # that gap natively.)
    ArchSpec(
        arch="qwen_image",
        keys_detect=(
            ("transformer_blocks.0.img_mod.1.weight",
             "transformer_blocks.0.attn.add_q_proj.weight",
             "transformer_blocks.0.img_mlp.net.0.proj.weight"),
        ),
        keys_noquant=("img_in.", "txt_in.", "txt_norm.",
                      "time_text_embed.", "norm_out.", "proj_out."),
    ),
    ArchSpec(
        arch="flux",
        keys_detect=(
            ("transformer_blocks.0.attn.norm_added_k.weight",),
            ("double_blocks.0.img_attn.proj.weight",),
        ),
        keys_banned=("transformer_blocks.0.attn.norm_added_k.weight",),
        keys_noquant=("txt_in.", "img_in.", "time_in.", "vector_in.",
                      "guidance_in.", "final_layer."),
    ),
    ArchSpec(
        arch="sd3",
        keys_detect=(
            ("transformer_blocks.0.attn.add_q_proj.weight",),
            ("joint_blocks.0.x_block.attn.qkv.weight",),
        ),
        keys_banned=("transformer_blocks.0.attn.add_q_proj.weight",),
        keys_noquant=("final_layer.", "time_text_embed.", "context_embedder.",
                      "t_embedder.", "y_embedder.", "x_embedder."),
        keys_noquant_exact=("proj_out.weight", "pos_embed"),
    ),
    ArchSpec(
        arch="aura",
        keys_detect=(
            ("double_layers.3.modX.1.weight",),
            ("joint_transformer_blocks.3.ff_context.out_projection.weight",),
        ),
        keys_banned=(
            "joint_transformer_blocks.3.ff_context.out_projection.weight",),
        keys_hiprec=("positional_encoding", "register_tokens"),
        keys_noquant=("t_embedder.", "init_x_linear."),
        keys_noquant_exact=("modF.1.weight", "cond_seq_linear.weight",
                            "final_linear.weight", "positional_encoding",
                            "register_tokens"),
    ),
    ArchSpec(
        arch="hidream",
        keys_detect=(
            ("caption_projection.0.linear.weight",
             "double_stream_blocks.0.block.ff_i.shared_experts.w3.weight"),
        ),
        keys_hiprec=(".ff_i.gate.weight", "img_emb.emb_pos"),
        keys_noquant=("p_embedder.", "t_embedder.", "x_embedder.",
                      "final_layer.", ".ff_i.gate.weight",
                      "caption_projection."),
    ),
    ArchSpec(
        arch="cosmos",
        keys_detect=(
            ("blocks.0.mlp.layer1.weight",
             "blocks.0.adaln_modulation_cross_attn.1.weight"),
        ),
        keys_hiprec=("pos_embedder",),
        keys_ignore=("_extra_state", "accum_"),
        keys_noquant=("p_embedder.", "t_embedder.", "t_embedding_norm.",
                      "x_embedder.", "pos_embedder.", "final_layer."),
    ),
    ArchSpec(
        arch="ltxv",
        keys_detect=(
            ("adaln_single.emb.timestep_embedder.linear_2.weight",
             "transformer_blocks.27.scale_shift_table",
             "caption_projection.linear_2.weight"),
        ),
        keys_hiprec=("scale_shift_table",),
        keys_noquant=("adaln_single.", "caption_projection.",
                      "patchify_proj.", "proj_out.", "scale_shift_table"),
    ),
    ArchSpec(
        arch="hyvid",
        keys_detect=(
            ("double_blocks.0.img_attn_proj.weight",
             "txt_in.individual_token_refiner.blocks.1.self_attn_qkv.weight"),
        ),
        has_nd_tensors=True,
        keys_noquant=("txt_in.", "img_in.", "time_in.", "vector_in.",
                      "guidance_in.", "final_layer."),
    ),
    ArchSpec(
        arch="wan",
        keys_detect=(
            ("blocks.0.self_attn.norm_q.weight", "text_embedding.2.weight",
             "head.modulation"),
        ),
        keys_hiprec=(".modulation",),
        has_nd_tensors=True,
        keys_noquant=("modulation.", "patch_embedding.", "text_embedding.",
                      "time_projection.", "time_embedding.", "img_emb.",
                      "head."),
    ),
    ArchSpec(
        arch="sdxl",
        keys_detect=(
            ("down_blocks.0.downsamplers.0.conv.weight",
             "add_embedding.linear_1.weight"),
            ("input_blocks.3.0.op.weight", "input_blocks.6.0.op.weight",
             "output_blocks.2.2.conv.weight", "output_blocks.5.2.conv.weight"),
            ("label_emb.0.0.weight",),
        ),
        shape_fix=True,
        keys_noquant=("class_embedding.", "time_embedding.", "add_embedding.",
                      "time_embed.", "label_emb.", "conv_in.", "conv_out."),
        keys_noquant_exact=("input_blocks.0.0.weight", "out.2.weight"),
    ),
    ArchSpec(
        arch="sd1",
        keys_detect=(
            ("down_blocks.0.downsamplers.0.conv.weight",),
            ("input_blocks.3.0.op.weight", "input_blocks.6.0.op.weight",
             "input_blocks.9.0.op.weight", "output_blocks.2.1.conv.weight",
             "output_blocks.5.2.conv.weight", "output_blocks.8.2.conv.weight"),
        ),
        shape_fix=True,
        keys_noquant=("class_embedding.", "time_embedding.", "add_embedding.",
                      "time_embed.", "label_emb.", "conv_in.", "conv_out."),
        keys_noquant_exact=("input_blocks.0.0.weight", "out.2.weight"),
    ),
    ArchSpec(
        arch="lumina2",
        keys_detect=(
            ("cap_embedder.1.weight", "context_refiner.0.attention.qkv.weight"),
        ),
        keys_noquant=("t_embedder.", "x_embedder.", "final_layer.",
                      "cap_embedder.", "context_refiner.", "noise_refiner."),
    ),
)


class UnknownArchitectureError(ValueError):
    pass


class BannedArchitectureError(ValueError):
    pass


def detect_arch(keys) -> ArchSpec:
    """Identify the architecture of a state dict by key fingerprints.

    Role of reference tools/convert.py:152-170 (also used at inference time
    for sd.cpp/"pig"/"cow" compat files, reference loader.py:82).
    """
    keys = set(keys)
    for spec in ARCH_SPECS:
        for match_list in spec.keys_detect:
            if all(k in keys for k in match_list):
                if any(k in keys for k in spec.keys_banned):
                    raise BannedArchitectureError(
                        f"{spec.arch}: state dict is a rejected variant "
                        "(e.g. diffusers-format keys)"
                    )
                return spec
    raise UnknownArchitectureError("Unknown model architecture!")


def get_arch_spec(arch: str) -> ArchSpec | None:
    for spec in ARCH_SPECS:
        if spec.arch == arch:
            return spec
    return None
