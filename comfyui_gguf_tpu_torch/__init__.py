"""comfyui-gguf-tpu, PyTorch/CUDA port for the NVIDIA H100.

A second package beside the JAX reference ``comfyui_gguf_tpu``, with the
same module layout. The main path is flux text-to-image: tokenizers → T5
and CLIP-L encode → GGUF file → planar weights (LoRA patches attached) →
w8a8 conversion → flux forward → sampler (Euler or any of the flow menu) →
VAE decode, served one request at a time or continuously batched
(``flux_engine``); SD3/SD3.5 (``SD3Pipeline``, ``sd3_engine``) and the
SD1/SDXL UNet (``SD1Pipeline``, ``SDXLPipeline``, ``unet_engine``),
AuraFlow (``AuraPipeline``, ``aura_engine``), Lumina Image 2.0
(``Lumina2Pipeline``, ``lumina2_engine``, with the llama-family text
encoder), Qwen-Image (``QwenImagePipeline``, ``qwen_image_engine``, with
the Qwen2.5-VL encoder and its vision tower), HiDream-I1
(``HiDreamPipeline``, ``hidream_engine``, the MoE DiT) and the video DiTs
Wan 2.1, Cosmos, HunyuanVideo and LTX-Video (``WanPipeline``,
``CosmosPipeline``, ``HyVidPipeline``, ``LTXVPipeline`` and their engines,
with the causal 3-D VAEs) run the same way, with
hand-written CUDA kernels (``csrc/``) for the fused quantized matmuls (with
the LoRA rank term in their epilogues), flash attention and int8 flash
attention. Entry points run on the card unless the caller asks for
the CPU, where each kernel's plain PyTorch version runs instead.
"""

__version__ = "0.1.0"

# public API, imported lazily so that metadata-only imports stay light
_PUBLIC = {
    "GGUFReader": ".gguf.reader",
    "GGUFWriter": ".gguf.writer",
    "gguf_sd_loader": ".loader",
    "to_torch_params": ".loader",
    "gguf_clip_loader": ".loader",
    "load_diffusion_model": ".pipeline",
    "load_text_encoder": ".pipeline",
    "load_text_encoders": ".pipeline",
    "load_vae": ".pipeline",
    "DiffusionModel": ".pipeline",
    "TextEncoder": ".pipeline",
    "FluxPipeline": ".pipeline",
    "SD3Pipeline": ".pipeline",
    "SD1Pipeline": ".pipeline",
    "SDXLPipeline": ".pipeline",
    "AuraPipeline": ".pipeline",
    "Lumina2Pipeline": ".pipeline",
    "CFGFlowPipeline": ".pipeline",
    "QwenImagePipeline": ".pipeline",
    "HiDreamPipeline": ".pipeline",
    "WanPipeline": ".pipeline",
    "CosmosPipeline": ".pipeline",
    "HyVidPipeline": ".pipeline",
    "LTXVPipeline": ".pipeline",
    "VideoFlowPipeline": ".pipeline",
    "qwen_vl_encode_with_image": ".pipeline",
    "QuantConfig": ".nn.layers",
    "quantized_matmul": ".ops.qmatmul",
    "i8_matmul": ".ops.i8mm",
    "dot_product_attention": ".nn.attention",
    "attention_i8": ".nn.attention",
    "i8_dot_product_attention": ".ops.i8attn",
    "PlanarQuant": ".quant.planar",
    "planarize": ".quant.planar",
    "params_from_numpy": ".interop",
    "EmbeddingSet": ".textual_inversion",
    "flux_engine": ".pipeline",
    "sd3_engine": ".pipeline",
    "unet_engine": ".pipeline",
    "aura_engine": ".pipeline",
    "lumina2_engine": ".pipeline",
    "qwen_image_engine": ".pipeline",
    "hidream_engine": ".pipeline",
    "wan_engine": ".pipeline",
    "cosmos_engine": ".pipeline",
    "hyvid_engine": ".pipeline",
    "ltxv_engine": ".pipeline",
    "make_flow_engine": ".pipeline",
    "ContinuousBatchEngine": ".serving",
    "EngineGroup": ".serving",
    "BucketRouter": ".serving",
    "GenRequest": ".serving",
    "ResidentModelServer": ".serving",
    "ResidencyManager": ".lifecycle",
    "save_params": ".checkpoint",
    "load_params": ".checkpoint",
    "LatentPreviewer": ".preview",
    "fit_latent_preview": ".preview",
    "previewer_for_vae": ".preview",
    "memory_report": ".observability",
    "enable_compile_cache": ".compile_cache",
    "ModelRegistry": ".registry",
    "ring_attention": ".parallel.ring",
    "make_mesh": ".parallel.mesh",
    "sample_flow": ".sampling",
    "run_sampler": ".sampling.kdiffusion",
    "make_schedule": ".sampling.kdiffusion",
}


def __getattr__(name):
    if name in _PUBLIC:
        import importlib

        mod = importlib.import_module(_PUBLIC[name], __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = list(_PUBLIC)
