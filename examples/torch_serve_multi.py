"""Serve TWO GGUF diffusion models from one card under a device-memory
budget, on the PyTorch port.

The port's version of ComfyUI's model management (reference nodes.py:80-119
mmap/offload lifecycle): each model's packed params keep a durable host
copy; the LRU ResidencyManager places/evicts device copies under the
budget, and each engine's step reads its params through a provider
(pipeline.flux_engine(params_provider=...)), so a swap costs one
host->device copy and nothing else.

    python examples/torch_serve_multi.py \\
        --model-a flux1-dev-Q4_K_S.gguf --model-b flux1-schnell-Q4_0.gguf \\
        --t5 t5-v1_1-xxl-Q8_0.gguf --clip-l clip_l.gguf \\
        --prompt "a watercolor fox" --hbm-budget-gb 14

``--hbm-budget-gb`` is the budget of the card's device memory. Runs on the
CUDA card; ``--device cpu`` runs the plain PyTorch path. Request i's noise
comes from ``torch.Generator(device).manual_seed(i)``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _noise(i: int, shape: tuple, device) -> np.ndarray:
    """Request i's initial noise: float32 normal draws of
    ``torch.Generator(device).manual_seed(i)``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(i)
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32).cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-a", required=True)
    ap.add_argument("--model-b", required=True)
    ap.add_argument("--t5", required=True)
    ap.add_argument("--clip-l", required=True)
    ap.add_argument("--prompt", default="a watercolor fox")
    ap.add_argument("--hbm-budget-gb", type=float, default=14.0,
                    help="device-memory budget of the resident models (GB)")
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--t5-len", type=int, default=512)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the card's kernels) or cpu")
    args = ap.parse_args(argv)

    import torch

    from comfyui_gguf_tpu_torch import serving
    from comfyui_gguf_tpu_torch._device import resolve_device
    from comfyui_gguf_tpu_torch.lifecycle import free_tree
    from comfyui_gguf_tpu_torch.pipeline import FluxPipeline, flux_engine
    from comfyui_gguf_tpu_torch.sampling import flux_schedule

    dev = resolve_device(args.device)
    h_lat = w_lat = args.size // 8
    L_img = (h_lat // 2) * (w_lat // 2)

    srv = serving.ResidentModelServer(
        hbm_budget=int(args.hbm_budget_gb * 1e9), device=dev)

    pipes = {}
    for name, path in (("a", args.model_a), ("b", args.model_b)):
        pipe = FluxPipeline.load(path, args.t5, args.clip_l, device=dev)
        model = pipe.model.stack()
        # stacking COPIES the block leaves (the other keys are shared by
        # reference): free the unstacked block copies so only the
        # manager-controlled tree ever occupies device memory
        free_tree({k: v for k, v in pipe.model.params.items()
                   if k.startswith(("double_blocks.", "single_blocks."))})
        # register frees model.params' device storage too (free_source
        # default): the engine reads params only through the provider
        srv.register(
            name, model.params,
            lambda provider, m=model: flux_engine(
                m, h_lat, w_lat, args.t5_len, max_batch=2,
                params_provider=provider))
        pipes[name] = pipe

    enc = pipes["a"]  # the text encoders are shared
    if enc.t5.tokenizer is None or enc.clip_l.tokenizer is None:
        print("error: encoder lacks an embedded tokenizer — use GGUF "
              "encoders with tokenizer metadata", file=sys.stderr)
        return 1
    with torch.no_grad():
        ids, mask = enc.t5.tokenizer.encode_batch([args.prompt],
                                                  max_length=args.t5_len)
        txt = enc.t5.encode(torch.as_tensor(ids, dtype=torch.long,
                                            device=dev),
                            torch.as_tensor(mask, dtype=torch.int32,
                                            device=dev))
        cids, _ = enc.clip_l.tokenizer.encode_batch(
            [args.prompt],
            max_length=min(77, enc.clip_l.config.max_positions))
        pooled = enc.clip_l.encode(torch.as_tensor(
            cids, dtype=torch.long, device=dev))["pooled"]
    lat_c = pipes["a"].model.config.in_channels // 4
    cond = {"txt": txt[0].float().cpu().numpy(),
            "y": pooled[0].float().cpu().numpy(),
            "guidance": np.float32(3.5)}

    sigmas = flux_schedule(args.steps, L_img)
    reqs = {}
    for i, name in enumerate(("a", "b")):
        reqs[name] = srv.submit(name, _noise(i, (L_img, lat_c * 4), dev),
                                cond, sigmas)
    srv.run_until_drained(timeout_s=3600)
    for n, r in reqs.items():
        print(f"model {n}: latent {r.result.shape}, "
              f"latency {r.latency_s:.1f}s")
    print("residency:", srv.stats["models"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
