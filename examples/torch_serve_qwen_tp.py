"""Example: serve Qwen-Image-20B tensor-parallel over ranks, on the PyTorch
port.

At tp=2 the spec-driven sharder (parallel/tp_spec) splits every block
weight's EXISTING packed GGUF blocks per shard (see
tp_spec.i8_plan_report, or ``python -m comfyui_gguf_tpu_torch.tools.tp_plan``
for the bytes a rank holds), and the unmodified qwen_image forward serves
on every rank's shard, the collectives on torch.distributed.

    python examples/torch_serve_qwen_tp.py \
        --unet qwen-image-Q4_K_S.gguf --tp 2 [--i8] \
        --txt-states ctx.npy --prompt-tokens 512 --size 1024

Text conditioning: pass precomputed Qwen2.5-VL hidden states (--txt-
states, (L, 3584) .npy) or the engine runs on random states (--smoke) —
the text tower loads exactly as in examples/torch_generate_flux.py's T5
flow.

Each rank is one process (``parallel.launch.Ranks``): it loads the GGUF,
cuts its shard and serves; rank 0 writes the latent. The backend follows
``launch.backend_for``: NCCL when every rank has a card of its own, else
gloo, the ranks then sharing the card. Runs on the CUDA card; ``--device
cpu`` runs the ranks on the CPU. The initial noise comes from
``torch.Generator(device).manual_seed(seed)``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _noise(seed: int, shape: tuple, device) -> np.ndarray:
    """The initial noise: float32 normal draws of
    ``torch.Generator(device).manual_seed(seed)``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32).cpu().numpy()


def serve_rank(args: dict, txt: np.ndarray, x0: np.ndarray) -> np.ndarray:
    """One rank's job: load the GGUF, cut this rank's shard (converted to
    w8a8 with ``i8``), serve one request with the TP engine; rank 0 writes
    ``cwd``/``qwen_latent.npy``. → the latent tokens."""
    import torch
    import torch.distributed as dist

    from comfyui_gguf_tpu_torch import loader, pipeline
    from comfyui_gguf_tpu_torch.gguf.constants import (
        GGMLQuantizationType as Q)
    from comfyui_gguf_tpu_torch.models.qwen_image import QwenImageConfig
    from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
    from comfyui_gguf_tpu_torch.parallel import mesh as pmesh
    from comfyui_gguf_tpu_torch.parallel import tp_spec
    from comfyui_gguf_tpu_torch.sampling import linear_schedule

    dev = (torch.device("cuda", torch.cuda.current_device())
           if args["device"] == "cuda" else torch.device("cpu"))
    sd = loader.gguf_sd_loader(args["unet"])
    cfg = QwenImageConfig.from_state_dict(sd)
    # the sharder consumes the QTensors directly: quantized weights split
    # their existing packed blocks, no decode/re-encode; the tree is built
    # in host memory and only this rank's shard goes to the device
    params = tp_spec.shard_qwen_image_params(sd, cfg, args["tp"], Q.Q4_K)
    if args["i8"]:
        from comfyui_gguf_tpu_torch.quant.i8 import (convert_tree_i8,
                                                     is_modulation_key)

        params = convert_tree_i8(
            params, free_source=True,
            pred=lambda k, v: not is_modulation_key(k), host_stage=True)
    mesh = pmesh.make_mesh(tp=args["tp"])
    params = tp_spec.place_tp_params(params, mesh, ("transformer_blocks",),
                                     device=dev)
    model = pipeline.DiffusionModel(arch="qwen_image", params=params,
                                    config=cfg, qcfg=QuantConfig(),
                                    device=dev)
    h_tok = w_tok = args["size"] // 16  # 8x VAE, 2x2 patch
    eng = pipeline.qwen_image_engine(model, h_tok, w_tok, txt.shape[0],
                                     max_batch=2, mesh=mesh)
    req = eng.submit(x0, {"txt": txt}, linear_schedule(args["steps"]))
    eng.run_until_drained()
    if req.error is not None:
        raise RuntimeError(f"the request failed: {req.error}")
    lat = np.asarray(req.result)
    if dist.get_rank() == 0:
        print(f"latent tokens: {lat.shape}, finite={np.isfinite(lat).all()}",
              flush=True)
        np.save(os.path.join(args["cwd"], "qwen_latent.npy"), lat)
    return lat


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--unet", required=True)
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--i8", action="store_true",
                    help="requantize each shard to the w8a8 format "
                         "(per-shard scales)")
    ap.add_argument("--txt-states")
    ap.add_argument("--prompt-tokens", type=int, default=512)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="random text states (layout/perf check)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the card's kernels) or cpu")
    args = ap.parse_args(argv)

    from comfyui_gguf_tpu_torch import loader
    from comfyui_gguf_tpu_torch._device import resolve_device
    from comfyui_gguf_tpu_torch.models.qwen_image import QwenImageConfig
    from comfyui_gguf_tpu_torch.parallel.launch import Ranks

    dev = resolve_device(args.device)
    cfg = QwenImageConfig.from_state_dict(loader.gguf_sd_loader(args.unet))
    h_tok = w_tok = args.size // 16  # 8x VAE, 2x2 patch
    if args.txt_states:
        txt = np.load(args.txt_states).astype(np.float32)
    elif args.smoke:
        txt = np.random.default_rng(0).standard_normal(
            (args.prompt_tokens, cfg.context_dim)).astype(np.float32)
    else:
        print("error: need --txt-states or --smoke", file=sys.stderr)
        return 1
    x0 = _noise(args.seed, (h_tok * w_tok, cfg.in_channels), dev)
    # the ranks write where the caller runs
    job = dict(vars(args), device=dev.type, cwd=os.getcwd())
    with Ranks(args.tp, device=dev.type) as ranks:
        ranks.run(serve_rank, job, txt, x0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
