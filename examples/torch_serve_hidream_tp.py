"""Example: serve HiDream-I1 (17B MoE) tensor-parallel over ranks, on the
PyTorch port.

At tp=2 the spec-driven sharder (parallel/tp_spec.hidream_rules) splits
every block weight's EXISTING packed GGUF blocks per shard — per-expert
MoE SwiGLUs included — and with ``--i8`` the whole tree converts to the
w8a8 format shard by shard (tp_spec.i8_plan_report / ``python -m
comfyui_gguf_tpu_torch.tools.tp_plan --arch hidream`` give the bytes a
rank holds); the unmodified hidream forward serves on every rank's shard,
the collectives on torch.distributed.

    python examples/torch_serve_hidream_tp.py \
        --unet hidream-i1-Q4_K_S.gguf --tp 2 [--i8] --smoke \
        --size 1024 --steps 16

Text conditioning: HiDream takes quad-encoder states (t5 + llama taps +
pooled clip); pass precomputed .npy states (--t5-states/--llama-states/
--pooled) or run --smoke on random states (layout/perf check).

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

BLOCK_KEYS = ("double_stream_blocks", "single_stream_blocks")


def _noise(seed: int, shape: tuple, device) -> np.ndarray:
    """The initial noise: float32 normal draws of
    ``torch.Generator(device).manual_seed(seed)``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32).cpu().numpy()


def serve_rank(args: dict, cond: dict, x0: np.ndarray):
    """One rank's job: load the GGUF, cut this rank's shard (converted to
    w8a8 with ``i8``), serve one request with the TP engine; rank 0 writes
    ``cwd``/``hidream_latent.npy``. → (the latent, or None, and the
    request's error as text, or None)."""
    import torch
    import torch.distributed as dist

    from comfyui_gguf_tpu_torch import loader, pipeline
    from comfyui_gguf_tpu_torch.gguf.constants import (
        GGMLQuantizationType as Q)
    from comfyui_gguf_tpu_torch.models.hidream import HiDreamConfig
    from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
    from comfyui_gguf_tpu_torch.parallel import mesh as pmesh
    from comfyui_gguf_tpu_torch.parallel import tp_spec
    from comfyui_gguf_tpu_torch.sampling import linear_schedule

    dev = (torch.device("cuda", torch.cuda.current_device())
           if args["device"] == "cuda" else torch.device("cpu"))
    sd = loader.gguf_sd_loader(args["unet"])
    cfg = HiDreamConfig.from_state_dict(sd)
    # built in host memory; only this rank's shard goes to the device
    params = tp_spec.shard_hidream_params(sd, cfg, args["tp"], Q.Q4_K)
    if args["i8"]:
        from comfyui_gguf_tpu_torch.quant.i8 import (convert_tree_i8,
                                                     is_modulation_key)

        params = convert_tree_i8(
            params, free_source=True,
            pred=lambda k, v: not is_modulation_key(k), host_stage=True)
    mesh = pmesh.make_mesh(tp=args["tp"])
    params = tp_spec.place_tp_params(params, mesh, BLOCK_KEYS, device=dev)
    model = pipeline.DiffusionModel(arch="hidream", params=params,
                                    config=cfg, qcfg=QuantConfig(),
                                    device=dev)
    eng = pipeline.hidream_engine(model, max_batch=2, mesh=mesh)
    req = eng.submit(x0, cond, linear_schedule(args["steps"]))
    eng.run_until_drained()
    if req.error is not None:
        return None, str(req.error)
    out = np.asarray(req.result)
    if dist.get_rank() == 0:
        print(f"latent: {out.shape}, finite={np.isfinite(out).all()}",
              flush=True)
        np.save(os.path.join(args["cwd"], "hidream_latent.npy"), out)
    return out, None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--unet", required=True)
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--i8", action="store_true",
                    help="requantize each shard to the w8a8 format "
                         "(per-shard scales); at tp>=2 the FULL tree "
                         "converts")
    ap.add_argument("--t5-states")
    ap.add_argument("--llama-states")
    ap.add_argument("--pooled")
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="random encoder states (layout/perf check)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the card's kernels) or cpu")
    args = ap.parse_args(argv)

    from comfyui_gguf_tpu_torch import loader
    from comfyui_gguf_tpu_torch._device import resolve_device
    from comfyui_gguf_tpu_torch.models.hidream import HiDreamConfig
    from comfyui_gguf_tpu_torch.parallel.launch import Ranks

    dev = resolve_device(args.device)
    sd = loader.gguf_sd_loader(args.unet)
    cfg = HiDreamConfig.from_state_dict(sd)
    lat = args.size // 8  # 8x VAE; the model patchifies 2x2 internally
    rng = np.random.default_rng(args.seed)

    def states(path, shape):
        if path:
            return np.load(path).astype(np.float32)
        if args.smoke:
            return rng.standard_normal(shape).astype(np.float32)
        print("error: need encoder-state .npys or --smoke",
              file=sys.stderr)
        raise SystemExit(1)

    # published HiDream-I1 conditioning widths (t5-xxl 4096 / llama 4096 /
    # pooled 2048); smoke shapes follow the checkpoint's own
    # caption-projection input dims — projections 0..N-2 take llama taps,
    # the LAST takes t5 (models/hidream.py _prelude ordering)
    n_proj = 0
    while f"caption_projection.{n_proj}.linear.weight" in sd:
        n_proj += 1
    t5_dim = sd[f"caption_projection.{n_proj - 1}.linear.weight"].shape[1]
    ll_dim = sd["caption_projection.0.linear.weight"].shape[1]
    pooled_dim = sd["p_embedder.mlp.0.weight"].shape[1]
    cond = {"t5": states(args.t5_states, (128, t5_dim)),
            "llama": states(args.llama_states, (128, ll_dim)),
            "pooled": states(args.pooled, (pooled_dim,))}
    del sd

    x0 = _noise(args.seed, (lat, lat, cfg.in_channels), dev)
    # the ranks write where the caller runs
    job = dict(vars(args), device=dev.type, cwd=os.getcwd())
    with Ranks(args.tp, device=dev.type) as ranks:
        outs = ranks.run(serve_rank, job, cond, x0)
    if outs[0][1] is not None:
        print(f"error: {outs[0][1]}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
