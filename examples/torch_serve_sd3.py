"""Example: continuous-batch serving of SD3/SD3.5 generation requests, on
the PyTorch port.

    python examples/torch_serve_sd3.py --unet sd3.5_large-Q4_K_S.gguf \
        --clip-l clip_l.gguf --clip-g clip_g.gguf [--t5 t5-xxl-Q8_0.gguf] \
        --prompts prompts.txt --width 1024 --height 1024 --max-batch 4

Runs on the CUDA card; ``--device cpu`` runs the plain PyTorch path.
Request i's noise comes from ``torch.Generator(device).manual_seed(i)``.
"""

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
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--unet", required=True)
    ap.add_argument("--clip-l", required=True)
    ap.add_argument("--clip-g", required=True)
    ap.add_argument("--t5", default=None)
    ap.add_argument("--prompts", required=True,
                    help="text file, one prompt per line")
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--height", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=28)
    ap.add_argument("--shift", type=float, default=3.0)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the card's kernels) or cpu")
    args = ap.parse_args(argv)

    import torch

    from comfyui_gguf_tpu_torch.pipeline import SD3Pipeline, sd3_engine
    from comfyui_gguf_tpu_torch.sampling import linear_schedule, shift_sigmas

    pipe = SD3Pipeline.load(args.unet, args.clip_l, args.clip_g,
                            t5_path=args.t5, device=args.device)
    dev = pipe.model.device
    model = pipe.model.stack()  # depth-stacked: one view a block
    h_lat, w_lat = args.height // 8, args.width // 8
    in_ch = model.config.in_channels

    eng = sd3_engine(model, max_batch=args.max_batch)
    eng.start()

    prompts = [ln.strip() for ln in open(args.prompts) if ln.strip()]
    sigmas = shift_sigmas(linear_schedule(args.steps), args.shift)
    reqs = []
    for i, prompt in enumerate(prompts):
        def ids(enc):
            L = getattr(enc.config, "max_positions", None)
            out, _ = enc.tokenizer.encode_batch(
                [prompt], max_length=min(77, L) if L else 77)
            return torch.as_tensor(out, dtype=torch.long, device=dev)

        with torch.no_grad():
            ctx, pooled = pipe._condition(
                ids(pipe.clip_l), ids(pipe.clip_g),
                ids(pipe.t5) if pipe.t5 is not None else None)
        reqs.append(eng.submit(
            _noise(i, (h_lat, w_lat, in_ch), dev),
            {"ctx": ctx[0].float().cpu().numpy(),
             "pooled": pooled[0].float().cpu().numpy()},
            sigmas))

    for i, r in enumerate(reqs):
        r.done_event.wait()
        np.save(f"out_{i:03d}.latent.npy", r.result)
        print(f"request {i} done")
    eng.stop()
    print(eng.stats.snapshot())


if __name__ == "__main__":
    sys.exit(main())
