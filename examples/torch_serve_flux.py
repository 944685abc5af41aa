"""Example: continuous-batch serving of flux generation requests, on the
PyTorch port.

    python examples/torch_serve_flux.py --unet flux1-dev-Q4_K_S.gguf \
        --t5 t5-xxl-Q8_0.gguf --clip-l clip_l.safetensors \
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
    ap.add_argument("--t5", required=True)
    ap.add_argument("--clip-l", required=True)
    ap.add_argument("--prompts", required=True,
                    help="text file, one prompt per line")
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--height", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--guidance", type=float, default=3.5)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--sampler", default="euler",
                    choices=("euler", "dpmpp_2m"),
                    help="per-lane integrator (dpmpp_2m = 2nd-order "
                         "multistep at the same cost)")
    ap.add_argument("--vae", help="ae.safetensors for --preview-every")
    ap.add_argument("--preview-every", type=int, default=0,
                    help="write a latent->RGB preview .npy every N steps")
    ap.add_argument("--t5-len", type=int, default=512)
    ap.add_argument("--i8", action="store_true",
                    help="serve on the w8a8 path (int8 weights and "
                         "activations; adaLN projections stay planar)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the card's kernels) or cpu")
    args = ap.parse_args(argv)

    import torch

    from comfyui_gguf_tpu_torch.models import flux as flux_model
    from comfyui_gguf_tpu_torch.pipeline import FluxPipeline, flux_engine
    from comfyui_gguf_tpu_torch.sampling import flux_schedule

    pipe = FluxPipeline.load(args.unet, args.t5, args.clip_l,
                             device=args.device)
    dev = pipe.model.device
    if pipe.t5.tokenizer is None or pipe.clip_l.tokenizer is None:
        print("error: encoder lacks an embedded tokenizer (safetensors "
              "CLIP ships no vocab) — use GGUF encoders with tokenizer "
              "metadata for this example", file=sys.stderr)
        return 1
    model = pipe.model.stack()  # depth-stacked: one view a block
    if args.i8:
        model = model.requantize_i8()  # in place; planar tree is freed
    h_lat, w_lat = args.height // 8, args.width // 8
    lat_c = pipe.model.config.in_channels // 4
    L_img = (h_lat // 2) * (w_lat // 2)

    previewer = on_step = None
    if args.preview_every and not args.vae:
        print("warning: --preview-every needs --vae to calibrate the "
              "latent->RGB projection; previews disabled", file=sys.stderr)
    if args.preview_every and args.vae:
        # VAE-calibrated latent->RGB sketch, written every N engine ticks
        from comfyui_gguf_tpu_torch.pipeline import load_vae
        from comfyui_gguf_tpu_torch.preview import previewer_for_vae

        _, vp, vc = load_vae(args.vae, device=dev)
        previewer = previewer_for_vae(vp, vc)

        def on_step(requests):
            for r in requests:
                if r.step % args.preview_every:
                    continue
                lat = flux_model.unpatchify(
                    torch.as_tensor(r.latent)[None], h_lat, w_lat)
                rgb = previewer(lat[0])
                np.save(f"preview_{r.request_id:03d}_{r.step:03d}.npy", rgb)

    eng = flux_engine(model, h_lat, w_lat, args.t5_len,
                      max_batch=args.max_batch, sampler=args.sampler)
    eng.on_step = on_step
    eng.start()

    prompts = [ln.strip() for ln in open(args.prompts) if ln.strip()]
    sigmas = flux_schedule(args.steps, L_img)
    clip_len = min(77, pipe.clip_l.config.max_positions)
    reqs = []
    with torch.no_grad():
        for i, prompt in enumerate(prompts):
            ids, mask = pipe.t5.tokenizer.encode_batch(
                [prompt], max_length=args.t5_len)
            txt = pipe.t5.encode(
                torch.as_tensor(ids, dtype=torch.long, device=dev),
                torch.as_tensor(mask, dtype=torch.int32, device=dev))
            cids, _ = pipe.clip_l.tokenizer.encode_batch(
                [prompt], max_length=clip_len)
            pooled = pipe.clip_l.encode(torch.as_tensor(
                cids, dtype=torch.long, device=dev))["pooled"]
            reqs.append(eng.submit(
                _noise(i, (L_img, lat_c * 4), dev),
                {"txt": txt[0].float().cpu().numpy(),
                 "y": pooled[0].float().cpu().numpy(),
                 "guidance": np.float32(args.guidance)},
                sigmas))

    for i, r in enumerate(reqs):
        r.done_event.wait()
        lat = flux_model.unpatchify(torch.from_numpy(r.result)[None], h_lat,
                                    w_lat)
        np.save(f"out_{i:03d}.latent.npy", lat[0].numpy())
        print(f"request {i} done")
    eng.stop()
    print(eng.stats.snapshot())


if __name__ == "__main__":
    sys.exit(main())
