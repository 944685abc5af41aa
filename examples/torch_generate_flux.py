"""Example: flux txt2img from GGUF checkpoints, on the PyTorch port.

    python examples/torch_generate_flux.py \
        --unet flux1-dev-Q4_K_S.gguf --t5 t5-v1_1-xxl-Q8_0.gguf \
        --clip-l clip_l.safetensors --vae ae.safetensors \
        --prompt "a cat in a spacesuit" --steps 20 --out cat.png

Runs on the CUDA card; ``--device cpu`` runs the plain PyTorch path. The
initial noise comes from ``torch.Generator(device).manual_seed(seed)``
(``FluxPipeline.generate``).
"""

import argparse
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--unet", required=True)
    ap.add_argument("--t5", required=True)
    ap.add_argument("--clip-l", required=True)
    ap.add_argument("--vae")
    ap.add_argument("--lora", action="append", default=[],
                    help="LoRA safetensors (repeatable); NAME:STRENGTH")
    ap.add_argument("--prompt", required=True)
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--height", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--guidance", type=float, default=3.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="out.png")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the card's kernels) or cpu")
    args = ap.parse_args(argv)

    from comfyui_gguf_tpu_torch.pipeline import FluxPipeline

    pipe = FluxPipeline.load(args.unet, args.t5, args.clip_l,
                             vae_path=args.vae, device=args.device)
    for spec in args.lora:
        path, _, strength = spec.partition(":")
        pipe.model.apply_lora(path, strength=float(strength or 1.0))

    img = pipe.generate(args.prompt, width=args.width, height=args.height,
                        steps=args.steps, guidance=args.guidance,
                        seed=args.seed)
    if img.ndim == 3 and img.shape[-1] == 3:
        try:
            from PIL import Image

            Image.fromarray((img * 255).astype(np.uint8)).save(args.out)
            print(f"wrote {args.out}")
        except ImportError:
            np.save(args.out + ".npy", img)
            print(f"PIL unavailable; wrote {args.out}.npy")
    else:
        np.save(args.out + ".latent.npy", img)
        print(f"no VAE attached; wrote latent {args.out}.latent.npy")


if __name__ == "__main__":
    sys.exit(main())
