"""CLI: headless generation on the card.

    python -m minsdtf_tpu_torch.tools.generate --prompt "a cat" --unet model.safetensors \
        --text-encoder te.safetensors --vae vae.safetensors --bpe merges.txt.gz \
        [--negative ...] [--steps 25] [--scale 7.5] [--rescale 0.7] [--seed 123] \
        [--size 512] [--batch 1] [--image ref.png --strength 0.8] [--mask m.png] \
        [--controlnet cn.pth --control-image canny.png] [--lora l.safetensors] \
        [--tcd] [--out out.png] [--device cuda]

Images are written as PNG where PIL is installed, else as ``.npy`` (uint8
(H, W, 3)) under the same name. ``--image``, ``--mask`` and ``--control-image``
are opened with PIL.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def save_image(img: np.ndarray, path: str) -> str:
    """``img`` as PNG at ``path`` where PIL is installed, else as ``.npy`` beside
    it; returns the path written."""
    try:
        from PIL import Image
    except ImportError:
        path = os.path.splitext(path)[0] + ".npy"
        np.save(path, img)
        return path
    Image.fromarray(img).save(path)
    return path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--prompt", required=True)
    p.add_argument("--negative")
    p.add_argument("--unet")
    p.add_argument("--vae")
    p.add_argument("--text-encoder", dest="text_encoder")
    p.add_argument("--bpe")
    p.add_argument("--controlnet")
    p.add_argument("--lora")
    p.add_argument("--embedding", help="textual-inversion file")
    p.add_argument("--steps", type=int, default=25)
    p.add_argument("--scale", type=float, default=7.5)
    p.add_argument("--rescale", type=float, default=0.7)
    p.add_argument("--seed", type=int)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--width", type=int)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--clip-skip", dest="clip_skip", type=int, default=-1)
    p.add_argument("--image", help="reference image for img2img")
    p.add_argument("--strength", type=float, default=0.8)
    p.add_argument("--mask", help="inpaint mask (white = regenerate)")
    p.add_argument("--mask-blur", dest="mask_blur", type=int, default=5)
    p.add_argument("--control-image", dest="control_image")
    p.add_argument("--tcd", action="store_true")
    p.add_argument("--out", default="out.png")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from minsdtf_tpu_torch.pipeline import StableDiffusion

    pipe = StableDiffusion(
        img_height=args.size,
        img_width=args.width or args.size,
        clip_skip=args.clip_skip,
        unet_ckpt=args.unet,
        text_encoder_ckpt=args.text_encoder,
        vae_ckpt=args.vae,
        lora_path=args.lora,
        controlnet_path=args.controlnet,
        active_tcd=args.tcd,
        bpe_path=args.bpe,
        device=args.device,
    )
    kw = dict(
        negative_prompt=args.negative,
        batch_size=args.batch,
        num_steps=args.steps,
        unconditional_guidance_scale=args.scale,
        guidance_rescale=args.rescale,
        seed=args.seed,
        embedding=args.embedding,
        control_net_image=args.control_image,
        callback=lambda i: print(f"step {i}/{args.steps}", end="\r"),
    )
    if args.mask:
        images = pipe.inpaint(args.prompt, reference_image=args.image,
                              reference_image_strength=args.strength,
                              inpaint_mask=args.mask, mask_blur_strength=args.mask_blur,
                              **kw)
    elif args.image:
        images = pipe.image_to_image(args.prompt, reference_image=args.image,
                                     reference_image_strength=args.strength, **kw)
    else:
        images = pipe.text_to_image(args.prompt, **kw)

    stem, ext = os.path.splitext(args.out)
    for i, img in enumerate(images):
        path = save_image(img, args.out if len(images) == 1 else f"{stem}-{i}{ext}")
        print(f"\nsaved {path}")


if __name__ == "__main__":
    main()
