"""Real-weight golden-image harness, on the card.

Given SD1.5 checkpoint paths (or ``"default"`` to fetch the default sources via
``weights/fetch.py``), it generates the reference README example — ``"a cute
girl."``, 512x512, 25 steps, CFG 7.5, rescale 0.7, seed 123456 — and

  1. writes the image and the final latent as fixtures on the first run;
  2. on later runs compares against the stored fixtures (latent MSE and mean
     |Δpixel|);
  3. with ``--audit`` also runs the same seed in fp32 and reports the bf16-vs-fp32
     latent MSE and image PSNR: the production dtype's quality audit.

The seed's initial noise is the TF-Philox stream of the JAX package and of the
reference, so fixtures made by either with the same seed are comparable. The
fixtures are ``.npy`` files (PIL is not needed), in their own directory, apart
from the JAX package's.

Usage:
    python -m minsdtf_tpu_torch.tools.golden --unet /path/unet.safetensors \
        --vae /path/vae.safetensors --text-encoder /path/te.safetensors \
        --bpe /path/bpe_simple_vocab_16e6.txt.gz [--fixtures fixtures/golden_torch] \
        [--device cuda]
    python -m minsdtf_tpu_torch.tools.golden --default   # fetch everything

Exits 0 on a match (or when it creates the fixtures), 1 on a mismatch, 2 when
skipped (offline or missing weights).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

PROMPT = "a cute girl."
STEPS = 25
SEED = 123456
SIZE = 512
# Gates: the latent MSE is the BASELINE.json threshold; pixels allow for small
# accumulation drift across library versions.
LATENT_MSE_GATE = 1e-2
PIXEL_MAD_GATE = 1.0
FIXTURES = os.path.join("fixtures", "golden_torch")


def _generate(pipe):
    encoded = pipe.encode_text(PROMPT)
    img, latent = pipe.generate_image(
        encoded, num_steps=STEPS, unconditional_guidance_scale=7.5,
        guidance_rescale=0.7, seed=SEED, return_latent=True,
    )
    return img[0], latent[0]


def run(unet, vae, text_encoder, bpe, fixtures_dir=FIXTURES, audit=False,
        compute_dtype=None, device=None) -> int:
    """Generate, then create or compare the fixtures in ``fixtures_dir``; the exit
    code (module docstring)."""
    from minsdtf_tpu_torch.pipeline import StableDiffusion
    from minsdtf_tpu_torch.weights import fetch

    paths = {}
    for kind, p in (("unet", unet), ("vae", vae), ("text_encoder", text_encoder), ("bpe", bpe)):
        try:
            resolved = fetch.resolve(p, kind)
        except OSError as e:  # no network: the download fails
            print(f"golden: SKIP — cannot resolve {kind} weights offline ({e})")
            return 2
        if resolved is None or not os.path.exists(str(resolved)):
            print(f"golden: SKIP — {kind} weights unavailable ({p})")
            return 2
        paths[kind] = resolved

    def pipeline(dtype):
        return StableDiffusion(
            img_height=SIZE, img_width=SIZE,
            unet_ckpt=paths["unet"], vae_ckpt=paths["vae"],
            text_encoder_ckpt=paths["text_encoder"], bpe_path=paths["bpe"],
            compute_dtype=dtype, device=device,
        )

    img, latent = _generate(pipeline(compute_dtype))

    os.makedirs(fixtures_dir, exist_ok=True)
    img_path = os.path.join(fixtures_dir, f"golden_{SEED}_image.npy")
    lat_path = os.path.join(fixtures_dir, f"golden_{SEED}_latent.npy")
    meta_path = os.path.join(fixtures_dir, f"golden_{SEED}.json")

    if not os.path.exists(lat_path):
        np.save(img_path, img)
        np.save(lat_path, latent)
        with open(meta_path, "w") as f:
            json.dump({"prompt": PROMPT, "steps": STEPS, "seed": SEED, "size": SIZE,
                       "unet": os.path.basename(str(unet))}, f, indent=2)
        print(f"golden: fixtures created in {fixtures_dir} — commit them and rerun to gate")
        rc = 0
    else:
        want_lat = np.load(lat_path)
        want_img = np.load(img_path)
        mse = float(np.mean(np.square(latent - want_lat)))
        mad = float(np.mean(np.abs(img.astype(np.int32) - want_img.astype(np.int32))))
        ok = mse < LATENT_MSE_GATE and mad < PIXEL_MAD_GATE
        print(f"golden: latent MSE {mse:.2e} (gate {LATENT_MSE_GATE}), "
              f"pixel MAD {mad:.3f} (gate {PIXEL_MAD_GATE}) -> {'OK' if ok else 'MISMATCH'}")
        rc = 0 if ok else 1

    if audit:
        import torch

        print("golden: fp32 audit pass (same seed)...")
        img32, lat32 = _generate(pipeline(torch.float32))
        mse = float(np.mean(np.square(latent - lat32)))
        err = img.astype(np.float64) - img32.astype(np.float64)
        psnr = 10 * np.log10(255.0**2 / max(1e-9, float(np.mean(np.square(err)))))
        print(f"golden audit: bf16-vs-fp32 latent MSE {mse:.3e}, image PSNR {psnr:.1f} dB")
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--unet")
    ap.add_argument("--vae")
    ap.add_argument("--text-encoder")
    ap.add_argument("--bpe")
    ap.add_argument("--default", action="store_true",
                    help="resolve all four from the default URLs")
    ap.add_argument("--fixtures", default=FIXTURES)
    ap.add_argument("--audit", action="store_true", help="also run the bf16-vs-fp32 audit")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.default:
        args.unet = args.vae = args.text_encoder = args.bpe = "default"
    if not all([args.unet, args.vae, args.text_encoder, args.bpe]):
        ap.error("pass --default or all of --unet/--vae/--text-encoder/--bpe")
    return run(args.unet, args.vae, args.text_encoder, args.bpe, args.fixtures,
               audit=args.audit, device=args.device)


if __name__ == "__main__":
    sys.exit(main())
