"""Shared helpers for the demo apps (Gradio and Streamlit are imported by the apps
themselves, at run time, and are not needed to import this module)."""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

OUTPUT_DIR = os.environ.get("MINSDTF_OUTPUT_DIR", "outputs")


def build_pipeline(img_height: int = 512, img_width: int = 512, device=None, **kw):
    """The port's pipeline on ``device`` (the card by default) from the checkpoint
    paths in MINSDTF_UNET / _TEXT_ENCODER / _VAE / _LORA / _CONTROLNET / _BPE,
    with random weights for a module whose path is unset."""
    from minsdtf_tpu_torch.pipeline import StableDiffusion

    return StableDiffusion(
        img_height=img_height,
        img_width=img_width,
        unet_ckpt=os.environ.get("MINSDTF_UNET"),
        text_encoder_ckpt=os.environ.get("MINSDTF_TEXT_ENCODER"),
        vae_ckpt=os.environ.get("MINSDTF_VAE"),
        lora_path=os.environ.get("MINSDTF_LORA"),
        controlnet_path=os.environ.get("MINSDTF_CONTROLNET"),
        bpe_path=os.environ.get("MINSDTF_BPE"),
        device=device,
        **kw,
    )


def save_outputs(images: np.ndarray, prompt: str, out_dir: Optional[str] = None):
    """Each image as PNG (``.npy`` where PIL is not installed) with the prompt in a
    ``.txt`` file beside it; returns the image paths."""
    from minsdtf_tpu_torch.tools.generate import save_image

    out_dir = out_dir or OUTPUT_DIR
    os.makedirs(out_dir, exist_ok=True)
    stamp = time.strftime("%Y%m%d-%H%M%S")
    paths = []
    for i, img in enumerate(images):
        path = save_image(img, os.path.join(out_dir, f"{stamp}-{i}.png"))
        with open(os.path.splitext(path)[0] + ".txt", "w") as f:
            f.write(prompt)
        paths.append(path)
    return paths
