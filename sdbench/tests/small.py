"""A small configuration for the CPU tests: SD1.5's structure at narrow widths
(the full CLIP text encoder, which the library builds at one size only)."""

from __future__ import annotations

import contextlib
import json
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[2]


def config(controlnet: bool = False) -> dict:
    name = "sd15-controlnet-canny" if controlnet else "sd15"
    cfg = json.loads((ROOT / "sdbench" / "configs" / f"{name}.json").read_text())
    cfg["unet"]["block_out_channels"] = [320, 64, 128, 128]
    cfg["vae"]["block_out_channels"] = [32, 32, 64, 64]
    if controlnet:
        cfg["controlnet"]["block_out_channels"] = [320, 64, 128, 128]
        cfg["controlnet"]["conditioning_embedding_out_channels"] = [4, 4, 12, 32]
    return cfg


@contextlib.contextmanager
def library_widths(cfg: dict):
    """The library's model classes built at ``cfg``'s widths while the block
    runs: its loader builds them with their defaults, SD1.5's published widths."""
    from minsdtf_tpu_torch.models import controlnet as controlnet_lib
    from minsdtf_tpu_torch.models import unet as unet_lib
    from minsdtf_tpu_torch.models import vae as vae_lib

    widths = tuple(cfg["unet"]["block_out_channels"])
    temb, context = 4 * widths[0], cfg["unet"]["cross_attention_dim"]
    dec = tuple(reversed(cfg["vae"]["block_out_channels"]))

    class UNet(unet_lib.UNet):
        def __init__(self):
            super().__init__(widths, temb, context)

    class ControlNet(controlnet_lib.ControlNet):
        def __init__(self):
            super().__init__(widths, temb, context)

    class VAEDecoder(vae_lib.VAEDecoder):
        def __init__(self):
            super().__init__(dec)

    with mock.patch.object(unet_lib, "UNet", UNet), mock.patch.object(controlnet_lib, "ControlNet", ControlNet), \
            mock.patch.object(vae_lib, "VAEDecoder", VAEDecoder):
        yield
