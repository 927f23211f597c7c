"""Stable Diffusion 1.5, with or without the canny ControlNet: the CLIP text
encoder, the UNet, the VAE decoder and the ControlNet of ``sdbench/reference/``,
their work as the benchmark counts it, and the port's ``StableDiffusion`` as the
system under test."""

from __future__ import annotations

import json
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sdbench import flops
from sdbench.reference import philox
from sdbench.reference.models import build
from sdbench.reference.pipeline import Reference
from sdbench.sut import DTYPES

KERNEL_MIN_TOKENS = 512  # self-attentions shorter than this run as plain products
CHUNK_TOKENS = 75  # a prompt's tokens in one CLIP chunk of 77
_COUNTS: Dict[tuple, int] = {}


def kinds(cfg: dict) -> List[str]:
    return ["text_encoder", "unet", "vae"] + (["controlnet"] if "controlnet" in cfg else [])


# ---- the work of a request ----------------------------------------------------------


def model_flops(cfg: dict, kind: str, batch: int, height: int, width: int, ctx_tokens: int = 77) -> int:
    """FLOPs of one call of the ``kind`` model at ``batch`` and the image size,
    with ``ctx_tokens`` of text context (the hint branch of a ControlNet is
    counted apart, as ``"hint"``); counted once a shape."""
    key = (json.dumps(cfg, sort_keys=True), kind, batch, height, width, ctx_tokens)
    if key not in _COUNTS:
        _COUNTS[key] = _model_flops(cfg, kind, batch, height, width, ctx_tokens)
    return _COUNTS[key]


def _model_flops(cfg: dict, kind: str, batch: int, height: int, width: int, ctx_tokens: int) -> int:
    h8, w8 = height // 8, width // 8
    meta = torch.device("meta")
    with torch.no_grad():
        if kind == "text_encoder":
            m = build(kind, cfg)
            return flops.count(lambda: m(torch.zeros(batch, 77, dtype=torch.long, device=meta)))
        if kind == "vae":
            m = build(kind, cfg)
            return flops.count(lambda: m(torch.zeros(batch, 4, h8, w8, device=meta)))
        if kind == "hint":
            m = build("controlnet", cfg)
            return flops.count(lambda: m.hint(torch.zeros(batch, 3, height, width, device=meta)))
        ctx = torch.zeros(batch, ctx_tokens, cfg[kind]["cross_attention_dim"], device=meta)
        x = torch.zeros(batch, 4, h8, w8, device=meta)
        t = torch.zeros(batch, device=meta)
        m = build(kind, cfg)
        if kind == "unet":
            return flops.count(lambda: m(x, t, ctx))
        hint = torch.zeros(batch, cfg["controlnet"]["block_out_channels"][0], h8, w8, device=meta)
        return flops.count(lambda: m(x, t, ctx, hint))


def _settings(mix: dict, req) -> Tuple[int, bool, int, int]:
    """(steps, guided, batch, prompt chunks) of request ``req`` of ``mix``, or of
    a one-image request at the mix's settings where ``req`` is None."""
    if req is None:
        return mix["steps"], mix["guidance"] > 0, 1, 1
    return req.steps, req.guidance > 0, req.batch, max(1, math.ceil(req.tokens / CHUNK_TOKENS))


def request_flops(cfg: dict, mix: dict, req=None) -> int:
    """FLOPs of one request of ``mix`` (all its images): the prompt's encode,
    each step's UNet (and ControlNet) on the guided pair (or the prompt alone
    without guidance), the hint once an image, the decode of each image."""
    h, w = mix["height"], mix["width"]
    steps, guided, batch, chunks = _settings(mix, req)
    pair, ctx = 2 if guided else 1, 77 * chunks
    per_image = model_flops(cfg, "vae", 1, h, w) + steps * model_flops(cfg, "unet", pair, h, w, ctx)
    if mix.get("control"):
        per_image += model_flops(cfg, "hint", 1, h, w) + steps * model_flops(cfg, "controlnet", pair, h, w, ctx)
    return model_flops(cfg, "text_encoder", chunks, h, w) + batch * per_image


def long_attentions(cfg: dict, mix: dict, req=None) -> List[Tuple[int, Tuple[int, int, int, int]]]:
    """``[(calls, (B, S, H, D))]`` of the self-attentions of at least
    ``KERNEL_MIN_TOKENS`` tokens in one request of ``mix`` (a one-image request
    at the mix's settings where ``req`` is None): the UNet's (and the
    ControlNet's) at each level with a transformer, on the guided pair every
    step, and the VAE decoder's single-head one."""
    h8, w8 = mix["height"] // 8, mix["width"] // 8
    steps, guided, batch, _ = _settings(mix, req)
    rows = batch * (2 if guided else 1)
    out = []
    models = [("unet", 1)] + ([("controlnet", 0)] if mix.get("control") else [])
    for kind, up in models:
        c = cfg[kind]
        widths, heads, layers = c["block_out_channels"], c["attention_head_dim"], c["layers_per_block"]
        for level, (width, block) in enumerate(zip(widths, c["down_block_types"])):
            if block != "CrossAttnDownBlock2D":
                continue
            tokens = (h8 >> level) * (w8 >> level)
            per_call = layers + up * (layers + 1)
            out.append((steps * per_call, (rows, tokens, heads, width // heads)))
        tokens = (h8 >> (len(widths) - 1)) * (w8 >> (len(widths) - 1))
        out.append((steps, (rows, tokens, heads, widths[-1] // heads)))
    out.append((1, (batch, h8 * w8, 1, cfg["vae"]["block_out_channels"][-1])))
    return [(n, shape) for n, shape in out if shape[1] >= KERNEL_MIN_TOKENS]


# ---- the reference in the program's place (the control) ---------------------------


class ReferencePipe:
    """The reference in the program's place: the library's entry points that
    the harness (``text_to_image``) and the serving worker (``_encode_text_dev``,
    ``encode_text``, ``generate_image``) call, with the library's meaning of
    their arguments."""

    def __init__(self, ref, mix: dict, device):
        self.ref, self.mix = ref, mix
        self.img_height, self.img_width = mix["height"], mix["width"]
        self.device = torch.device(device)
        self.bpe_path = "reference"
        self.sampler = mix.get("scheduler", "ddim")

    def _encode_text_dev(self, prompt: str) -> torch.Tensor:
        return self.ref.context(prompt)

    def encode_text(self, prompt: str) -> np.ndarray:
        return self.ref.context(prompt).cpu().numpy()

    def text_to_image(self, prompt, batch_size=1, num_steps=50, unconditional_guidance_scale=7.5,
                      guidance_rescale=0.7, seed=None, control_net_image=None):
        return self.ref.text_to_image(prompt, seed, self.img_height, self.img_width, num_steps,
                                      unconditional_guidance_scale, guidance_rescale, control_net_image,
                                      batch_size, self.sampler)

    def generate_image(self, encoded_text, negative_prompt=None, batch_size=1, num_steps=50,
                       unconditional_guidance_scale=7.5, diffusion_noise=None, seed=None, guidance_rescale=0.0,
                       _defer_fetch=False):
        if negative_prompt:
            raise ValueError("the control takes no negative prompt")
        context = torch.as_tensor(encoded_text, dtype=torch.float32).to(self.device)
        context = context[None] if context.dim() == 2 else context
        noise = (np.asarray(diffusion_noise, np.float32) if diffusion_noise is not None else
                 philox.stateless_normal((batch_size, self.img_height // 8, self.img_width // 8, 4), seed))
        return self.ref.generate(context, noise, num_steps, unconditional_guidance_scale, guidance_rescale,
                                 sampler=self.sampler, step_seed=seed)


# ---- the system under test ----------------------------------------------------------


def build_pipeline(cfg: dict, weights: Dict[str, Dict[str, torch.Tensor]], mix: dict, device,
                   merges_path: str, compute_dtype: Optional[torch.dtype] = None):
    """The port's ``StableDiffusion`` at the mix's size and sampler, with the
    configuration's ``pipeline`` settings, holding copies of ``weights`` (the
    pipeline keeps none of the benchmark's tensors). Every model is loaded here.

    The port gets the values the reference gets, through its own loader: each
    model's checkpoint path names the benchmark's in-memory weights, which the
    pipeline's ``_checkpoint`` returns for it, so ``_load_or_init`` builds, fuses,
    quantizes and casts them as it would a checkpoint's."""
    from minsdtf_tpu_torch.pipeline import StableDiffusion  # noqa: PLC0415

    dtype = compute_dtype or DTYPES[cfg["dtype"]]
    paths = {kind: f"sdbench:{kind}" for kind in weights}
    pipe = StableDiffusion(mix["height"], mix["width"], bpe_path=merges_path, compute_dtype=dtype, device=device,
                           unet_ckpt=paths["unet"], text_encoder_ckpt=paths["text_encoder"],
                           vae_ckpt=paths["vae"], controlnet_path=paths.get("controlnet"),
                           scheduler_type=mix.get("scheduler"), **cfg.get("pipeline", {}))

    def checkpoint(path, kind, lora=None):
        state = {k: v.clone() for k, v in weights[kind].items()}
        return (None, state) if kind == "vae" else state  # the VAE's pair: (encoder, decoder)

    pipe._checkpoint = checkpoint
    try:
        pipe.text_model, pipe.unet, pipe.decoder, pipe.controlnet  # noqa: B018 - each loads on first use
    finally:
        del pipe._checkpoint
    return pipe
