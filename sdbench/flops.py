"""The work of a request, counted from the benchmark's own reference models: the
FLOPs of its products (``torch.utils.flop_counter`` on meta tensors, so nothing
is allocated or run), and the least time of its long self-attentions on the chip
(the roofline bound of each call).

The program cannot move these numbers: they follow from the configuration and the
traffic mix alone.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from sdbench.reference.models import build

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())
KERNEL_MIN_TOKENS = 512  # self-attentions shorter than this run as plain products
CHUNK_TOKENS = 75  # a prompt's tokens in one CLIP chunk of 77
PEAK_KEYS = {"bfloat16": "bf16_flops"}  # the peak a configuration's dtype is held to
_COUNTS: Dict[tuple, int] = {}


def peaks(device_name: str) -> dict:
    """The published peaks of the card called ``device_name``."""
    for key, value in PEAKS.items():
        if key in device_name:
            return value
    raise KeyError(f"no peaks recorded for {device_name!r}; known: {sorted(PEAKS)}")


def peak_flops(peak: dict, dtype: str) -> Optional[float]:
    """The card's peak for a configuration computed in ``dtype``; nothing where
    no peak is recorded for it (a share of a peak is then not read)."""
    key = PEAK_KEYS.get(dtype)
    return None if key is None else peak.get(key)


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


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
            return _count(lambda: m(torch.zeros(batch, 77, dtype=torch.long, device=meta)))
        if kind == "vae":
            m = build(kind, cfg)
            return _count(lambda: m(torch.zeros(batch, 4, h8, w8, device=meta)))
        if kind == "hint":
            m = build("controlnet", cfg)
            return _count(lambda: m.hint(torch.zeros(batch, 3, height, width, device=meta)))
        ctx = torch.zeros(batch, ctx_tokens, cfg[kind]["cross_attention_dim"], device=meta)
        x = torch.zeros(batch, 4, h8, w8, device=meta)
        t = torch.zeros(batch, device=meta)
        m = build(kind, cfg)
        if kind == "unet":
            return _count(lambda: m(x, t, ctx))
        hint = torch.zeros(batch, cfg["controlnet"]["block_out_channels"][0], h8, w8, device=meta)
        return _count(lambda: m(x, t, ctx, hint))


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


def attention_bound_s(b: int, s: int, h: int, d: int, peak: dict, dtype_bytes: int = 2) -> float:
    """Least time of a (B, S, H, D) self-attention: 4*B*H*S*S*D operations at the
    type's peak, or q, k, v read once and o written once at the memory's rate,
    whichever is longer."""
    ops = 4.0 * b * h * s * s * d
    nbytes = 4.0 * b * s * h * d * dtype_bytes
    return max(ops / peak["bf16_flops"], nbytes / peak["hbm_bytes_per_s"])


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


def request_attention_bound_s(cfg: dict, mix: dict, peak: dict, req=None) -> float:
    """The least time of one request's long self-attentions on the card."""
    return sum(n * attention_bound_s(*shape, peak) for n, shape in long_attentions(cfg, mix, req))
