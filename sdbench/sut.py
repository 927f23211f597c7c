"""The system under test: ``minsdtf_tpu_torch``'s pipeline, holding the
benchmark's weights, and its serving worker behind a recording proxy.

The port gets the values the reference gets, through its own loader: each
model's checkpoint path names the benchmark's in-memory weights, which the
pipeline's ``_checkpoint`` returns for it, so ``_load_or_init`` builds, fuses,
quantizes and casts them as it would a checkpoint's.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import torch

from minsdtf_tpu_torch.pipeline import StableDiffusion

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_pipeline(cfg: dict, weights: Dict[str, Dict[str, torch.Tensor]], mix: dict, device,
                   merges_path: str, compute_dtype: Optional[torch.dtype] = None) -> StableDiffusion:
    """A ``StableDiffusion`` at the mix's size and sampler, with the
    configuration's ``pipeline`` settings, holding copies of ``weights`` (the
    pipeline keeps none of the benchmark's tensors). Every model is loaded here."""
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


class Span:
    __slots__ = ("name", "t0", "t1", "batch")

    def __init__(self, name: str, t0: int, t1: int, batch: int = 0):
        self.name, self.t0, self.t1, self.batch = name, t0, t1, batch


class RecordingPipe:
    """Forwards everything to ``pipe``; records a span (wall-clock ns) around each
    ``generate_image`` call, with its batch size, and each text encode, while
    ``recording`` is set."""

    def __init__(self, pipe):
        self._pipe = pipe
        self.spans: List[Span] = []
        self.recording = False
        self._lock = threading.Lock()

    def __getattr__(self, name):
        return getattr(self._pipe, name)

    def _record(self, name: str, t0: int, batch: int = 0) -> None:
        if self.recording:
            with self._lock:
                self.spans.append(Span(name, t0, time.time_ns(), batch))

    def _encode_text_dev(self, prompt, *args, **kw):
        t0 = time.time_ns()
        try:
            return self._pipe._encode_text_dev(prompt, *args, **kw)
        finally:
            self._record("encode", t0)

    def generate_image(self, *args, **kw):
        t0 = time.time_ns()
        try:
            return self._pipe.generate_image(*args, **kw)
        finally:
            self._record("generate_image", t0, int(kw.get("batch_size", 1)))
