"""What the harness keeps around the system under test, whatever its family
builds (``build_pipeline`` of ``sdbench/families/<family>.py``): the torch type
of a configuration's ``dtype``, and the serving worker's recording proxy.
"""

from __future__ import annotations

import threading
import time
from typing import List

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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
