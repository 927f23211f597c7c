"""The work of a request as every model family counts it: the FLOPs of a call
(``torch.utils.flop_counter`` on meta tensors, so nothing is allocated or run),
the card's peaks, and the least time of a self-attention on the chip (the
roofline bound of each call). Which calls a request makes, and their shapes, is
the family's (``sdbench/families/``).

The program cannot move these numbers: they follow from the configuration and the
traffic mix alone.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

from torch.utils.flop_counter import FlopCounterMode

from sdbench import families

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())
PEAK_KEYS = {"bfloat16": "bf16_flops"}  # the peak a configuration's dtype is held to


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


def count(fn) -> int:
    """The FLOPs of the products ``fn()`` runs."""
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def attention_bound_s(b: int, s: int, h: int, d: int, peak: dict, dtype_bytes: int = 2) -> float:
    """Least time of a (B, S, H, D) self-attention: 4*B*H*S*S*D operations at the
    type's peak, or q, k, v read once and o written once at the memory's rate,
    whichever is longer."""
    ops = 4.0 * b * h * s * s * d
    nbytes = 4.0 * b * s * h * d * dtype_bytes
    return max(ops / peak["bf16_flops"], nbytes / peak["hbm_bytes_per_s"])


def request_attention_bound_s(cfg: dict, mix: dict, peak: dict, req=None) -> float:
    """The least time of one request's long self-attentions on the card, as the
    configuration's family lists them."""
    calls = families.load(cfg).long_attentions(cfg, mix, req)
    return sum(n * attention_bound_s(*shape, peak) for n, shape in calls)
