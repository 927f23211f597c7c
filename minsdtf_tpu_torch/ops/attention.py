"""Multi-head attention over ``(B, S, H*D)`` tensors.

Heads are split as views (no copy). :func:`flash_attention.route` sends each
call to K1, K2 or :func:`plain_attention`; the plain path serves what never
reaches a kernel: cross-attention (kv = 77), the 16x16 and 8x8 UNet levels
(kv < 512) and CLIP's causal attention. Inside :func:`plain_scope` every call
runs :func:`plain_attention` instead: it is the one path with a backward, so the
train step selects it by name. The scope holds for the current thread (or task)
only. Softmax statistics are fp32 whatever the compute dtype.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, Optional

import torch

from minsdtf_tpu_torch.ops import flash_attention as fa

_PLAIN = contextvars.ContextVar("minsdtf_plain_attention", default=False)


@contextlib.contextmanager
def plain_scope() -> Iterator[None]:
    """Every attention call in the body of a ``with`` block, in this thread,
    runs :func:`plain_attention`; the previous setting comes back on exit, also
    when the body raises. Other threads keep routing to the kernels."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                    causal: bool = False) -> torch.Tensor:
    """(B, S, H, D) attention with fp32 scores and softmax; the PV product runs in
    the compute dtype (fp32 when the inputs are fp32). Counterpart of the JAX
    package's ``_xla_attention``."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = scores.shape[-2], scores.shape[-1]
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(sk - sq)
        scores = scores.masked_fill(~mask, float("-inf"))
    weights = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v.to(q.dtype))


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                         scale: Optional[float] = None, causal: bool = False) -> torch.Tensor:
    """Scaled dot-product attention over (B, S, H*D) tensors. ``scale`` defaults to
    ``head_dim ** -0.5``; ``causal=True`` applies the CLIP triangular mask."""
    b, sq, hd = q.shape
    sk = k.shape[1]
    d = hd // num_heads
    if scale is None:
        scale = float(d) ** -0.5
    qh = q.unflatten(-1, (num_heads, d))
    kh = k.unflatten(-1, (num_heads, d))
    vh = v.unflatten(-1, (num_heads, d))
    impl = "plain" if _PLAIN.get() else fa.route(sq, sk, d, causal)
    if impl == "onepass":
        out = fa.onepass_attention(qh, kh, vh, scale)
    elif impl == "online":
        out = fa.online_attention(qh, kh, vh, scale)
    else:
        out = plain_attention(qh, kh, vh, scale, causal)
    return out.reshape(b, sq, hd)


def single_head_spatial_attention(q, k, v) -> torch.Tensor:
    """VAE attention block: one head over h*w tokens, scale 1/sqrt(C). (B, S, C)."""
    return multi_head_attention(q, k, v, num_heads=1, scale=float(q.shape[-1]) ** -0.5)
