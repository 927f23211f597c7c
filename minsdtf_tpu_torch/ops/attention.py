"""Multi-head attention over ``(B, S, H*D)`` tensors.

Heads are split as views (no copy). :func:`flash_attention.route` sends each
call to K1, K2 or :func:`plain_attention`; the plain path serves what never
reaches a kernel: cross-attention (kv = 77), the 16x16 and 8x8 UNet levels
(kv < 512), CLIP's causal attention, and fp64 (reference runs; no kernel is
built for it). Inside :func:`plain_scope` every call runs :func:`plain_attention`
instead: it is the one path with a backward, so the train step selects it by name.

Inside :func:`sequence_parallel_scope` a self-attention (not causal, as many keys
as queries) over at least ``min_seq`` tokens that the mesh axis divides runs as
ring attention (:mod:`ops.ring_attention`), before any other route is chosen, as
in the JAX package (``minsdtf_tpu/ops/attention.py:136-145``). The models keep
the activations of such a resolution H-sharded end to end
(:mod:`minsdtf_tpu_torch.parallel.spatial`; the rule is :func:`spatial_sharded`),
and say so with ``sharded=True``: the tokens are then this rank's slice already,
and the ring takes and returns them as they are. So inside both
scopes the ring runs: ``plain_scope`` never wins over SP, and the JAX train step
never runs under SP either (``make_train_step`` enters ``plain_scope`` only). The
ring has no backward and raises if asked for a gradient, as the kernels do.

Each scope holds for the current thread (or task) only; the JAX package's
sequence-parallel setting is process-global. Softmax statistics are fp32 whatever
the compute dtype (fp64 in fp64).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, Optional

import torch

from minsdtf_tpu_torch.ops import flash_attention as fa
from minsdtf_tpu_torch.ops.basic import stats_dtype
from minsdtf_tpu_torch.ops.ring_attention import ring_attention_sharded, ring_multi_head_attention
from minsdtf_tpu_torch.parallel.mesh import axis_size

_PLAIN = contextvars.ContextVar("minsdtf_plain_attention", default=False)
# (mesh, axis_name, min_seq) or None
_SP = contextvars.ContextVar("minsdtf_sequence_parallel", default=None)


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


@contextlib.contextmanager
def sequence_parallel_scope(mesh, axis_name: str = "model",
                            min_seq: int = 16384) -> Iterator[None]:
    """In the body of a ``with`` block, in this thread, a self-attention over at
    least ``min_seq`` tokens (the 1024px latent's 128x128 by default; smaller
    attentions stay whole, their blocks too small to pay for the ring's
    transfers) that the size of ``mesh``'s ``axis_name`` divides runs as ring
    attention over that axis. ``mesh=None`` turns it off. The previous setting
    comes back on exit."""
    token = _SP.set(None if mesh is None else (mesh, axis_name, int(min_seq)))
    try:
        yield
    finally:
        _SP.reset(token)


def sequence_parallel_key():
    """The identity of this thread's SP setting: None, or ``(axis_name, min_seq,
    (("data", d), ("model", m)))`` as the JAX package's key."""
    sp = _SP.get()
    if sp is None:
        return None
    mesh, axis_name, min_seq = sp
    return (axis_name, min_seq, tuple(zip(mesh.mesh_dim_names, mesh.shape)))


def route_key():
    """This thread's attention route: whether :func:`plain_scope` holds, and
    :func:`sequence_parallel_key`. A captured program replays the route it was
    captured under, so the sampler's program cache keys on it."""
    return _PLAIN.get(), sequence_parallel_key()


def sp_shardable(tokens: int):
    """``(mesh, axis_name, n)`` when this thread's SP setting shards a
    ``tokens``-long axis over n ranks (n > 1, ``tokens >= min_seq``, n divides
    ``tokens``); else None. The counterpart of the JAX package's
    ``_sp_shardable`` (``minsdtf_tpu/ops/attention.py:55-66``)."""
    sp = _SP.get()
    if sp is None:
        return None
    mesh, axis_name, min_seq = sp
    n = axis_size(mesh, axis_name)
    if n <= 1 or tokens < min_seq or tokens % n:
        return None
    return mesh, axis_name, n


def spatial_sharded(h: int, w: int) -> bool:
    """Whether an activation of the global spatial size ``h`` x ``w`` is H-sharded
    under this thread's SP setting: its h*w tokens are shardable
    (:func:`sp_shardable`) and n divides h, the condition of the JAX package's
    ``constrain_spatial`` (``:78``). Decided from the global size, which the
    model's forward passes down, never from a local tensor."""
    cfg = sp_shardable(h * w)
    return cfg is not None and h % cfg[2] == 0


def sequence_parallel_group():
    """The process group of this thread's SP axis, or None when SP is off."""
    sp = _SP.get()
    return None if sp is None else sp[0].get_group(sp[1])


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                    causal: bool = False) -> torch.Tensor:
    """(B, S, H, D) attention with fp32 scores and softmax; the PV product runs in
    the compute dtype (fp32 when the inputs are fp32, fp64 throughout in fp64).
    Counterpart of the JAX package's ``_xla_attention``."""
    wide = stats_dtype(q.dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(wide), k.to(wide)) * scale
    if causal:
        sq, sk = scores.shape[-2], scores.shape[-1]
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(sk - sq)
        scores = scores.masked_fill(~mask, float("-inf"))
    weights = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v.to(q.dtype))


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                         scale: Optional[float] = None, causal: bool = False,
                         sharded: bool = False) -> torch.Tensor:
    """Scaled dot-product attention over (B, S, H*D) tensors. ``scale`` defaults to
    ``head_dim ** -0.5``; ``causal=True`` applies the CLIP triangular mask.
    ``sharded=True``: a self-attention whose q, k and v are this rank's tokens of
    an H-sharded activation, run as the sharded ring over the SP axis."""
    b, sq, hd = q.shape
    sk = k.shape[1]
    d = hd // num_heads
    if scale is None:
        scale = float(d) ** -0.5
    if sharded:
        return ring_attention_sharded(q, k, v, num_heads, sequence_parallel_group(), scale)
    cfg = sp_shardable(sq) if not causal and sq == sk else None
    if cfg is not None:
        return ring_multi_head_attention(q, k, v, num_heads, cfg[0], cfg[1], scale=scale)
    qh = q.unflatten(-1, (num_heads, d))
    kh = k.unflatten(-1, (num_heads, d))
    vh = v.unflatten(-1, (num_heads, d))
    plain = _PLAIN.get() or q.dtype == torch.float64
    impl = "plain" if plain else fa.route(sq, sk, d, causal)
    if impl == "onepass":
        out = fa.onepass_attention(qh, kh, vh, scale)
    elif impl == "online":
        out = fa.online_attention(qh, kh, vh, scale)
    else:
        out = plain_attention(qh, kh, vh, scale, causal)
    return out.reshape(b, sq, hd)


def single_head_spatial_attention(q, k, v, sharded: bool = False) -> torch.Tensor:
    """VAE attention block: one head over h*w tokens, scale 1/sqrt(C). (B, S, C)."""
    return multi_head_attention(q, k, v, num_heads=1, scale=float(q.shape[-1]) ** -0.5,
                                sharded=sharded)
