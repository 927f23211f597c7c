"""Ring attention: exact attention with the token axis sharded over a mesh axis.

The counterpart of ``minsdtf_tpu/ops/ring_attention.py``. Each rank holds its
slice of the queries and of the keys and values; the K/V slices rotate around the
ring of the axis's group (:func:`minsdtf_tpu_torch.parallel.comm.ring_shift`),
and each rank merges the blockwise softmax statistics ``(o, m, l)`` of every
slice into its output rows, as the JAX ring does (``:62-73``). The next shift is
posted before the local block computes, so the transfer overlaps the compute
where the backend allows (over ``gloo`` the copy to host memory does not).
:func:`ring_attention_sharded` takes and returns this rank's tokens of an
activation that stays sharded end to end (spatial SP,
:mod:`minsdtf_tpu_torch.parallel.spatial`); :func:`ring_multi_head_attention`
takes whole inputs, slices them and gathers the output.

The block product is plain PyTorch, as the JAX ring's is an ``einsum`` outside
any Pallas kernel (``:27-34``): no TPU kernel is ported here, and neither K1 nor
K2 returns the log-sum-exp that the merge needs. Scores are fp32 from the
input-type values (fp32 products of bf16 values are exact, as JAX's
``preferred_element_type=float32`` products are); p is rounded to v's dtype for
the PV product, whose sums are fp32. The block runs over groups of heads whose
fp32 scores stay under :data:`BLOCK_SCORE_BYTES`: one 1024px block at model = 2
is (2, 8, 8192, 8192), 4.3 GB of scores, on a card that the ranks may share.

There is no backward, as the comm calls are outside autograd: with grad mode on
and an input requiring grad, :func:`ring_attention` raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from minsdtf_tpu_torch.parallel import comm

BLOCK_SCORE_BYTES = 1 << 30


def block_stats(q, k, v, scale: float):
    """Unnormalized attention of local q against one K/V block: returns
    ``(o = exp(s - m) @ v, m = rowmax(s), l = rowsum(exp(s - m)))``, fp32, with o
    (B, Sq, H, D) and the statistics (B, H, Sq)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return o, m, l


def _block_stats_by_heads(q, k, v, scale: float):
    """:func:`block_stats` over groups of heads whose scores fit
    :data:`BLOCK_SCORE_BYTES`, concatenated."""
    b, sq, h, _ = q.shape
    group = max(1, int(BLOCK_SCORE_BYTES // (4 * b * sq * k.shape[1])))
    if group >= h:
        return block_stats(q, k, v, scale)
    parts = [block_stats(q[:, :, i:i + group], k[:, :, i:i + group], v[:, :, i:i + group],
                         scale) for i in range(0, h, group)]
    o, m, l = zip(*parts)
    return torch.cat(o, dim=2), torch.cat(m, dim=1), torch.cat(l, dim=1)


def _heads_last(x):
    """(B, H, Sq) statistics -> (B, Sq, H, 1), to scale o."""
    return x.transpose(1, 2)[..., None]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention of this rank's (B, Sq_local, H, D) queries over the whole
    K/V sequence, whose slices the ranks of ``group`` hold in group-rank order;
    the output is sharded like q."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("ring_attention has no backward: its transfers are outside "
                           "autograd. Train without sequence parallelism.")
    scale = float(q.shape[-1]) ** -0.5 if scale is None else scale
    n = dist.get_world_size(group)
    pending = comm.ring_shift([k, v], group) if n > 1 else None
    o, m, l = _block_stats_by_heads(q, k, v, scale)
    for step in range(n - 1):
        k_cur, v_cur = pending.wait()
        pending = comm.ring_shift([k_cur, v_cur], group) if step < n - 2 else None
        o_b, m_b, l_b = _block_stats_by_heads(q, k_cur, v_cur, scale)
        m_new = torch.maximum(m, m_b)
        c_acc, c_b = torch.exp(m - m_new), torch.exp(m_b - m_new)
        o = o * _heads_last(c_acc) + o_b * _heads_last(c_b)
        l = l * c_acc + l_b * c_b
        m = m_new
    return (o / _heads_last(l)).to(q.dtype)


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                           group, scale: Optional[float] = None) -> torch.Tensor:
    """This rank's (B, S/n, H*D) tokens of q, k and v, whose slices the ranks of
    ``group`` hold in group-rank order -> this rank's (B, S/n, H*D) output rows:
    no slicing and no gather, for activations that stay sharded end to end
    (:mod:`minsdtf_tpu_torch.parallel.spatial`). ``.calls`` counts the calls."""
    b, s, hd = q.shape
    heads = [t.unflatten(-1, (num_heads, hd // num_heads)) for t in (q, k, v)]
    out = ring_attention(*heads, group, scale)
    ring_attention_sharded.calls += 1
    return out.reshape(b, s, hd)


ring_attention_sharded.calls = 0


def ring_multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              num_heads: int, mesh, axis_name: str = "data",
                              scale: Optional[float] = None) -> torch.Tensor:
    """Whole (B, S, H*D) inputs on every rank -> this rank's slice of S over the
    mesh axis ``axis_name``, the ring, and the slices gathered back: the whole
    (B, S, H*D) output on every rank. ``.calls`` counts the calls."""
    group = mesh.get_group(axis_name)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    b, s, hd = q.shape
    if s % n:
        raise ValueError(f"{s} tokens cannot be split over {axis_name}={n}")
    part = s // n

    def local(t):
        return t[:, r * part:(r + 1) * part].unflatten(-1, (num_heads, hd // num_heads))

    out = ring_attention(local(q), local(k), local(v), group, scale)
    ring_multi_head_attention.calls += 1
    return comm.all_gather(out.reshape(b, part, hd), group, dim=1)


ring_multi_head_attention.calls = 0
