"""The collectives the port uses, in one place: a sum all-reduce over a group, an
all-gather over a group, the ring shift of ring attention, and the halo exchange
of an H-sharded convolution (:mod:`minsdtf_tpu_torch.parallel.spatial`).

Every call waits with a timeout, :data:`TIMEOUT`, which
:func:`minsdtf_tpu_torch.parallel.mesh.init_process` also gives the process
group, so a rank that dies fails its peers' calls instead of hanging them.

What ``gloo`` takes on CUDA tensors: its all-reduce and all-gather have CUDA
paths (they stage through host memory themselves); its send and recv read the
tensor's pointer as host memory. So :func:`ring_shift` stages CUDA tensors
through pinned host buffers when the group's backend is ``gloo``, chosen by the
backend's name; NCCL takes them as they are. The halo exchange is an all-gather,
so it takes one path on either backend. The all-reduce sums bf16 and fp16
in fp32 and rounds once, whatever the backend.

:data:`stats` counts each kind of call, its bytes and the host seconds it held
the caller (the wait included); :func:`reset_stats` zeroes it.
"""

from __future__ import annotations

import datetime
import time
from typing import List, Sequence

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(seconds=300)
_KINDS = ("all_reduce", "all_gather", "ring_shift", "halo")
stats = {kind: {"calls": 0, "bytes": 0, "seconds": 0.0} for kind in _KINDS}


def reset_stats() -> None:
    for entry in stats.values():
        entry.update(calls=0, bytes=0, seconds=0.0)


def _count(kind: str, nbytes: int, t0: float) -> None:
    entry = stats[kind]
    entry["calls"] += 1
    entry["bytes"] += nbytes
    entry["seconds"] += time.perf_counter() - t0


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, as a new tensor of ``t``'s dtype. Half
    types are summed in fp32."""
    t0 = time.perf_counter()
    wide = torch.promote_types(t.dtype, torch.float32)
    out = t.to(wide, copy=True, memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group, async_op=True).wait(TIMEOUT)
    _count("all_reduce", out.numel() * out.element_size(), t0)
    return out.to(t.dtype)


def _parts(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t`` of ``group`` in group-rank order, laid out as ``t``: a 4-D
    ``t`` whose memory is dense NHWC (channels-last) travels as its NHWC view, which
    is contiguous, so neither side copies it into another layout."""
    nhwc = t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last)
    sent = (t.permute(0, 2, 3, 1) if nhwc else t).contiguous()
    parts = [torch.empty_like(sent) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, sent, group=group, async_op=True).wait(TIMEOUT)
    return [p.permute(0, 3, 1, 2) for p in parts] if nhwc else parts


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` of ``group``, concatenated along ``dim`` in group-rank
    order; channels-last from a channels-last ``t``."""
    t0 = time.perf_counter()
    parts = _parts(t, group)
    _count("all_gather", t.numel() * t.element_size() * len(parts), t0)
    return torch.cat(parts, dim=dim)


def cat_rows(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """``parts`` of (B, C, H, W) tensors concatenated along H, the empty ones left
    out: with an empty part ``torch.cat`` lays its result out NCHW whatever the
    others' layout, and without one it keeps their common layout."""
    return torch.cat([p for p in parts if p.shape[2]] or list(parts[:1]), dim=2)


def halo_exchange(x: torch.Tensor, group, top: int, bottom: int):
    """The rows that this rank of ``group`` needs from its neighbours, where each
    rank holds its slice of H of a (B, C, H, W) tensor in group-rank order:
    ``(above, below)``, the previous rank's last ``top`` rows and the next rank's
    first ``bottom`` rows, zeros past the first and last rank, all in ``x``'s
    layout (channels-last rows give channels-last edges). One all-gather of every
    rank's (first ``bottom``, last ``top``) rows moves both edges."""
    t0 = time.perf_counter()
    n, r, h = dist.get_world_size(group), dist.get_rank(group), x.shape[2]
    edge = cat_rows([x[:, :, :bottom], x[:, :, h - top:]])
    parts = _parts(edge, group)
    above = parts[r - 1][:, :, bottom:] if r > 0 else torch.zeros_like(edge[:, :, bottom:])
    below = parts[r + 1][:, :, :bottom] if r < n - 1 else torch.zeros_like(edge[:, :, :bottom])
    _count("halo", edge.numel() * edge.element_size() * n, t0)
    return above, below


class _Shift:
    """A posted ring shift; :meth:`wait` returns the received tensors on the
    senders' device."""

    def __init__(self, works, received: List[torch.Tensor], device: torch.device,
                 nbytes: int, t0: float):
        self._works, self._received, self._device = works, received, device
        self._nbytes, self._seconds = nbytes, time.perf_counter() - t0

    def wait(self) -> List[torch.Tensor]:
        t0 = time.perf_counter()
        for work in self._works:
            work.wait(TIMEOUT)
        out = [r.to(self._device, non_blocking=True) for r in self._received]
        _count("ring_shift", self._nbytes, t0 - self._seconds)
        return out


def ring_shift(tensors: Sequence[torch.Tensor], group) -> _Shift:
    """Post the send of each tensor to the next rank of ``group`` and the receive
    of the previous rank's, and return at once; ``.wait()`` gives the received
    tensors. Over ``gloo`` CUDA tensors are copied to pinned host buffers first
    (the copy waits for their producers) and the receives land in pinned buffers."""
    t0 = time.perf_counter()
    ranks = dist.get_process_group_ranks(group)
    me = dist.get_rank(group)
    nxt, prev = ranks[(me + 1) % len(ranks)], ranks[(me - 1) % len(ranks)]
    device = tensors[0].device
    staged = device.type == "cuda" and dist.get_backend(group) == "gloo"
    ops, received = [], []
    for t in tensors:
        t = t.contiguous()
        if staged:
            t = torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
        buf = torch.empty_like(t)
        ops += [dist.P2POp(dist.isend, t, nxt, group), dist.P2POp(dist.irecv, buf, prev, group)]
        received.append(buf)
    works = dist.batch_isend_irecv(ops)
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    return _Shift(works, received, device, nbytes, t0)
