"""The device trace of a traced segment, and what is read from it.

``torch.profiler`` with CUDA activity records every operation the card ran (the
kernels inside a replayed CUDA graph too) with its start and end on the host's
wall clock, in ns. The harness records its own host spans on the same clock, so
an idle gap of the device can be named by what the host was doing meanwhile.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, List, Optional, Sequence, Tuple

Op = Tuple[str, int, int]  # (name, start ns, end ns)


class Trace:
    """The device operations of one traced segment, its host-clock length in
    seconds, the host spans ``(name, start ns, end ns)`` recorded inside it, and
    the images the segment completed."""

    def __init__(self, ops: List[Op], window_s: float, spans: List[Tuple[str, int, int]],
                 images: int, t0_ns: int, t1_ns: int, outside: str):
        self.ops, self.window_s, self.spans, self.images = ops, window_s, spans, images
        self.t0_ns, self.t1_ns, self.outside = t0_ns, t1_ns, outside

    def seconds(self, marks: Sequence[str], exclude: Sequence[str] = ()) -> float:
        """Device seconds of the operations whose lowercase name holds one of
        ``marks`` and none of ``exclude``."""
        total = 0
        for name, a, b in self.ops:
            low = name.lower()
            if any(m in low for m in marks) and not any(x in low for x in exclude):
                total += b - a
        return total / 1e9

    def busy_s(self) -> float:
        """Seconds in which any operation ran: the union of their intervals."""
        total, end = 0, None
        for _, a, b in sorted(self.ops, key=lambda op: op[1]):
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        return total / 1e9

    def gaps(self) -> List[Tuple[int, int]]:
        """The idle intervals of the device inside the segment, ns."""
        out, end = [], self.t0_ns
        for _, a, b in sorted(self.ops, key=lambda op: op[1]):
            if a > end:
                out.append((end, a))
            end = max(end, b)
        if self.t1_ns > end:
            out.append((end, self.t1_ns))
        return out

    def host_doing(self, t_ns: int) -> str:
        """The innermost host span that holds ``t_ns``; ``outside`` outside all."""
        best = None
        for name, a, b in self.spans:
            if a <= t_ns <= b and (best is None or b - a < best[1]):
                best = (name, b - a)
        return self.outside if best is None else best[0]

    def breakdown(self, top: int = 10) -> dict:
        by_name = collections.Counter()
        for name, a, b in self.ops:
            by_name[name[:160]] += b - a
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, t / 1e9] for n, t in by_name.most_common(top)],
                "idle_gaps": [[self.host_doing((a + b) // 2), (b - a) / 1e9] for a, b in gaps]}


def record(fn: Callable[[List[Tuple[str, int, int]]], int], outside: str) -> Trace:
    """Runs ``fn(spans)`` under the profiler, which returns the images it completed
    and appends its host spans to ``spans``; the segment ends when the card is
    idle. ``outside`` names what the host does outside every span."""
    import torch  # noqa: PLC0415
    from torch.autograd import DeviceType  # noqa: PLC0415
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    spans: List[Tuple[str, int, int]] = []
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    # without a card (the CPU tests) the segment runs and records no device operation
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        t0_ns, p0 = time.time_ns(), time.perf_counter()
        images = fn(spans)
        sync()
        window_s, t1_ns = time.perf_counter() - p0, time.time_ns()
    ops = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA]
    return Trace(ops, window_s, spans, images, t0_ns, t1_ns, outside)


def idle_share(trace: Optional[Trace]) -> Optional[float]:
    """The share of the traced segment, in percent, in which no device operation
    ran; nothing where the segment ran none."""
    if trace is None or not trace.ops:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
