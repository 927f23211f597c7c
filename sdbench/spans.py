"""The program's host spans in a traced segment, and the device's idle time they
hold.

The program records its spans (``minsdtf_tpu_torch.profiling``) on the device
trace's clock while the profiler runs; a program without the recorder records
none, and every reading here is then nothing.
"""

from __future__ import annotations

import collections
from typing import Callable, Iterable, List, Optional, Tuple


def program_spans(trace) -> Optional[list]:
    """The program's spans that overlap the traced segment; None without a trace,
    without the recorder or without a span."""
    from minsdtf_tpu_torch import profiling  # noqa: PLC0415

    if trace is None:
        return None
    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    return read(trace.t0_ns, trace.t1_ns) or None


def union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Intervals merged where they touch or overlap, in order."""
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def overlap_ns(xs: List[Tuple[int, int]], ys: List[Tuple[int, int]]) -> int:
    """ns common to two lists of disjoint intervals, each in order."""
    total, i, j = 0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def subtract(xs: List[Tuple[int, int]], ys: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The parts of ``xs`` outside ``ys``, two lists of disjoint intervals in order."""
    out: List[Tuple[int, int]] = []
    j = 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            if ys[k][0] > a:
                out.append((a, ys[k][0]))
            a = max(a, ys[k][1])
            k += 1
        if a < b:
            out.append((a, b))
    return out


def own(found: list, picked: Callable[[str], bool]) -> List[Tuple[int, int]]:
    """The intervals in which a span whose name ``picked`` holds was the innermost
    open span of its thread: each such span less the spans nested in it."""
    children = collections.defaultdict(list)
    for s in found:
        if s.parent is not None:
            children[s.parent].append((s.t0_ns, s.t1_ns))
    return union(piece for s in found if picked(s.name)
                 for piece in subtract([(s.t0_ns, s.t1_ns)], union(children[s.id])))


def idle_ns(trace, held: List[Tuple[int, int]]) -> Optional[int]:
    """ns of the segment in which the device was idle inside ``held`` (disjoint
    intervals in order); None without device operations or held time."""
    if not held or not trace.ops:
        return None
    return overlap_ns(union(trace.gaps()), held)


def idle_held_ns(trace, picked: Callable[[str], bool]) -> Optional[int]:
    """ns of the segment in which the device was idle and a program span whose name
    ``picked`` holds was open; None without device operations or such a span."""
    found = program_spans(trace)
    if not found:
        return None
    return idle_ns(trace, union((s.t0_ns, s.t1_ns) for s in found if picked(s.name)))


def mean_ms(trace, name: str) -> Optional[float]:
    """The mean length in ms of the program's spans called ``name``."""
    found = [s.t1_ns - s.t0_ns for s in program_spans(trace) or () if s.name == name]
    return sum(found) / len(found) / 1e6 if found else None
