"""Profiling on the card: device traces, operation reports and the program's host
spans.

``trace(log_dir)`` records the card's activity with ``torch.profiler`` (CUDA
activity only: the host's events cost most of the profiler's processing time and
no number here reads them; CPU activity on a machine without a card) and writes a
Chrome trace, with the host spans recorded inside the block beside the kernels;
``op_report`` sums a finished profile's device time by kernel name or by kernel
group (:func:`kernel_group`).

Host spans name what the host does at the program's layer boundaries (the
encode, the host preparation, the step program, the fetch, the serving worker's
queue, merge, dispatch and fetch). ``with span(name, n=None, req=None)`` times a
block; :func:`mark` records a span whose start was taken earlier. Each span is
``Span(id, parent, name, t0_ns, t1_ns, thread, n, req)``: the parent is the
innermost span open in the same thread (None for a mark), ``n`` the count that
belongs to the boundary (images, prompt chunks), ``req`` the serving request id
or ids it serves (a list of requests, objects with an ``id``, is recorded as the
tuple of their ids, built only when the span records). Spans record only while a ``torch.profiler`` profile runs, in
every thread: ``torch.autograd.profiler._is_profiler_enabled`` is the module-wide
flag the profile sets on entry and clears on exit (``torch.autograd.
_profiler_enabled()`` is per thread and reads False in a thread started before the
profile, as the serving worker's is). Otherwise a span costs that one attribute
read. Times are ``time.time_ns()``, the clock of the profiler's events, so a
device trace's idle gaps can be named by the spans that hold them. The spans go
into a ring of the newest ``SPAN_RING``; :func:`spans` returns those that overlap
an interval and :func:`clear_spans` empties it; :func:`recording` says whether
spans record now.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

SPAN_RING = 1 << 16  # spans kept, the newest; a server under a profiler stays bounded

# kernel group -> lowercase marks of its kernels' names; the first match wins
KERNEL_GROUPS = (
    ("attention K1/K2", ("flash_onepass", "flash_online", "flash_bf16")),
    ("convolution", ("conv", "fprop", "implicit", "dgrad", "winograd")),
    # torch._int_mm's int8 x int8 -> int32 products (the int8 path's convs and
    # dense sites), e.g. cutlass_80_tensorop_i16832gemm_s8_128x64_128x3_tn_align16
    ("int8 gemm", ("gemm_s8", "s8s8", "imma")),
    ("gemm", ("gemm", "nvjet", "cutlass", "matmul")),
    ("norm", ("norm",)),
    ("memcpy/memset", ("memcpy", "memset")),
)


def kernel_group(name: str) -> str:
    """The group of a device operation by its name; "elementwise/other" where no
    group's mark is in it."""
    lowered = name.lower()
    for group, marks in KERNEL_GROUPS:
        if any(m in lowered for m in marks):
            return group
    return "elementwise/other"


# ---- host spans ----------------------------------------------------------------------


class Span(NamedTuple):
    id: int
    parent: Optional[int]
    name: str
    t0_ns: int
    t1_ns: int
    thread: int  # the recording thread's native id
    n: Optional[int]
    req: object  # a request id, a tuple of them, or None


# plain tuples, which the collector stops tracking: a full ring of tracked objects
# would make each full collection walk it
_ring: "collections.deque[tuple]" = collections.deque(maxlen=SPAN_RING)
_ids = itertools.count(1)
_local = threading.local()


def _thread() -> tuple:
    """This thread's ``(ids of its open spans, innermost last; its native id)``: the
    id is read once, as ``get_native_id`` is a system call."""
    state = getattr(_local, "state", None)
    if state is None:
        state = _local.state = ([], threading.get_native_id())
    return state


def recording() -> bool:
    """Whether spans record now: a ``torch.profiler`` profile runs."""
    return _autograd_profiler._is_profiler_enabled


def _ids_of(req):
    return tuple(r.id for r in req) if isinstance(req, list) else req


class span:
    """``with span(name, n=None, req=None) as s:`` records the block as a
    :class:`Span` while a profile runs; ``s.n`` may be set inside. An exception
    inside still closes it."""

    __slots__ = ("name", "n", "req", "_id", "_parent", "_t0")

    def __init__(self, name: str, n: Optional[int] = None, req=None):
        self.name, self.n, self.req, self._t0 = name, n, req, None

    def __enter__(self) -> "span":
        if _autograd_profiler._is_profiler_enabled:
            stack = _thread()[0]
            self._parent = stack[-1] if stack else None
            self._id = next(_ids)
            stack.append(self._id)
            self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self._t0 is not None:
            t1 = time.time_ns()
            stack, tid = _thread()
            stack.pop()
            _ring.append((self._id, self._parent, self.name, self._t0, t1, tid, self.n, _ids_of(self.req)))
        return False


def mark(name: str, t0_ns: int, t1_ns: int, n: Optional[int] = None, req=None) -> None:
    """Records a span from ``t0_ns``, taken earlier (a request's enqueue), to
    ``t1_ns``, while a profile runs."""
    if _autograd_profiler._is_profiler_enabled:
        _ring.append((next(_ids), None, name, int(t0_ns), int(t1_ns), _thread()[1], n, _ids_of(req)))


def spans(t0_ns: Optional[int] = None, t1_ns: Optional[int] = None) -> List[Span]:
    """The recorded spans that overlap ``[t0_ns, t1_ns]`` (either end open when
    None), oldest first."""
    lo = -1 if t0_ns is None else t0_ns
    hi = float("inf") if t1_ns is None else t1_ns
    return [Span._make(s) for s in tuple(_ring) if s[4] >= lo and s[3] <= hi]


def clear_spans() -> None:
    _ring.clear()


def _chrome_events(recorded: List[Span], base_ns: int) -> list:
    """Chrome trace events of ``recorded``, ``ts`` in us from ``base_ns``: a track
    per thread, a complete event for each span that nests in the spans before it
    there, an async pair (which may overlap others) for each that does not, as a
    mark from another thread's start does."""
    pid = os.getpid()
    names = {t.native_id: t.name for t in threading.enumerate()}
    out = []
    by_thread = collections.defaultdict(list)
    for s in recorded:
        by_thread[s.thread].append(s)
    for tid, group in by_thread.items():
        out.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                    "args": {"name": f"spans: {names.get(tid, tid)}"}})
        ends: list = []  # the ends of the complete events holding the current time
        for s in sorted(group, key=lambda s: (s.t0_ns, -s.t1_ns)):
            while ends and ends[-1] <= s.t0_ns:
                ends.pop()
            args = {"id": s.id, "parent": s.parent, "n": s.n, "req": s.req}
            ts = (s.t0_ns - base_ns) / 1e3
            if not ends or s.t1_ns <= ends[-1]:
                ends.append(s.t1_ns)
                out.append({"ph": "X", "cat": "span", "name": s.name, "pid": pid, "tid": tid,
                            "ts": ts, "dur": (s.t1_ns - s.t0_ns) / 1e3, "args": args})
            else:
                for ph, t in (("b", ts), ("e", (s.t1_ns - base_ns) / 1e3)):
                    out.append({"ph": ph, "cat": "span", "name": s.name, "id": s.id, "pid": pid,
                                "tid": tid, "ts": t, "args": args if ph == "b" else {}})
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """Record the card's activity inside the block with ``torch.profiler`` (yielded,
    for :func:`op_report`) and write it to ``log_dir/trace.json`` (Chrome trace
    format) with the host spans recorded inside the block, one track a thread, on
    the profiler's timebase."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        t0_ns = time.time_ns()
        yield prof
        t1_ns = time.time_ns()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"] += _chrome_events(spans(t0_ns, t1_ns), int(doc.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as f:
        json.dump(doc, f)
    print(f"profile written to {path} (chrome://tracing or Perfetto)")


def op_report(prof, by: str = "name", device: str = "cuda", top: Optional[int] = 25) -> dict:
    """``{key: (ms, count)}``, largest first, over the events of the finished
    profile ``prof``: each kernel's device time on ``device="cuda"``, or each
    operator's self CPU time on ``device="cpu"`` (a CPU-only profile), summed by
    name (``by="name"``) or by :func:`kernel_group` (``by="group"``). Prints the
    total and the ``top`` rows (none when ``top`` is None)."""
    from torch.autograd import DeviceType

    if by not in ("name", "group"):
        raise ValueError(f"by must be 'name' or 'group', got {by!r}")
    want = {"cuda": DeviceType.CUDA, "cpu": DeviceType.CPU}[device]
    buckets = {}
    for e in prof.events():
        if e.device_type != want:
            continue
        ms = (e.device_time_total if want == DeviceType.CUDA else e.self_cpu_time_total) / 1e3
        key = e.name if by == "name" else kernel_group(e.name)
        total, count = buckets.get(key, (0.0, 0))
        buckets[key] = (total + ms, count + 1)
    rows = dict(sorted(buckets.items(), key=lambda kv: -kv[1][0]))
    if top is not None:
        busy = sum(t for t, _ in rows.values())
        print(f"{device} time total: {busy:.3f} ms ({by} buckets)")
        for key, (t, n) in list(rows.items())[:top]:
            print(f"  {t:10.3f} ms  n={n:6d}  {key[:100]}")
    return rows
