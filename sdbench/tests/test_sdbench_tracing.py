"""The readers of the program's host spans on a synthetic traced segment: the idle
time they hold by interval overlap, the means of the serving spans, and nothing
where there is no trace, no device operation, no span or no recorder."""

from __future__ import annotations

import types

import pytest

from minsdtf_tpu_torch import profiling
from sdbench import harness, spans
from sdbench.trace import Trace

OPS = [("k", 0, 100), ("k", 150, 300), ("k", 400, 1000)]  # idle (100, 150) and (300, 400)


def span(name, t0, t1, i=0, parent=None):
    return profiling.Span(i, parent, name, t0, t1, 1, None, None)


def record(ops=OPS, images=2):
    """A run's record whose traced segment is 0 to 1000 ns with ``ops``."""
    return types.SimpleNamespace(trace=Trace(ops, 1e-6, [], images, 0, 1000, "outside"))


@pytest.fixture
def program(monkeypatch):
    """A setter of the spans the program's ``profiling.spans`` returns."""
    held = []
    monkeypatch.setattr(profiling, "spans", lambda t0=None, t1=None: [
        s for s in held if s.t1_ns >= t0 and s.t0_ns <= t1])
    return lambda found: held.__setitem__(slice(None), found)


def read(name, rec):
    return harness.load_reader(name)(rec)


def test_union_and_overlap():
    assert spans.union([(5, 9), (0, 3), (3, 4), (8, 12)]) == [(0, 4), (5, 12)]
    assert spans.overlap_ns([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert spans.overlap_ns([(0, 10)], [(10, 20)]) == 0
    assert spans.overlap_ns([], [(0, 5)]) == 0
    assert spans.subtract([(0, 10), (20, 30)], [(2, 4), (8, 22), (25, 26)]) == [
        (0, 2), (4, 8), (22, 25), (26, 30)]
    assert spans.subtract([(0, 10)], []) == [(0, 10)]
    assert spans.subtract([(3, 5)], [(0, 10)]) == []


def test_prep_idle_is_the_overlap_of_the_idle_and_the_prep_spans(program):
    program([span("encode", 90, 160), span("encode.clip", 120, 130),  # 50 of (100, 150)
             span("prep.hint", 350, 380),                             # 30 of (300, 400)
             span("program.run", 300, 400), span("fetch", 100, 150),  # not preparation
             span("prep.noise", 2000, 3000)])                         # outside the segment
    assert read("prep_idle_ms_per_img", record()) == pytest.approx(80 / 1e6 / 2)


def test_a_gap_half_held_counts_half(program):
    program([span("prep.upload", 125, 200)])  # 25 of (100, 150), none of (300, 400)
    assert read("prep_idle_ms_per_img", record(images=1)) == pytest.approx(25 / 1e6)


def test_serve_means_and_the_worker_idle_share(program):
    program([span("serve.queue", 0, 10, 1), span("serve.queue", 100, 130, 2),
             span("serve.inflight", 10, 400, 1), span("serve.inflight", 130, 330, 2),
             span("serve.merge", 100, 120, 3),                    # 20 of (100, 150)
             span("serve.dispatch", 120, 160, 4),                 # 15 of (100, 150): its own
             span("encode", 130, 145, 5, parent=4),               # the encode's, not the worker's
             span("encode.clip", 132, 140, 6, parent=5),
             span("serve.wait", 300, 350, 7),                     # want of traffic
             span("serve.fetch", 350, 360, 8),                    # 4 of (300, 400): its own
             span("fetch", 352, 358, 9, parent=8)])
    rec = record()
    assert read("serve_queue_ms_per_req", rec) == pytest.approx(20 / 1e6)
    assert read("serve_inflight_ms_per_req", rec) == pytest.approx(295 / 1e6)
    assert read("serve_worker_idle_share", rec) == pytest.approx(100.0 * 39 / 1000)


NAMES = ("prep_idle_ms_per_img", "serve_queue_ms_per_req", "serve_inflight_ms_per_req",
         "serve_worker_idle_share")


def test_nothing_without_spans_a_trace_or_the_recorder(program, monkeypatch):
    rec = record()
    program([])
    assert all(read(name, rec) is None for name in NAMES)
    assert all(read(name, types.SimpleNamespace(trace=None)) is None for name in NAMES)
    program([span("serve.queue", 0, 10), span("serve.fetch", 0, 10), span("prep.noise", 0, 10)])
    rec = record(ops=[])  # no device operation: no idle time is read
    assert read("prep_idle_ms_per_img", rec) is None and read("serve_worker_idle_share", rec) is None
    assert read("serve_queue_ms_per_req", rec) == pytest.approx(10 / 1e6)
    monkeypatch.delattr(profiling, "spans")  # a program without the recorder
    rec = record()
    assert all(read(name, rec) is None for name in NAMES)
