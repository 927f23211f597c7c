"""The port's host spans (``profiling.span``, ``mark``, ``spans``) on the CPU: they
record only under a ``torch.profiler`` profile, from any thread, on the profiler's
clock, nested, in a bounded ring, and into ``profiling.trace``'s Chrome trace; and
the pipeline's and the serving worker's spans at their boundaries."""

import collections
import json
import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from minsdtf_tpu_torch import StableDiffusion, profiling
from minsdtf_tpu_torch.models import clip as tclip
from minsdtf_tpu_torch.models import controlnet as tcontrolnet
from minsdtf_tpu_torch.models import unet as tunet
from minsdtf_tpu_torch.models import vae as tvae
from minsdtf_tpu_torch.models.common import build
from minsdtf_tpu_torch.tools import serve as serve_mod
from test_torch_serve import FakePipe
from torch_port_utils import UNET, VAE_DEC, edge_image, one_torch_thread, write_merges  # noqa: F401

A = torch.randn(128, 128)


@pytest.fixture(autouse=True)
def empty_ring():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def profiled(fn):
    """The spans recorded while ``fn()`` runs under a CPU profile, and the profile."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.time_ns()
        fn()
        t1 = time.time_ns()
    return profiling.spans(t0, t1), prof


def test_nothing_records_without_a_profiler():
    with profiling.span("a", n=1) as s:
        s.n = 2
    profiling.mark("b", 0, time.time_ns())
    assert profiling.spans() == []


@pytest.mark.parametrize("where", ["main", "thread started before"])
def test_spans_record_under_a_profile(where):
    def work():
        with profiling.span("work", n=2, req=(5,)):
            torch.mm(A, A)
        return threading.get_native_id()

    if where == "main":
        got, _ = profiled(work)
        tid = threading.get_native_id()
    else:
        go, ids = threading.Event(), []
        thread = threading.Thread(target=lambda: (go.wait(), ids.append(work())))
        thread.start()

        def run():
            go.set()
            thread.join()

        got, _ = profiled(run)
        tid = ids[0]
    [s] = got
    assert (s.name, s.n, s.req, s.parent, s.thread) == ("work", 2, (5,), None, tid)
    assert s.t0_ns < s.t1_ns


def test_a_span_brackets_the_profiler_event_it_wraps():
    def work():
        with profiling.span("mm"):
            torch.mm(A, A)

    [s], prof = profiled(work)
    [ev] = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert s.t0_ns <= ev.start_ns() and ev.start_ns() + ev.duration_ns() <= s.t1_ns


def test_parents_nest_and_an_exception_closes_its_span():
    def work():
        with profiling.span("outer"):
            with profiling.span("inner"):
                pass
            with pytest.raises(ValueError):
                with profiling.span("raises"):
                    raise ValueError("inside")
        with profiling.span("after"):
            pass

    got, _ = profiled(work)
    by = {s.name: s for s in got}
    assert set(by) == {"outer", "inner", "raises", "after"}
    assert by["inner"].parent == by["outer"].id == by["raises"].parent
    assert by["outer"].parent is None and by["after"].parent is None
    assert by["outer"].t0_ns <= by["raises"].t0_ns <= by["raises"].t1_ns <= by["outer"].t1_ns


def test_threads_record_every_span_under_its_own_parent():
    """More threads than cores, switching often: every span is kept once, with an id
    of its own and its own thread's parent."""
    n_threads, each = 16, 500

    def worker():
        for _ in range(each):
            with profiling.span("outer"):
                with profiling.span("inner"):
                    pass

    def run():
        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads)

    got, _ = profiled(run)
    assert len(got) == 2 * n_threads * each and len({s.id for s in got}) == len(got)
    outer = {s.id: s for s in got if s.name == "outer"}
    inner = [s for s in got if s.name == "inner"]
    assert all(s.parent is None for s in outer.values())
    assert all(outer[s.parent].thread == s.thread and outer[s.parent].t0_ns <= s.t0_ns for s in inner)


def test_the_ring_keeps_the_newest_spans(monkeypatch):
    monkeypatch.setattr(profiling, "_ring", collections.deque(maxlen=4))

    def work():
        for i in range(10):
            with profiling.span(f"s{i}"):
                pass

    got, _ = profiled(work)
    assert [s.name for s in got] == ["s6", "s7", "s8", "s9"]


def test_a_mark_and_the_interval_of_spans():
    def work():
        profiling.mark("queued", 100, 200, n=1, req=7)

    profiled(work)
    [m] = profiling.spans(150, 160)
    assert (m.name, m.t0_ns, m.t1_ns, m.n, m.req, m.parent) == ("queued", 100, 200, 1, 7, None)
    assert profiling.spans(201, None) == [] and profiling.spans(None, 99) == []
    assert profiling.spans(200, 200) == [m]


def test_trace_writes_the_spans_beside_the_operations(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.span("mm", n=1):
            t = time.time_ns()
            torch.mm(A, A)
        profiling.mark("queued", t, time.time_ns(), req=3)  # starts inside "mm", ends after
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    [op] = [e for e in events if e.get("name") == "aten::mm"]
    [mm] = [e for e in events if e.get("cat") == "span" and e["name"] == "mm"]
    assert mm["ph"] == "X" and mm["args"]["n"] == 1
    assert mm["ts"] <= op["ts"] and op["ts"] + op["dur"] <= mm["ts"] + mm["dur"]
    queued = [e for e in events if e.get("cat") == "span" and e["name"] == "queued"]
    assert sorted(e["ph"] for e in queued) == ["b", "e"]  # overlaps "mm": an async pair
    assert any(e.get("ph") == "M" and str(e.get("args", {}).get("name")).startswith("spans: ")
               for e in events)


@pytest.fixture(scope="module")
def pipe(tmp_path_factory):
    """A 64px fp32 pipeline on the CPU at the small widths of the ControlNet
    pipeline's tests, random weights."""
    bpe = write_merges(tmp_path_factory.mktemp("bpe") / "merges.txt.gz")
    p = StableDiffusion(64, 64, bpe_path=bpe, compute_dtype=torch.float32, device="cpu")
    p._unet = build(lambda: tunet.UNet(**UNET), "cpu", 0)
    p._decoder = build(lambda: tvae.VAEDecoder(VAE_DEC), "cpu", 2)
    p._text_model = build(tclip.CLIPTextModel, "cpu", 1)
    p._controlnet = build(lambda: tcontrolnet.ControlNet(**UNET), "cpu", 3)
    return p


def test_text_to_image_records_its_boundaries(pipe):
    got, _ = profiled(lambda: pipe.text_to_image("hello world", num_steps=2, seed=3))
    by = collections.defaultdict(list)
    for s in got:
        by[s.name].append(s)
    assert {"encode", "encode.clip", "prep.noise", "prep.schedule", "prep.upload", "program.run",
            "fetch"} <= set(by)
    assert "prep.hint" not in by and "prep.reference" not in by
    [encode] = by["encode"]
    assert encode.n == 1 and all(c.parent == encode.id for c in by["encode.clip"])
    [run] = by["program.run"]
    assert run.n == 1
    [fetch] = by["fetch"]
    assert encode.t1_ns <= by["prep.noise"][0].t0_ns <= run.t0_ns <= run.t1_ns <= fetch.t0_ns
    pipe._encode_text_dev("hello world")  # cached now that the unconditional row is set
    again, _ = profiled(lambda: pipe._encode_text_dev("hello world"))
    assert [(s.name, s.n) for s in again] == [("encode", 0)]  # the prompt cache's hit


def test_the_controlnet_path_records_prep_hint(pipe):
    got, _ = profiled(lambda: pipe.text_to_image("hello world", num_steps=2, seed=3,
                                                 control_net_image=edge_image(48, 40)))
    [hint] = [s for s in got if s.name == "prep.hint"]
    [run] = [s for s in got if s.name == "program.run"]
    assert hint.n == 1 and hint.t1_ns <= run.t0_ns


def test_worker_records_queue_and_inflight_per_request():
    worker = serve_mod.BatchingWorker(FakePipe(delay=0.01), pipeline_depth=2).start()
    walls = []

    def serve_three():
        for i in range(3):
            t0 = time.time_ns()
            worker.submit({"prompt": "a cat", "seed": i, "steps": 4})
            walls.append((t0, time.time_ns()))

    try:
        got, _ = profiled(serve_three)
    finally:
        worker.stop()
    queue = sorted((s for s in got if s.name == "serve.queue"), key=lambda s: s.req)
    inflight = sorted((s for s in got if s.name == "serve.inflight"), key=lambda s: s.req)
    assert len(queue) == len(inflight) == 3
    assert len({s.req for s in queue}) == 3
    for q, f, (t0, t1) in zip(queue, inflight, walls):
        assert q.req == f.req and q.t1_ns == f.t0_ns  # the dispatch starts its flight
        assert t0 <= q.t0_ns and f.t1_ns <= t1
        assert (q.t1_ns - q.t0_ns) + (f.t1_ns - f.t0_ns) <= t1 - t0
    dispatch = [s for s in got if s.name == "serve.dispatch"]
    fetch = [s for s in got if s.name == "serve.fetch"]
    assert sorted(s.req for s in dispatch) == sorted(s.req for s in fetch) == [(q.req,) for q in queue]
    assert all(s.n == 1 for s in dispatch + fetch)
    assert any(s.name == "serve.wait" for s in got)
