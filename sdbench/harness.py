"""One run of one cell: set-up, the measured window, the traced segment, the
comparison with the reference, the metrics.

Everything a cell needs is found by name: the configuration's file
(``BENCHMARK.json`` names it), whose ``family`` names the module of all that
depends on the architecture (``families/<family>.py``), the traffic mix
``traffic/<mix>.json``, the cell's own settings ``workloads/<cell>.json``
(warm-up, the traced segment, how many requests the reference checks and the
limits of the numbers it compares), and one reader a metric,
``metrics/<metric>.py``.

The window is measured with nothing instrumented. A ``--trace 1`` run measures
the same window, then runs a traced segment of the same traffic (its device
operations from ``torch.profiler``) from which the device's metrics are read.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from sdbench import families, flops, sut, traffic
from sdbench import trace as trace_lib
from sdbench import weights as weights_lib

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "minsdtf_tpu")
LATE_S = 60.0  # how long past the window's close an open-loop request may take


def forbidden_modules(names) -> List[str]:
    """The loaded modules whose top-level name is one of ``FORBIDDEN``, compared
    whole (``minsdtf_tpu_torch`` is not ``minsdtf_tpu``)."""
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def latencies(due: List[float], done: List[Optional[float]]) -> np.ndarray:
    """Each request's seconds from its due time to its image; one that failed or
    never finished (``None``) is infinitely late."""
    return np.array([np.inf if d is None else d - u for u, d in zip(due, done)], np.float64)


def percentile(values: np.ndarray, q: float) -> float:
    """The ``q``-th percentile, linear between ranks; infinite where a missing
    request falls at or above it."""
    if not len(values):
        return float("nan")
    finite = np.sort(values)
    pos = (len(finite) - 1) * q / 100.0
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    if np.isinf(finite[hi]):
        return float("inf")
    return float(finite[lo] + (finite[hi] - finite[lo]) * (pos - lo))


class Record:
    """What a run measured, for the metric readers."""

    def __init__(self, cell: dict, cfg: dict, mix: dict, settings: dict):
        self.cell, self.cfg, self.mix, self.settings = cell, cfg, mix, settings
        self.setup_s = None
        self.window_s = None
        self.images = 0                 # closed loop: images completed in the window
        self.done_requests: List[traffic.Request] = []  # the window's requests that completed
        self.due: List[float] = []      # open loop: each request's due time (s)
        self.done: List[Optional[float]] = []
        self.late_s: List[float] = []   # open loop: how late each request was sent
        self.spans: List[sut.Span] = []  # open loop: the worker's calls in the window
        self.replays = None
        self.trace: Optional[trace_lib.Trace] = None
        self.traced_requests: List[traffic.Request] = []  # the traced segment's completed requests
        self.window_flops = None        # FLOPs of the window's completed requests
        self.peak_flops = None          # the card's peak for the configuration's dtype
        self.trace_attention_bound_s = None  # least time of the traced requests' long attentions

    def latencies(self) -> np.ndarray:
        return latencies(self.due, self.done)


def load_reader(name: str):
    spec = importlib.util.spec_from_file_location(f"sdbench_metric_{name}", HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


class Cell:
    """One cell's run on ``device``, from the parsed files."""

    def __init__(self, cell: dict, cfg: dict, mix: dict, settings: dict, seed: int, device="cuda",
                 compute_dtype: Optional[torch.dtype] = None, make_pipe: Optional[Callable] = None):
        self.rec = Record(cell, cfg, mix, settings)
        self.cfg, self.mix, self.settings, self.seed = cfg, mix, settings, int(seed)
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.family = families.load(cfg)
        # (cfg, weights, mix, device, merges, compute dtype) -> the system under test
        self.make_pipe = make_pipe or self.family.build_pipeline
        self.merges = str(ROOT / cfg["tokenizer"]["merges"])
        self.pipe = None
        self.outputs: Dict[tuple, np.ndarray] = {}  # (stream, index) -> uint8 (B, H, W, 3) images
        self.requests: Dict[tuple, traffic.Request] = {}

    # ---- set-up ----

    def setup(self, t_start: float) -> None:
        w = weights_lib.make(self.cfg, self.seed, self.device)
        self.pipe = self.make_pipe(self.cfg, w, self.mix, self.device, self.merges, self.compute_dtype)
        del w
        self._free()
        if self.mix["loop"] == "closed":
            for req in _take(traffic.closed(self.mix, self.seed, traffic.WARMUP), self.settings["warmup"]):
                self._call(req)
        else:
            self.proxy = sut.RecordingPipe(self.pipe)
            stream = traffic.closed(self.mix, self.seed, traffic.WARMUP)
            batch = self._worker().max_batch if self.settings.get("warmup", 1) else 0
            while batch >= 1:  # every batch size the worker cuts a merge to
                self._serve_burst(_take(stream, batch))
                batch //= 2
            self.worker = self._worker().start()
        self._sync()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        self.rec.setup_s = time.perf_counter() - t_start

    # ---- the system's calls ----

    def _call(self, req: traffic.Request) -> np.ndarray:
        """One closed-loop request: its uint8 (B, H, W, 3) images."""
        return self.pipe.text_to_image(req.prompt, batch_size=req.batch, num_steps=req.steps,
                                       unconditional_guidance_scale=req.guidance, guidance_rescale=req.rescale,
                                       seed=req.seed, control_net_image=req.control)

    def _payload(self, req: traffic.Request) -> dict:
        return {"prompt": req.prompt, "seed": req.seed, "steps": req.steps, "guidance_scale": req.guidance,
                "guidance_rescale": req.rescale}

    def _worker(self):
        from minsdtf_tpu_torch.tools.serve import BatchingWorker  # noqa: PLC0415

        return BatchingWorker(self.proxy)

    def _serve_burst(self, reqs) -> None:
        """``reqs`` queued on a new worker before it starts, so that it takes them
        as one merged call: each batch size's program is captured in set-up."""
        worker, errors = self._worker(), []

        def one(req):
            try:
                worker.submit(self._payload(req), timeout=600)
            except Exception as e:  # noqa: BLE001 - raised below
                errors.append(e)

        threads = [threading.Thread(target=one, args=(r,)) for r in reqs]
        for t in threads:
            t.start()
        deadline = time.perf_counter() + 60
        while worker.requests.qsize() < len(reqs) and time.perf_counter() < deadline:
            time.sleep(0.001)
        worker.start()
        for t in threads:
            t.join(timeout=600)
        worker.stop()
        if errors:
            raise errors[0]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _free(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _replays(self) -> Optional[int]:
        programs = getattr(self.pipe, "_programs", None)
        return None if programs is None else sum(p["replays"] for p in programs.stats()["each"])

    # ---- the window ----

    def closed_window(self, seconds: float, stream: int):
        """Requests back to back until ``seconds`` have passed; returns (images,
        seconds, requests): the window closes when the last image is on the host,
        and counts the images each call returned. The requests are drawn before it
        opens: ``seconds / min_s_per_img`` of them, and more as they are taken if
        the program ever runs through those."""
        n_drawn = int(seconds / self.settings["min_s_per_img"]) + 1
        drawn = _take(traffic.closed(self.mix, self.seed, stream), n_drawn)
        done = []
        t0 = time.perf_counter()
        images = 0
        while True:
            n = len(done)
            req = drawn[n] if n < n_drawn else traffic.request(self.mix, self.seed, stream, n)
            out = self._call(req)
            images += len(out)
            self.outputs[(stream, req.index)] = out
            self.requests[(stream, req.index)] = req
            done.append(req)
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        return images, time.perf_counter() - t0, done

    def open_window(self, seconds: float, stream: int, order_stream: Optional[int] = None):
        """Requests sent at their due times, each from a thread of its own that
        waits for its image; returns (due, done, late), all in seconds from the
        schedule's start. ``order_stream``: whose arrival order to take."""
        reqs = traffic.schedule(self.mix, self.seed, stream, seconds, order_stream)
        due = [r.due for r in reqs]
        done: List[Optional[float]] = [None] * len(reqs)
        late = [0.0] * len(reqs)
        t0 = time.perf_counter()
        close = t0 + seconds + LATE_S

        def client(i: int, req: traffic.Request):
            try:
                img = self.worker.submit(self._payload(req), timeout=max(1.0, close - time.perf_counter()))
            except Exception as e:  # noqa: BLE001 - a failed request is counted, not raised
                _log(f"request {stream}/{i} failed: {type(e).__name__}: {e}")
                return
            at = time.perf_counter() - t0
            self.outputs[(stream, req.index)] = np.asarray(img)
            self.requests[(stream, req.index)] = req
            done[i] = at  # last: a request marked done has its images

        threads = []
        for i, req in enumerate(reqs):
            wait = t0 + req.due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            late[i] = time.perf_counter() - t0 - req.due
            th = threading.Thread(target=client, args=(i, req), daemon=True)
            th.start()
            threads.append(th)
        for th in threads:
            th.join(timeout=max(0.0, close - time.perf_counter()))
        self._sync()
        return due, done, late

    def _completed(self, stream: int, done: List[Optional[float]]) -> List[traffic.Request]:
        """The open loop's requests of ``stream`` whose images came back."""
        return [self.requests[(stream, i)] for i, d in enumerate(done) if d is not None]

    def window(self, seconds: float) -> None:
        rec = self.rec
        if self.mix["loop"] == "closed":
            before = self._replays()
            rec.images, rec.window_s, rec.done_requests = self.closed_window(seconds, traffic.WINDOW)
            rec.replays = None if before is None else self._replays() - before
        else:
            self.proxy.recording = True
            rec.due, rec.done, rec.late_s = self.open_window(seconds, traffic.WINDOW)
            self.proxy.recording = False
            rec.spans = list(self.proxy.spans)
            rec.window_s = seconds
            rec.done_requests = self._completed(traffic.WINDOW, rec.done)

    def traced(self) -> None:
        """The traced segment: ``trace.images`` more requests back to back, or
        ``trace.seconds`` more of the open loop."""
        spec = self.settings["trace"]
        if self.mix["loop"] == "closed":
            reqs = _take(traffic.closed(self.mix, self.seed, traffic.TRACED), spec["images"])

            def segment(spans):
                images = 0
                for req in reqs:
                    a = time.time_ns()
                    images += len(self._call(req))
                    spans.append(("text_to_image", a, time.time_ns()))
                self.rec.traced_requests = reqs
                return images
        else:
            def segment(spans):
                self.proxy.spans, self.proxy.recording = [], True
                _, done, _ = self.open_window(spec["seconds"], traffic.TRACED)
                self.proxy.recording = False
                spans += [(s.name, s.t0, s.t1) for s in self.proxy.spans]
                self.rec.traced_requests = self._completed(traffic.TRACED, done)
                return sum(r.batch for r in self.rec.traced_requests)
        outside = "harness between calls" if self.mix["loop"] == "closed" else "worker: queue wait or fetch"
        self.rec.trace = trace_lib.record(segment, outside)

    def teardown(self) -> None:
        if getattr(self, "worker", None) is not None:
            self.worker.stop()
            self.worker = self.proxy = None
        self.pipe = None
        self._free()

    # ---- correctness ----

    def compare(self) -> Dict[str, float]:
        """The images of a sample of the window's requests, drawn from the seed,
        against the reference's images of the same requests (every image of a
        batch): the worst image's mean absolute difference in uint8 levels."""
        keys = sorted(k for k in self.outputs if k[0] == traffic.WINDOW)
        n = min(self.settings["compare"], len(keys))
        rng = np.random.default_rng([self.seed % 2**64, 4])
        sample = [keys[i] for i in sorted(rng.choice(len(keys), n, replace=False))]
        ref = reference(self.cfg, self.seed, self.merges, self.device)
        gaps = []
        for key in sample:
            want, got = ref.request(self.requests[key], self.mix), self.outputs[key]
            if got.shape != want.shape:
                raise ValueError(f"request {key}: images of shape {got.shape}, the reference's {want.shape}")
            gaps += [float(np.abs(g.astype(np.int32) - w.astype(np.int32)).mean()) for g, w in zip(got, want)]
        _log("compared", len(gaps), "requests, mean abs gap in levels:", " ".join(f"{g:.4f}" for g in gaps))
        return {"image_mae_max": max(gaps) if gaps else float("inf")}


def reference(cfg: dict, seed: int, merges: str, device, ops=None):
    """The fp32 reference of ``cfg``'s family on ``device`` with the weights of
    ``seed`` made anew, products in full fp32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w = weights_lib.make(cfg, seed, device)
    return families.load(cfg).Reference(cfg, w, merges, device, ops)


def _take(it, n: int) -> list:
    return [next(it) for _ in range(n)]


def run(cell: dict, cfg: dict, mix: dict, settings: dict, metrics: List[dict], seed: int, seconds: float,
        trace: bool, t_start: float, device="cuda", compute_dtype: Optional[torch.dtype] = None,
        make_pipe: Optional[Callable] = None) -> dict:
    """One run; returns the result line's object. ``make_pipe`` puts another
    system in the program's place (the control)."""
    c = Cell(cell, cfg, mix, settings, seed, device, compute_dtype, make_pipe)
    rec = c.rec
    c.setup(t_start)
    _log(f"set-up {rec.setup_s:.3f} s")
    c.window(seconds)
    if trace:
        c.traced()
    dev = torch.device(device)
    # the caching allocator's peak: weights, the step programs' pool and activations
    peak_bytes = torch.cuda.max_memory_reserved() if dev.type == "cuda" else 0
    if rec.mix["loop"] == "closed":
        attempted, failed = rec.images, 0
    else:
        attempted, failed = len(rec.due), sum(d is None for d in rec.done)
        _log(f"open loop: {attempted} due, {failed} failed, latest send {max(rec.late_s):.4f} s late")
    c.teardown()
    checks = c.compare()
    name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    rec.window_flops = sum(c.family.request_flops(cfg, mix, r) for r in rec.done_requests)
    if dev.type == "cuda":  # a share of the card's peak is read on the card only
        peak = flops.peaks(name)
        rec.peak_flops = flops.peak_flops(peak, cfg["dtype"])
        if rec.peak_flops is not None:
            rec.trace_attention_bound_s = sum(flops.request_attention_bound_s(cfg, mix, peak, r)
                                              for r in rec.traced_requests)
    values = {}
    for m in metrics:
        value = load_reader(m["name"])(rec)
        if value is not None and np.isfinite(value):
            values[m["name"]] = {"value": float(value), "unit": m["unit"]}
    limits = settings["limits"]
    checked = {k: {"value": v, "limit": limits[k]} for k, v in checks.items()}
    correct = failed == 0 and attempted > 0 and all(v <= limits[k] for k, v in checks.items())
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": name,
                   "count": 1, "memory_peak_bytes": int(peak_bytes)}
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed), "metrics": values,
           "device": device_info}
    if trace and rec.trace is not None:
        device_info["busy_s"] = rec.trace.busy_s()
        device_info["window_s"] = rec.trace.window_s
        out["breakdown"] = rec.trace.breakdown()
    for k, v in checked.items():
        _log(f"check {k} {v['value']} limit {v['limit']}")
    out["checks"] = checked
    return out
