"""Batching HTTP serving daemon over the queued-dispatch pipeline, on the card.

A request queue feeds the card through ``generate_image(..., _defer_fetch=True)``:
the host prepares and queues request *i + 1* while the card computes request *i*.
The card runs one stream, so fetching *i*'s image waits for every kernel queued
before the fetch, *i + 1*'s included.

Design (one card = one worker; standard library only):

  - ``ThreadingHTTPServer`` accepts requests and puts them on a ``queue.Queue``;
    each handler blocks on its own response slot.
  - a single worker thread, the only thread that touches the card, pulls
    requests, dispatches them without fetching, and keeps a deque of
    ``pipeline_depth`` in-flight handles; request *i*'s image is fetched once
    *i + 1* is queued. The handlers only decode JSON and queue, so no upload or
    allocation on the card runs beside a capture of the sampler's step program
    (which the worker makes at a batch size's first request); the capture's
    ``thread_local`` error mode would let another thread's card work pass too.
  - concurrently queued requests with matching (steps, guidance, rescale,
    negative prompt) MERGE into one batched call of up to ``max_batch``:
    contexts stack on the sampler's batch axis, and each request's seed makes its
    own initial-noise row, equal to the noise of that request's batch-1 run. The
    merged call runs the UNet and the VAE decoder at another batch size, where
    the library's GEMMs and convolutions and K2's split of the keys may sum in
    another order: merging changes wall time and pixels. On an H100 in bf16
    (512x512, 25 steps) a merged request's image differed from its batch-1
    image in nearly every pixel, by up to 21 of 255; in fp32 by at most 1
    (PERF.md).
  - requests carry either a ``prompt`` (tokenized through the pipeline's BPE) or a
    precomputed ``context`` (base64 fp32), which needs no vocabulary.
  - while a ``torch.profiler`` profile runs, the worker records host spans
    (:mod:`minsdtf_tpu_torch.profiling`): ``serve.wait`` (blocked on an empty
    queue), ``serve.merge`` (the merge window), ``serve.dispatch`` and
    ``serve.fetch`` (with the images and the request ids), and for each request
    ``serve.queue`` (enqueue to its call's dispatch) and ``serve.inflight``
    (dispatch to its image handed back), under the request's id.

Endpoints:
  POST /generate  {"prompt": str | "context": b64, "context_shape"?,
                   "negative_prompt"?, "steps"?, "seed"?, "guidance_scale"?,
                   "guidance_rescale"?}
                  -> {"image": base64 PNG (or .npy bytes without PIL), "format",
                      "shape"}
  GET  /healthz   -> {"ok": true, "queue_depth": n}
  GET  /stats     -> {"served": n, "avg_latency_s": ..., "merged_batches": n}

Run: ``python -m minsdtf_tpu_torch.tools.serve --port 8000 [--bpe PATH] [--device cuda]``.
"""

from __future__ import annotations

import base64
import io
import itertools
import json
import queue
import sys
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from minsdtf_tpu_torch import profiling
from minsdtf_tpu_torch import rng as rng_lib
from minsdtf_tpu_torch.pipeline import fetch, to_device


class _Request:
    """One queued request: its id and its enqueue time on the spans' clock
    (``time.time_ns()``, which the served latency is read from too) name it in the
    worker's spans."""

    __slots__ = ("payload", "event", "result", "error", "id", "t_ns", "t_dispatch_ns")
    _ids = itertools.count()

    def __init__(self, payload: dict):
        self.payload = payload
        self.event = threading.Event()
        self.result = None
        self.error: Optional[str] = None
        self.id = next(self._ids)
        self.t_ns = time.time_ns()
        self.t_dispatch_ns = None


class BatchingWorker:
    """Pulls requests off a queue, keeps ``pipeline_depth`` generations in flight,
    and merges concurrently queued compatible requests into one batched call:
    contexts stack on the sampler's batch axis, and each request's seed makes a
    noise row equal to its own batch-1 noise.

    ``pipe`` needs the ``generate_image``/``encode_text`` surface of
    :class:`minsdtf_tpu_torch.pipeline.StableDiffusion`; tests inject a fake whose
    handles :func:`minsdtf_tpu_torch.pipeline.fetch` turns into numpy. Merging
    also needs ``img_height``/``img_width`` (the noise rows): a pipe without them
    is served one request at a time."""

    #: payload fields that must match for two requests to share one call
    _MERGE_FIELDS = ("steps", "guidance_scale", "guidance_rescale", "negative_prompt")

    def __init__(self, pipe, pipeline_depth: int = 2, max_queue: int = 64,
                 max_batch: int = 8, merge_window_s: float = 0.05):
        self.pipe = pipe
        self.depth = max(1, int(pipeline_depth))
        self.max_batch = max(1, int(max_batch))
        # Near-simultaneous HTTP arrivals land 1-20 ms apart (thread scheduling), so
        # draining the queue at once splits a burst into small batches; waiting up
        # to 50 ms to close a batch is short against a generation of seconds.
        self.merge_window_s = float(merge_window_s)
        self.can_merge = (
            self.max_batch > 1
            and getattr(pipe, "img_height", None) is not None
            and getattr(pipe, "img_width", None) is not None
        )
        self.requests: "queue.Queue[_Request]" = queue.Queue(maxsize=max_queue)
        self.inflight: deque = deque()
        self._pending: deque = deque()  # requests deferred by merge incompatibility
        self.served = 0
        self.merged_batches = 0
        self.total_latency = 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=30)

    def submit(self, payload: dict, timeout: float = 300.0):
        # A negative_prompt must be tokenized; a context-only deployment may run
        # without a BPE vocabulary, and the request would otherwise fail inside the
        # worker with a tokenizer error after queueing.
        if payload.get("negative_prompt") and hasattr(self.pipe, "bpe_path") \
                and not getattr(self.pipe, "bpe_path"):
            raise ValueError(
                "negative_prompt requires a tokenizer, but this server's "
                "pipeline has no BPE vocabulary (bpe_path unset) — supply "
                "bpe_path at server start or omit negative_prompt")
        req = _Request(payload)
        self.requests.put(req, timeout=5.0)
        if not req.event.wait(timeout):
            raise TimeoutError("generation timed out")
        if req.error:
            raise RuntimeError(req.error)
        return req.result

    # ---- worker internals --------------------------------------------------------

    def _context_of(self, p: dict):
        if "context" in p:
            return np.frombuffer(
                base64.b64decode(p["context"]), dtype=np.float32
            ).reshape(p.get("context_shape", (77, 768))).copy()
        # the context stays on the device (no copy to the host) where the pipeline
        # has the cached encode; fakes in tests only implement encode_text
        enc = getattr(self.pipe, "_encode_text_dev", self.pipe.encode_text)
        return enc(p["prompt"])

    def _dispatch(self, req: _Request):
        p = req.payload
        return self.pipe.generate_image(
            self._context_of(p),
            negative_prompt=p.get("negative_prompt"),
            num_steps=int(p.get("steps", 25)),
            unconditional_guidance_scale=float(p.get("guidance_scale", 7.5)),
            guidance_rescale=float(p.get("guidance_rescale", 0.7)),
            seed=p.get("seed"),
            _defer_fetch=True,
        )

    def _dispatch_merged(self, reqs):
        """One batched call for each context length among ``len(reqs)`` compatible
        requests: contexts stack on the batch axis on the pipeline's device, and
        each request's seed makes its own initial-noise row with the TF-Philox
        host generator, equal to the noise of that request's batch-1 run."""
        p0 = reqs[0].payload
        device = torch.device(getattr(self.pipe, "device", "cpu"))
        groups: dict = {}
        for r in reqs:
            c = to_device(self._context_of(r.payload), device, torch.float32)
            c = c[None] if c.dim() == 2 else c
            groups.setdefault(c.shape[1], []).append((r, c))
        h8 = self.pipe.img_height // 8
        w8 = self.pipe.img_width // 8
        out = []
        for pairs in groups.values():
            grp = [r for r, _ in pairs]
            noise = np.concatenate([
                rng_lib.stateless_normal(
                    (1, h8, w8, 4),
                    r.payload.get("seed") if r.payload.get("seed") is not None
                    else int(np.random.randint(0, 2**31 - 1)))
                for r in grp], axis=0)
            handle = self.pipe.generate_image(
                torch.cat([c for _, c in pairs]),
                batch_size=len(grp),
                diffusion_noise=noise,
                negative_prompt=p0.get("negative_prompt"),
                num_steps=int(p0.get("steps", 25)),
                unconditional_guidance_scale=float(p0.get("guidance_scale", 7.5)),
                guidance_rescale=float(p0.get("guidance_rescale", 0.7)),
                _defer_fetch=True,
            )
            if len(grp) > 1:
                self.merged_batches += 1
            out.append((grp, handle))
        return out

    def _finish(self, reqs, handle):
        try:
            with profiling.span("serve.fetch", n=len(reqs), req=reqs):
                arr = fetch(handle)  # waits for the card's queue up to here
            now_ns = time.time_ns()
            for i, req in enumerate(reqs):
                req.result = arr[i : i + 1] if len(reqs) > 1 else arr
                self.served += 1
                self.total_latency += (now_ns - req.t_ns) / 1e9
        except Exception as e:  # a device failure fails these requests, not the worker
            for req in reqs:
                req.error = f"{type(e).__name__}: {e}"
        finally:
            if profiling.recording():
                done_ns = time.time_ns()
                for req in reqs:
                    profiling.mark("serve.inflight", req.t_dispatch_ns, done_ns, req=req.id)
            for req in reqs:
                req.event.set()

    def _merge_key(self, p: dict):
        return tuple(p.get(k) for k in self._MERGE_FIELDS)

    def _next_batch(self):
        """Pop the oldest request plus every queued request compatible with it
        (up to ``max_batch``); incompatible ones stay pending in arrival order."""
        try:
            with profiling.span("serve.wait"):
                self._pending.append(self.requests.get(timeout=0.1))
            while True:
                self._pending.append(self.requests.get_nowait())
        except queue.Empty:
            pass
        if not self._pending:
            return []
        if self.can_merge and len(self._pending) < self.max_batch:
            # accumulation window: a burst's stragglers arrive ms after its head
            with profiling.span("serve.merge"):
                deadline = time.perf_counter() + self.merge_window_s
                while len(self._pending) < self.max_batch:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    try:
                        self._pending.append(self.requests.get(timeout=remaining))
                    except queue.Empty:
                        break
        first = self._pending.popleft()
        if not self.can_merge:
            return [first]
        batch, keep = [first], deque()
        key = self._merge_key(first.payload)
        while self._pending and len(batch) < self.max_batch:
            r = self._pending.popleft()
            (batch if self._merge_key(r.payload) == key else keep).append(r)
        keep.extend(self._pending)
        self._pending = keep
        # Batch sizes are cut to a power of two ({1, 2, 4, 8}): the kernels are
        # checked on the card at those batch shapes. The overflow goes back to the
        # front of pending, in order, to lead the next batch.
        take = 1 << (len(batch).bit_length() - 1)
        if take < len(batch):
            for r in reversed(batch[take:]):
                self._pending.appendleft(r)
            batch = batch[:take]
        return batch

    def _run(self):
        while not self._stop.is_set():
            batch = self._next_batch()
            if not batch:
                # drain in-flight work while idle
                while self.inflight:
                    self._finish(*self.inflight.popleft())
                continue
            t_ns = time.time_ns()
            for req in batch:
                req.t_dispatch_ns = t_ns
            if profiling.recording():
                for req in batch:
                    profiling.mark("serve.queue", req.t_ns, t_ns, req=req.id)
            try:
                with profiling.span("serve.dispatch", n=len(batch), req=batch):
                    if len(batch) > 1:
                        dispatched = self._dispatch_merged(batch)
                    else:
                        dispatched = [([batch[0]], self._dispatch(batch[0]))]
            except Exception as e:  # a bad request fails itself, not the worker
                for req in batch:
                    req.error = f"{type(e).__name__}: {e}"
                    req.event.set()
                continue
            self.inflight.extend(dispatched)
            while len(self.inflight) >= self.depth:
                self._finish(*self.inflight.popleft())
        while self.inflight:
            self._finish(*self.inflight.popleft())


def _encode_image(arr: np.ndarray) -> dict:
    """PNG where PIL is installed, else raw .npy bytes; both base64."""
    arr = np.asarray(arr)
    if arr.ndim == 4 and arr.shape[0] == 1:
        arr = arr[0]
    buf = io.BytesIO()
    try:
        from PIL import Image
    except ImportError:
        np.save(buf, arr)
        fmt = "npy"
    else:
        # compress_level=1, zlib's fastest: the encode runs on the host in every
        # request's reply path
        Image.fromarray(arr).save(buf, format="PNG", compress_level=1)
        fmt = "png"
    return {"image": base64.b64encode(buf.getvalue()).decode(), "format": fmt,
            "shape": list(arr.shape)}


def decode_image(reply: dict) -> np.ndarray:
    """The uint8 (H, W, 3) image of a ``/generate`` reply."""
    data = base64.b64decode(reply["image"])
    if reply["format"] == "npy":
        return np.load(io.BytesIO(data))
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)))


def make_handler(worker: BatchingWorker):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _reply(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"ok": True, "queue_depth": worker.requests.qsize()})
            elif self.path == "/stats":
                avg = worker.total_latency / worker.served if worker.served else None
                self._reply(200, {"served": worker.served, "avg_latency_s": avg,
                                  "merged_batches": worker.merged_batches})
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/generate":
                self._reply(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                if "prompt" not in payload and "context" not in payload:
                    self._reply(400, {"error": "need `prompt` or `context`"})
                    return
                img = worker.submit(payload)
                self._reply(200, _encode_image(img))
            except ValueError as e:  # request-shaped errors are the client's
                self._reply(400, {"error": str(e)})
            except Exception as e:  # the server keeps serving other requests
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(pipe, host: str = "127.0.0.1", port: int = 8000, pipeline_depth: int = 2,
          max_batch: int = 8, merge_window_s: float = 0.05):
    """Start the worker and bind the HTTP server; returns (server, worker), and the
    caller runs ``server.serve_forever()``. ``port=0`` binds a free port
    (``server.server_address[1]``)."""
    worker = BatchingWorker(pipe, pipeline_depth=pipeline_depth,
                            max_batch=max_batch,
                            merge_window_s=merge_window_s).start()
    server = ThreadingHTTPServer((host, port), make_handler(worker))
    return server, worker


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--max-batch", type=int, default=8,
                    help="merge up to N concurrently queued compatible requests "
                         "into one batched call (1 disables)")
    ap.add_argument("--bpe", default=None, help="CLIP merges file (for `prompt` requests)")
    ap.add_argument("--int8", action="store_true", help="serve with W8A8 weights")
    ap.add_argument("--int8-hybrid", default=None, metavar="SCALES_NPZ",
                    help="serve with stable-site-only int8 (weights/quantize."
                         "hybridize_params); pass the calibrated act-scale .npz "
                         "from StableDiffusion.calibrate_int8(save_path=...)")
    ap.add_argument("--scheduler", default=None,
                    choices=["ddim", "euler", "euler_a", "tcd", "lcm", "dpm", "dpm_karras"],
                    help="sampler (dpm = DPM-Solver++(2M), ~15 steps for "
                         "DDIM-25 quality)")
    ap.add_argument("--unet", default=None)
    ap.add_argument("--text-encoder", default=None)
    ap.add_argument("--vae", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from minsdtf_tpu_torch import kernels
    from minsdtf_tpu_torch.pipeline import StableDiffusion

    pipe = StableDiffusion(
        img_height=args.size, img_width=args.size, bpe_path=args.bpe,
        unet_ckpt=args.unet, text_encoder_ckpt=args.text_encoder, vae_ckpt=args.vae,
        weight_dtype="int8_hybrid" if args.int8_hybrid else ("int8" if args.int8 else None),
        int8_act_scales=args.int8_hybrid,
        scheduler_type=args.scheduler, device=args.device,
    )
    if pipe.device.type == "cuda":
        kernels.build()  # nvcc runs here, never inside a request
    if args.bpe:
        pipe.warm_text()
    server, worker = serve(pipe, args.host, args.port, args.depth,
                           max_batch=args.max_batch)
    print(f"serving on http://{args.host}:{server.server_address[1]} "
          f"(depth {worker.depth}, {pipe.device})", file=sys.stderr)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        worker.stop()


if __name__ == "__main__":
    main()
