"""The port's serving daemon: the batching worker's queueing and merging and the HTTP
surface, driven by fakes whose handles go through ``pipeline.fetch`` (the HTTP
server binds localhost only); the merged noise rows against both packages'
batch-1 noise; and the port's worker over a small port pipeline against the JAX
worker over the same JAX pipeline, fp32 on the CPU."""

import base64
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from minsdtf_tpu import rng as jrng
from minsdtf_tpu.tools import serve as jserve
from minsdtf_tpu_torch import rng as trng
from minsdtf_tpu_torch.tools import serve as serve_mod
from torch_port_utils import make_pipelines, one_torch_thread, write_merges  # noqa: F401


class FakeHandle:
    """A device result's stand-in: ``fetch`` turns it into numpy after a tiny
    'compute'."""

    def __init__(self, seed, delay=0.0):
        self.seed = seed
        self.delay = delay

    def __array__(self, dtype=None, copy=None):
        if self.delay:
            time.sleep(self.delay)
        rs = np.random.RandomState(self.seed or 0)
        return rs.randint(0, 255, (1, 8, 8, 3)).astype(np.uint8)


class FakePipe:
    def __init__(self, delay=0.0):
        self.delay = delay
        self.dispatched = []
        self.lock = threading.Lock()

    def encode_text(self, prompt):
        return np.zeros((77, 768), np.float32) + (len(prompt) % 7)

    def generate_image(self, ctx, _defer_fetch=False, seed=None, **kw):
        assert _defer_fetch
        with self.lock:
            self.dispatched.append((seed, kw.get("num_steps")))
        return FakeHandle(seed, self.delay)


def test_worker_serves_and_pipelines():
    pipe = FakePipe()
    worker = serve_mod.BatchingWorker(pipe, pipeline_depth=2).start()
    try:
        outs = [worker.submit({"prompt": "a cat", "seed": i, "steps": 4}) for i in range(5)]
        assert all(o.shape == (1, 8, 8, 3) for o in outs)
        assert worker.served == 5
        assert [s for s, _ in pipe.dispatched] == [0, 1, 2, 3, 4]
        assert all(n == 4 for _, n in pipe.dispatched)
    finally:
        worker.stop()


def test_worker_propagates_errors():
    class BadPipe(FakePipe):
        def generate_image(self, *a, **kw):
            raise ValueError("boom")

    worker = serve_mod.BatchingWorker(BadPipe(), pipeline_depth=2).start()
    try:
        with pytest.raises(RuntimeError, match="boom"):
            worker.submit({"prompt": "x"})
    finally:
        worker.stop()


def test_negative_prompt_without_tokenizer_fails_loud():
    """A context-only deployment (no BPE vocabulary) rejects a negative_prompt at
    enqueue with a clear error."""
    pipe = FakePipe()
    pipe.bpe_path = None  # as StableDiffusion(bpe_path=None)
    worker = serve_mod.BatchingWorker(pipe, pipeline_depth=1).start()
    try:
        ctx = base64.b64encode(np.zeros((77, 768), np.float32).tobytes()).decode()
        with pytest.raises(ValueError, match="negative_prompt requires"):
            worker.submit({"context": ctx, "negative_prompt": "blurry"})
        assert worker.submit({"context": ctx}).shape == (1, 8, 8, 3)
    finally:
        worker.stop()


def test_context_payload_bypasses_tokenizer():
    pipe = FakePipe()
    worker = serve_mod.BatchingWorker(pipe, pipeline_depth=1).start()
    try:
        ctx = np.random.RandomState(0).randn(77, 768).astype(np.float32)
        out = worker.submit({"context": base64.b64encode(ctx.tobytes()).decode(), "seed": 9})
        assert out.shape == (1, 8, 8, 3)
    finally:
        worker.stop()


@pytest.fixture()
def http_server():
    pipe = FakePipe()
    server, worker = serve_mod.serve(pipe, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server, worker, pipe
    server.shutdown()
    server.server_close()
    worker.stop()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _post(port, path, obj):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:  # non-2xx still carries a JSON body
        return e.code, json.loads(e.read())


def test_http_generate_and_stats(http_server):
    server, worker, pipe = http_server
    port = server.server_address[1]
    status, out = _post(port, "/generate", {"prompt": "a dog", "seed": 3})
    assert status == 200 and out["format"] in ("png", "npy")
    assert out["shape"] == [8, 8, 3]
    want = np.asarray(FakeHandle(3))[0]
    assert np.array_equal(serve_mod.decode_image(out), want)

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
        assert json.loads(r.read())["ok"] is True
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=10) as r:
        stats = json.loads(r.read())
    assert stats["served"] == 1 and stats["avg_latency_s"] > 0


def test_reply_is_npy_without_pil(monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    img = np.arange(2 * 3 * 3, dtype=np.uint8).reshape(1, 2, 3, 3)
    reply = serve_mod._encode_image(img)
    assert reply["format"] == "npy" and reply["shape"] == [2, 3, 3]
    assert np.array_equal(serve_mod.decode_image(reply), img[0])


def test_http_rejects_bad_request(http_server):
    server, _, _ = http_server
    status, out = _post(server.server_address[1], "/generate", {"no_prompt": 1})
    assert status == 400


def test_concurrent_http_requests_pipeline(http_server):
    """Concurrent clients: all served, dispatch overlap kept."""
    server, worker, pipe = http_server
    port = server.server_address[1]
    pipe.delay = 0.02
    results = []

    def client(i):
        results.append(_post(port, "/generate", {"prompt": f"p{i}", "seed": i})[0])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert results == [200] * 6
    assert worker.served == 6


class BatchFakeHandle:
    def __init__(self, n, delay=0.0):
        self.n = n
        self.delay = delay

    def __array__(self, dtype=None, copy=None):
        if self.delay:
            time.sleep(self.delay)
        out = np.zeros((self.n, 8, 8, 3), np.uint8)
        out += np.arange(self.n, dtype=np.uint8)[:, None, None, None]
        return out


class BatchFakePipe(FakePipe):
    """Batch-capable fake: img_height/img_width let the worker merge."""

    img_height = img_width = 64

    def generate_image(self, ctx, _defer_fetch=False, batch_size=1,
                       diffusion_noise=None, seed=None, **kw):
        assert _defer_fetch
        with self.lock:
            self.dispatched.append(
                (np.shape(ctx)[0] if np.ndim(ctx) == 3 else 1, batch_size,
                 None if diffusion_noise is None else np.shape(diffusion_noise)))
        return BatchFakeHandle(batch_size, self.delay)


def submit_in_order(worker, payloads, results):
    """One client thread per payload, each started once the one before has
    enqueued, so the queue holds them in order; returns the threads."""
    threads = []
    for i, p in enumerate(payloads):
        t = threading.Thread(target=lambda i=i, p=p: results.__setitem__(i, worker.submit(p)))
        t.start()
        threads.append(t)
        deadline = time.time() + 10
        while worker.requests.qsize() < i + 1 and time.time() < deadline:
            time.sleep(0.005)
    return threads


def test_worker_merges_compatible_requests():
    """Queued same-settings requests run as one batched call and each caller gets
    its own image row; a request with other steps is not merged."""
    pipe = BatchFakePipe(delay=0.05)
    worker = serve_mod.BatchingWorker(pipe, pipeline_depth=1, max_batch=8)
    results = {}
    threads = submit_in_order(
        worker, [{"prompt": f"p{i}", "seed": i, "steps": 4 if i < 3 else 9} for i in range(4)],
        results)
    worker.start()
    for t in threads:
        t.join(timeout=30)
    try:
        assert worker.served == 4
        assert worker.merged_batches == 1
        # batch sizes are cut to powers of two: the steps=4 trio is one batch of 2
        # and one alone; the steps=9 request runs alone
        assert sorted(b for _, b, _ in pipe.dispatched) == [1, 1, 2]
        merged = next(d for d in pipe.dispatched if d[1] == 2)
        assert merged[0] == 2                      # stacked contexts
        assert merged[2] == (2, 8, 8, 4)           # per-seed noise rows
        assert all(results[i].shape == (1, 8, 8, 3) for i in range(4))
        assert [int(results[i][0, 0, 0, 0]) for i in range(2)] == [0, 1]  # own rows
    finally:
        worker.stop()


def test_merged_noise_rows_match_batch_1():
    """The merged call's noise rows equal, bit for bit, the noise each request
    draws alone: the port's TF-Philox generator's and the JAX package's."""
    captured = {}

    class CapturePipe(BatchFakePipe):
        def generate_image(self, ctx, diffusion_noise=None, batch_size=1, **kw):
            captured["noise"] = np.asarray(diffusion_noise)
            return BatchFakeHandle(batch_size)

    worker = serve_mod.BatchingWorker(CapturePipe(), pipeline_depth=1, max_batch=4)
    results = {}
    threads = submit_in_order(worker, [{"prompt": "x", "seed": 100 + i} for i in range(2)],
                              results)
    worker.start()
    for t in threads:
        t.join(timeout=30)
    worker.stop()
    noise = captured["noise"]
    assert noise.shape == (2, 8, 8, 4) and noise.dtype == np.float32
    for i, seed in enumerate((100, 101)):
        np.testing.assert_array_equal(noise[i:i + 1], trng.stateless_normal((1, 8, 8, 4), seed))
        np.testing.assert_array_equal(
            noise[i:i + 1], np.asarray(jrng.stateless_normal((1, 8, 8, 4), seed), np.float32))


def test_port_worker_matches_the_jax_worker(tmp_path):
    """The same three context payloads, enqueued in order before the worker
    starts, merge into a batch of 2 and a single on both workers; each request's
    image agrees within 1 of 255."""
    jpipe, pipe = make_pipelines(write_merges(tmp_path / "merges.txt.gz"))
    rs = np.random.RandomState(7)
    payloads = [{"context": base64.b64encode(rs.normal(0, 1, (77, 768)).astype(np.float32)
                                             .tobytes()).decode(),
                 "seed": 30 + i, "steps": 3} for i in range(3)]
    images = {}
    for name, module, p in (("jax", jserve, jpipe), ("port", serve_mod, pipe)):
        worker = module.BatchingWorker(p, pipeline_depth=2, max_batch=8)
        results = {}
        threads = submit_in_order(worker, payloads, results)
        worker.start()
        for t in threads:
            t.join(timeout=600)
        worker.stop()
        assert worker.served == 3 and worker.merged_batches == 1, name
        images[name] = [results[i] for i in range(3)]
    for got, want in zip(images["port"], images["jax"]):
        assert got.shape == want.shape == (1, 64, 64, 3) and got.dtype == np.uint8
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("flags,weight_dtype", [
    ([], None), (["--int8"], "int8"), (["--int8-hybrid", "SCALES"], "int8_hybrid")])
def test_int8_flags_reach_the_pipeline(flags, weight_dtype, tmp_path, monkeypatch):
    """``--int8`` and ``--int8-hybrid SCALES_NPZ`` build the pipeline as the JAX
    server does: ``weight_dtype`` "int8" or "int8_hybrid", the latter with the
    calibrated scales read from the file."""
    from minsdtf_tpu_torch.weights import calibrate

    path = str(tmp_path / "scales.npz")
    calibrate.save_scales(path, {"mid_block.resnets.0.conv1": {"amax": 3.0, "ratio": 1.25}})
    served = []

    class Stop(Exception):
        pass

    def fake_serve(pipe, *args, **kw):
        served.append(pipe)
        raise Stop

    monkeypatch.setattr(serve_mod, "serve", fake_serve)
    with pytest.raises(Stop):
        serve_mod.main([f if f != "SCALES" else path for f in flags] + ["--device", "cpu"])
    pipe = served[0]
    assert pipe.weight_dtype == weight_dtype
    if weight_dtype == "int8_hybrid":
        assert pipe._int8_act_scales == {"mid_block.resnets.0.conv1": {"amax": 3.0, "ratio": 1.25}}
    else:
        assert pipe._int8_act_scales is None

