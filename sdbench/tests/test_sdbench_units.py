"""The benchmark's arithmetic and bookkeeping, on the CPU."""

from __future__ import annotations

import json
import math
import re

import numpy as np
import pytest

from sdbench import flops, harness, traffic
from sdbench.families import sd15
from sdbench.tests import small

BENCH = json.loads((small.ROOT / "BENCHMARK.json").read_text())
H100 = flops.peaks("NVIDIA H100 80GB HBM3")


@pytest.mark.parametrize("shape, ms", [((2, 4096, 8, 40), 0.0434), ((2, 16384, 8, 40), 0.6948),
                                       ((2, 1024, 8, 80), 0.0054), ((1, 4096, 1, 512), 0.0347)])
def test_attention_bound_reproduces_the_kernel_table(shape, ms):
    assert round(flops.attention_bound_s(*shape, H100) * 1e3, 4) == ms


def test_reference_flops_of_the_unet_and_the_decode():
    cfg = json.loads((small.ROOT / "sdbench/configs/sd15.json").read_text())
    assert round(sd15.model_flops(cfg, "unet", 2, 512, 512) / 1e12, 4) == 1.6065
    assert round(sd15.model_flops(cfg, "vae", 1, 512, 512) / 1e12, 4) == 2.5145


def test_long_attentions_count_the_kernels_launches():
    cfg = json.loads((small.ROOT / "sdbench/configs/sd15-controlnet-canny.json").read_text())
    t2i = traffic.load("t2i512-closed")
    calls = {shape: n for n, shape in sd15.long_attentions(cfg, t2i)}
    assert calls == {(2, 4096, 8, 40): 125, (2, 1024, 8, 80): 125, (1, 4096, 1, 512): 1}
    cn = sum(n for n, _ in sd15.long_attentions(cfg, traffic.load("t2i512-edges-closed")))
    assert cn == 351  # K1 350, K2 1
    big = {shape: n for n, shape in sd15.long_attentions(cfg, traffic.load("t2i1024-closed"))}
    assert big[(2, 16384, 8, 40)] == 125 and big[(1, 16384, 1, 512)] == 1 and len(big) == 4


@pytest.mark.parametrize("mix", ["t2i512-closed", "t2i512-edges-closed", "serve512-poisson"])
def test_traffic_is_deterministic_by_seed(mix):
    m = traffic.load(mix)
    seed = 2**31 + 12345
    a = [traffic.request(m, seed, traffic.WINDOW, i) for i in range(5)]
    b = [traffic.request(m, seed, traffic.WINDOW, i) for i in range(5)]
    c = [traffic.request(m, seed + 1, traffic.WINDOW, i) for i in range(5)]
    for x, y in zip(a, b):
        assert (x.prompt, x.seed) == (y.prompt, y.seed)
        assert (x.control is None and y.control is None) or np.array_equal(x.control, y.control)
    assert [x.prompt for x in a] != [x.prompt for x in c]
    if m["loop"] == "open":
        # every seed sees the mix's arrival times; another arrival seed orders the
        # same gaps otherwise, each set summing to the window
        due = [r.due for r in traffic.schedule(m, seed, 0, 45)]
        assert due == [r.due for r in traffic.schedule(m, seed + 1, 0, 45)]
        other = traffic.arrivals(m["rate_per_s"], 45, m["arrival_seed"] + 1, 0)
        gaps1, gaps2 = np.diff(np.append(due, 45.0)), np.diff(np.append(other, 45.0))
        assert np.allclose(np.sort(gaps1), np.sort(gaps2)) and not np.allclose(gaps1, gaps2)
        assert len(due) == round(m["rate_per_s"] * 45)


def test_prompts_stay_in_one_chunk_and_edges_are_binary():
    m = traffic.load("t2i512-edges-closed")
    from sdbench.reference.text import BPE, prompt_rows
    bpe = BPE(str(small.ROOT / "sdbench/data/clip_merges.txt"))
    for i in range(50):
        r = traffic.request(m, 7, traffic.WINDOW, i)
        tokens, weights = prompt_rows(bpe, r.prompt)
        assert len(tokens) == len(weights) == 77
        assert r.control.shape == (512, 512, 3) and set(np.unique(r.control)) <= {0, 255}
        assert 0.01 < (r.control > 0).mean() < 0.5


def test_open_loop_latency_runs_from_the_due_time():
    due = [0.0, 1.0, 2.0, 3.0]
    done = [0.5, 2.5, None, 3.25]
    lat = harness.latencies(due, done)
    assert lat[0] == 0.5 and lat[1] == 1.5 and math.isinf(lat[2]) and lat[3] == 0.25
    assert harness.percentile(lat, 50) == pytest.approx(1.0)
    assert math.isinf(harness.percentile(lat, 90))  # the unfinished request is the tail
    assert harness.percentile(np.array([1.0, 2.0, 3.0, 4.0, 5.0]), 90) == pytest.approx(4.6)


def test_import_check_matches_top_level_names_whole():
    assert harness.forbidden_modules(["minsdtf_tpu_torch", "minsdtf_tpu_torch.ops", "numpy", "jaxtyping"]) == []
    assert harness.forbidden_modules(["minsdtf_tpu.ops", "jax._src", "jax", "flax.linen", "jaxlib"]) == \
        ["flax.linen", "jax", "jax._src", "jaxlib", "minsdtf_tpu.ops"]


def test_benchmark_json_names_and_units():
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert (small.ROOT / c["file"]).exists() and c["file"].startswith("sdbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
        assert (small.ROOT / "sdbench/traffic" / f"{w['traffic']}.json").exists()
        assert (small.ROOT / "sdbench/workloads" / f"{w['name']}.json").exists()
        names += [w["name"], w["config"], w["traffic"]]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert unit.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (small.ROOT / "sdbench/metrics" / f"{m['name']}.py").exists()
        names.append(m["name"])
    for n in names:
        assert name.match(n), n
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and all(m["moves"] in e2e for m in BENCH["per_layer"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_settings_drawn_from_lists_leave_what_a_fixed_mix_draws():
    fixed = traffic.load("t2i512-closed")
    drawn = dict(fixed, steps=[15, 25], guidance=[5.0, 7.5], batch_size=2)
    a = [traffic.request(fixed, 2**31 + 9, traffic.WINDOW, i) for i in range(40)]
    b = [traffic.request(drawn, 2**31 + 9, traffic.WINDOW, i) for i in range(40)]
    assert [(r.prompt, r.seed) for r in a] == [(r.prompt, r.seed) for r in b]
    assert {(r.steps, r.guidance, r.rescale, r.batch) for r in a} == {(25, 7.5, 0.7, 1)}
    assert {(r.steps, r.guidance) for r in b} == {(15, 5.0), (15, 7.5), (25, 5.0), (25, 7.5)}
    assert {r.batch for r in b} == {2}


def test_bursts_arrive_together():
    single = traffic.arrivals(2.0, 50, 0, traffic.WINDOW)
    assert np.array_equal(single, traffic.arrivals(2.0, 50, 0, traffic.WINDOW, burst=1))
    due = traffic.arrivals(2.0, 50, 0, traffic.WINDOW, burst=4)
    assert len(due) == 100 and np.all(due.reshape(25, 4) == due[::4, None])
    assert np.all(np.diff(due[::4]) > 0) and due[-1] < 50


def test_request_flops_follow_the_requests_settings():
    cfg = json.loads((small.ROOT / "sdbench/configs/sd15.json").read_text())
    mix = traffic.load("t2i512-closed")
    one = traffic.request(mix, 1, traffic.WINDOW, 0)
    text = sd15.model_flops(cfg, "text_encoder", 1, 512, 512)
    vae = sd15.model_flops(cfg, "vae", 1, 512, 512)
    assert sd15.request_flops(cfg, mix, one) == sd15.request_flops(cfg, mix) == \
        text + vae + 25 * sd15.model_flops(cfg, "unet", 2, 512, 512)
    eight = traffic.request(dict(mix, batch_size=8, steps=4, guidance=0.0), 1, traffic.WINDOW, 0)
    assert sd15.request_flops(cfg, mix, eight) == text + 8 * (vae + 4 * sd15.model_flops(cfg, "unet", 1, 512, 512))
    calls = {shape: n for n, shape in sd15.long_attentions(cfg, mix, eight)}
    assert calls == {(8, 4096, 8, 40): 20, (8, 1024, 8, 80): 20, (8, 4096, 1, 512): 1}
