"""The harness driven on the CPU at a small size, past its look for a card: a
sound run is correct, and a run with the timed path broken underneath is not,
once for each fault a cell can have (a step that returns its state unchanged,
half of the guided batch left out, an image altered where it is produced). The
exchange between chips is no fault here: every cell runs on one chip."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from minsdtf_tpu_torch import sampler
from minsdtf_tpu_torch.models import unet as unet_lib
from sdbench import harness, traffic
from sdbench.tests import small

BENCH = json.loads((small.ROOT / "BENCHMARK.json").read_text())
SETTINGS = {"warmup": 1, "min_s_per_img": 0.05, "trace": {"images": 1, "seconds": 1.0}, "compare": 2, "limits": {"image_mae_max": 5.0}}


def _run(cell_name: str, mix_name: str, controlnet: bool = False, trace: bool = False, **mix_kw):
    cell = next(w for w in BENCH["workloads"] if w["name"] == cell_name)
    mix = dict(traffic.load(mix_name), height=64, width=64, steps=3)
    mix.update(mix_kw)
    kind = "per_layer" if trace else "end_to_end"
    metrics = [m for m in BENCH[kind] if cell_name in m.get("workloads", [cell_name])]
    cfg = small.config(controlnet)
    with small.library_widths(cfg):
        return harness.run(cell, cfg, mix, SETTINGS, metrics, 2**31 + 77, 1.0, trace, time.perf_counter(),
                           device="cpu", compute_dtype=torch.float32)


def test_sound_run_is_correct():
    out = _run("sd15-t2i512-b1", "t2i512-closed")
    assert out["correct"], out
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"s_per_img", "setup_s"}
    assert list(out)[-1] == "checks" and out["checks"]["image_mae_max"]["value"] < 1.0


def test_sound_controlnet_run_with_trace():
    out = _run("sd15-cn-canny-t2i512-b1", "t2i512-edges-closed", controlnet=True, trace=True)
    assert out["correct"], out
    # no device metric is read on the CPU: only the program's counter
    assert set(out["metrics"]) == {"program_replays_per_img"}


def test_open_loop_run_is_correct():
    out = _run("sd15-serve512-open", "serve512-poisson", rate_per_s=3.0)
    assert out["correct"], out
    assert {"latency_p50_s", "latency_p90_s", "setup_s"} == set(out["metrics"])
    assert out["attempted"] == 3


def test_batched_requests_of_drawn_settings_are_counted_and_compared():
    """A mix of other samplers, batches and per-request settings runs on data
    alone: each call's images are counted and each image compared."""
    out = _run("sd15-t2i512-b1", "t2i512-closed", scheduler="tcd", batch_size=2, steps=[2, 3],
               guidance=[0.0, 2.0])
    assert out["correct"], out
    assert out["attempted"] % 2 == 0 and out["attempted"] >= 2


def test_bursts_of_requests_are_served_and_compared():
    out = _run("sd15-serve512-open", "serve512-poisson", rate_per_s=4.0, burst=2, steps=[2, 3])
    assert out["correct"], out
    assert out["attempted"] == 4 and out["failed"] == 0


def _unchanged_step(self):
    pass


def _half_batch(forward):
    def half(self, latent, t_emb, context, controls=None):
        n = latent.shape[0] // 2 or 1
        out = forward(self, latent[:n], t_emb[:n], context[:n],
                      None if controls is None else [c[:n] for c in controls])
        return out.repeat(latent.shape[0] // n, 1, 1, 1)
    return half


def _altered_image(decode):
    def altered(*args, **kw):
        return decode(*args, **kw).flip(-1)
    return altered


@pytest.mark.parametrize("fault", ["unchanged_step", "half_batch", "altered_image"])
def test_broken_path_is_not_correct(monkeypatch, fault):
    if fault == "unchanged_step":
        monkeypatch.setattr(sampler._Program, "body", _unchanged_step)
    elif fault == "half_batch":
        monkeypatch.setattr(unet_lib.UNet, "forward", _half_batch(unet_lib.UNet.forward))
    else:
        monkeypatch.setattr(sampler, "_decode_image", _altered_image(sampler._decode_image))
    out = _run("sd15-t2i512-b1", "t2i512-closed")
    assert not out["correct"], out
    assert out["checks"]["image_mae_max"]["value"] > SETTINGS["limits"]["image_mae_max"]
