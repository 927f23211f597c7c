"""A second model family added as new files only (``twotext``: two text
encoders, a pooled vector in the UNet) runs through the harness's own run on the
CPU, closed and open loop: correct, with the window's FLOPs and the attention
bound counted by the family; a copy of it whose pipeline perturbs the latent is
not correct."""

from __future__ import annotations

import json
import sys
import time
import types

import pytest

from sdbench import flops, harness, traffic
from sdbench import weights as weights_lib
from sdbench.tests import small, twotext

BENCH = json.loads((small.ROOT / "BENCHMARK.json").read_text())
SETTINGS = {"warmup": 1, "min_s_per_img": 0.05, "trace": {"images": 1, "seconds": 1.0}, "compare": 2,
            "limits": {"image_mae_max": 5.0}}
MIXES = {"closed": ("t2i512-closed", {}), "open": ("serve512-poisson", {"rate_per_s": 3.0})}


def _register(monkeypatch, name: str, module: types.ModuleType) -> dict:
    monkeypatch.setitem(sys.modules, f"sdbench.families.{name}", module)
    return dict(twotext.config(), name=name, family=name)


def _run(monkeypatch, cfg: dict, loop: str):
    """``harness.run`` of a cell of ``cfg`` at 64px and 3 steps: the result
    line's object and the run's record."""
    records = []

    class Record(harness.Record):
        def __init__(self, *args):
            super().__init__(*args)
            records.append(self)

    monkeypatch.setattr(harness, "Record", Record)
    name, over = MIXES[loop]
    mix = dict(traffic.load(name), height=64, width=64, steps=3, **over)
    cell = {"name": f"{cfg['name']}-{loop}", "config": cfg["name"], "traffic": name, "chips": 1, "why": "test"}
    out = harness.run(cell, cfg, mix, SETTINGS, BENCH["end_to_end"], 2**31 + 55, 1.0, False, time.perf_counter(),
                      device="cpu")
    return out, records[0]


@pytest.mark.parametrize("loop", list(MIXES))
def test_a_second_family_runs_and_is_correct(monkeypatch, loop):
    cfg = _register(monkeypatch, twotext.NAME, twotext)
    out, rec = _run(monkeypatch, cfg, loop)
    assert out["correct"], out
    assert out["failed"] == 0 and out["attempted"] >= (3 if loop == "open" else 1)
    assert out["checks"]["image_mae_max"]["value"] == 0.0
    assert "setup_s" in out["metrics"]
    # the window's work as the family counts it, one request at a time
    assert rec.done_requests and rec.window_flops == sum(
        twotext.request_flops(cfg, rec.mix, r) for r in rec.done_requests)
    assert rec.window_flops == len(rec.done_requests) * twotext.request_flops(cfg, rec.mix) > 0
    peak = flops.peaks("NVIDIA H100 80GB HBM3")
    assert flops.request_attention_bound_s(cfg, rec.mix, peak) == sum(
        n * flops.attention_bound_s(*shape, peak) for n, shape in twotext.long_attentions(cfg, rec.mix)) > 0


def test_the_second_familys_models_take_what_sdxl_adds(monkeypatch):
    cfg = _register(monkeypatch, twotext.NAME, twotext)
    w = weights_lib.make(cfg, 7, "cpu")
    assert list(w) == ["text_encoder", "text_encoder_2", "unet", "vae"]
    assert w["text_encoder_2"]["text_projection.weight"].shape == (24, 48)
    assert w["unet"]["add_embedding.weight"].shape == (128, 24)
    ref = twotext.Reference(cfg, w, str(small.ROOT / cfg["tokenizer"]["merges"]), "cpu")
    packed = ref.context("a photo of a cat")
    assert packed.shape == (78, 80) and packed[-1, 24:].abs().max() == 0
    image = ref.text_to_image("a photo of a cat", 5, 64, 64, 3, 7.5)
    assert image.shape == (1, 64, 64, 3) and image.std() > 20


class _Perturbed(twotext.Reference):
    def decode(self, latent):
        return super().decode(latent + 1.0)


def _perturbed_pipeline(cfg, weights, mix, device, merges_path, compute_dtype=None):
    return twotext.ReferencePipe(_Perturbed(cfg, weights, merges_path, device), mix, device)


@pytest.mark.parametrize("loop", list(MIXES))
def test_a_copy_whose_pipeline_perturbs_the_latent_is_not_correct(monkeypatch, loop):
    copy = types.ModuleType("sdbench.families.twotext_perturbed")
    copy.__dict__.update({k: v for k, v in vars(twotext).items() if not k.startswith("__")})
    copy.build_pipeline = _perturbed_pipeline
    cfg = _register(monkeypatch, "twotext_perturbed", copy)
    out, _ = _run(monkeypatch, cfg, loop)
    assert out["failed"] == 0 and out["attempted"] >= 1, out
    assert out["checks"]["image_mae_max"]["value"] > SETTINGS["limits"]["image_mae_max"], out
    assert not out["correct"], out
