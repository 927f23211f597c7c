"""The control of the comparison: the reference one precision below the
configuration's (fp8 e4m3 products for bf16), put in the program's place and
run through the harness's own run, must come out not correct, its compared
number above the cell's limit: on the CPU at a small size and, on the card, at
the cell's own size."""

from __future__ import annotations

import json

import pytest
import torch

from sdbench import control, traffic
from sdbench.tests import small

BENCH = json.loads((small.ROOT / "BENCHMARK.json").read_text())
# the window a control run takes to complete each cell's ``compare`` requests on the card
CARD_SECONDS = {"sd15-t2i512-b1": 8.0, "sd15-cn-canny-t2i512-b1": 10.0, "sd15-t2i1024-b1": 40.0,
                "sd15-serve512-open": 3.0}


def _settings(cell: str) -> dict:
    return json.loads((small.ROOT / "sdbench/workloads" / f"{cell}.json").read_text())


def _cell(name: str) -> dict:
    return next(w for w in BENCH["workloads"] if w["name"] == name)


def _assert_not_correct(out: dict, cell: str, margin: float = 1.0) -> None:
    limit = _settings(cell)["limits"]["image_mae_max"]
    assert out["failed"] == 0 and out["attempted"] >= 1, out
    assert out["checks"]["image_mae_max"]["limit"] == limit
    assert out["checks"]["image_mae_max"]["value"] > margin * limit, out
    assert not out["correct"], out


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's own size")
    return "cuda"


@pytest.mark.parametrize("cell, controlnet", [("sd15-t2i512-b1", False), ("sd15-cn-canny-t2i512-b1", True),
                                              ("sd15-serve512-open", False)])
def test_control_is_not_correct_at_a_small_size(cell, controlnet):
    w = _cell(cell)
    mix = dict(traffic.load(w["traffic"]), height=64, width=64, steps=4)
    settings = dict(_settings(cell), compare=2)
    out = control.run(w, small.config(controlnet), mix, settings, 2**31 + 11, 1.0, device="cpu")
    _assert_not_correct(out, cell, 1.5)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_control_is_not_correct_at_the_cells_size(card, cell):
    w = _cell(cell)
    cfg_file = next(c["file"] for c in BENCH["configs"] if c["name"] == w["config"])
    cfg = json.loads((small.ROOT / cfg_file).read_text())
    out = control.run(w, cfg, traffic.load(w["traffic"]), _settings(cell), 2**31 + 21, CARD_SECONDS[cell], card)
    _assert_not_correct(out, cell)
