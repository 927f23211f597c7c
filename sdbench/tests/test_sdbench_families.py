"""The model families on the CPU: the SD1.5 family gives every number the cells
read exactly as the harness gave it before the families (FLOPs, long attentions
and weights, pinned), a configuration that names no family that exists is
refused with its file's name, and the shared modules name no model kind and no
key of SD1.5's configuration."""

from __future__ import annotations

import hashlib
import json
import re

import pytest

from sdbench import families, traffic
from sdbench import weights as weights_lib
from sdbench.tests import small

BENCH = json.loads((small.ROOT / "BENCHMARK.json").read_text())
CONFIG_FILES = {c["name"]: small.ROOT / c["file"] for c in BENCH["configs"]}

# request_flops and long_attentions of a one-image request at each cell's mix
PINNED_CELLS = {
    "sd15-t2i512-b1": (42691489501184, [(125, (2, 4096, 8, 40)), (125, (2, 1024, 8, 80)),
                                        (1, (1, 4096, 1, 512))]),
    "sd15-cn-canny-t2i512-b1": (56134709940224, [(125, (2, 4096, 8, 40)), (125, (2, 1024, 8, 80)),
                                                 (50, (2, 4096, 8, 40)), (50, (2, 1024, 8, 80)),
                                                 (1, (1, 4096, 1, 512))]),
    "sd15-t2i1024-b1": (244184002138112, [(125, (2, 16384, 8, 40)), (125, (2, 4096, 8, 80)),
                                          (125, (2, 1024, 8, 160)), (1, (1, 16384, 1, 512))]),
    "sd15-serve512-open": (42691489501184, [(125, (2, 4096, 8, 40)), (125, (2, 1024, 8, 80)),
                                            (1, (1, 4096, 1, 512))]),
}
# (config, mix, (steps, guidance, batch, prompt tokens)) -> the same of that request
PINNED_REQUESTS = [
    ("sd15", "t2i512-closed", (4, 0.0, 8, 100), 46055808704512,
     [(20, (8, 4096, 8, 40)), (20, (8, 1024, 8, 80)), (1, (8, 4096, 1, 512))]),
    ("sd15", "t2i512-closed", (3, 2.0, 2, 151), 14864447254528,
     [(15, (4, 4096, 8, 40)), (15, (4, 1024, 8, 80)), (1, (2, 4096, 1, 512))]),
    ("sd15-controlnet-canny", "t2i512-edges-closed", (4, 0.0, 8, 100), 54857445548032,
     [(20, (8, 4096, 8, 40)), (20, (8, 1024, 8, 80)), (8, (8, 4096, 8, 40)), (8, (8, 1024, 8, 80)),
      (1, (8, 4096, 1, 512))]),
    ("sd15-controlnet-canny", "t2i512-edges-closed", (3, 2.0, 2, 151), 18183947235328,
     [(15, (4, 4096, 8, 40)), (15, (4, 1024, 8, 80)), (6, (4, 4096, 8, 40)), (6, (4, 1024, 8, 80)),
      (1, (2, 4096, 1, 512))]),
]
# sha256 of weights.make's tensors at seed 0 on the CPU: kind, name, shape and bytes
PINNED_WEIGHTS = {False: "e5a2a01b764fa3af6dc8d183dfbb9c38805e15eef86c336d2a9a70af27a896be",
                  True: "e104ceb4bc9219abaab389718c6760eea8b8f91c587603ff306ca5b94dbe58ff"}
SHARED = ("harness.py", "weights.py", "control.py", "sweep.py", "run.py", "flops.py")
SD15_WORDS = re.compile(r"\b(unet|text_encoder|vae|controlnet|hint|block_out_channels|attention_head_dim|"
                        r"cross_attention_dim|layers_per_block|down_block_types|up_block_types|"
                        r"conditioning_embedding_out_channels|scaling_factor)\b", re.IGNORECASE)


@pytest.mark.parametrize("cell", list(PINNED_CELLS))
def test_cells_flops_and_long_attentions_are_pinned(cell):
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    cfg = families.read(CONFIG_FILES[w["config"]])
    family, mix = families.load(cfg), traffic.load(w["traffic"])
    assert family.__name__ == "sdbench.families.sd15"
    flops_pinned, attentions_pinned = PINNED_CELLS[cell]
    assert family.request_flops(cfg, mix) == flops_pinned
    assert family.long_attentions(cfg, mix) == attentions_pinned


@pytest.mark.parametrize("config, mix, settings, flops_pinned, attentions_pinned", PINNED_REQUESTS)
def test_requests_flops_and_long_attentions_are_pinned(config, mix, settings, flops_pinned, attentions_pinned):
    cfg = families.read(CONFIG_FILES[config])
    steps, guidance, batch, tokens = settings
    req = traffic.Request(0, 0, "x", 1, steps=steps, guidance=guidance, batch=batch, tokens=tokens)
    family = families.load(cfg)
    assert family.request_flops(cfg, traffic.load(mix), req) == flops_pinned
    assert family.long_attentions(cfg, traffic.load(mix), req) == attentions_pinned


@pytest.mark.parametrize("controlnet", [False, True])
def test_weights_are_pinned(controlnet):
    h = hashlib.sha256()
    for kind, state in weights_lib.make(small.config(controlnet), 0, "cpu").items():
        for name, t in state.items():
            h.update(f"{kind}/{name}/{tuple(t.shape)}".encode())
            h.update(t.contiguous().numpy().tobytes())
    assert h.hexdigest() == PINNED_WEIGHTS[controlnet]


@pytest.mark.parametrize("family", [None, "nosuchfamily", "sd15.x", 15])
def test_a_configuration_without_a_known_family_is_refused(tmp_path, family):
    cfg = json.loads(CONFIG_FILES["sd15"].read_text())
    if family is None:
        del cfg["family"]
    else:
        cfg["family"] = family
    path = tmp_path / "odd-config.json"
    path.write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="odd-config.json") as e:
        families.read(path)
    assert "family" in str(e.value)
    with pytest.raises(ValueError, match="sd15.*family"):
        families.load(cfg)


def test_every_configuration_names_its_family():
    for name, path in CONFIG_FILES.items():
        assert families.read(path)["family"] == "sd15", name


@pytest.mark.parametrize("module", SHARED)
def test_shared_modules_name_no_model_kind_or_sd15_key(module):
    found = SD15_WORDS.findall((small.ROOT / "sdbench" / module).read_text())
    assert not found, (module, found)
