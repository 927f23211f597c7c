"""The frozen reference against the library at a small size on the CPU, both in
fp32 on the same weights: the same image to within one level. The reference
imports nothing of the library and nothing of JAX."""

from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from sdbench import traffic
from sdbench import weights as weights_lib
from sdbench.families import sd15
from sdbench.reference import philox
from sdbench.reference.pipeline import Reference
from sdbench.reference.text import BPE, prompt_rows
from sdbench.tests import small

MERGES = str(small.ROOT / "sdbench/data/clip_merges.txt")


def test_reference_imports_neither_the_library_nor_jax():
    for path in (small.ROOT / "sdbench/reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "flax", "minsdtf_tpu", "minsdtf_tpu_torch",
                                              "sdbench"), (path, n)


def test_tokens_and_noise_match_the_library():
    from minsdtf_tpu_torch import rng
    from minsdtf_tpu_torch.text import prompt_weighting as lpw
    from minsdtf_tpu_torch.text.tokenizer import ClipTokenizer

    tok, bpe = ClipTokenizer(MERGES), BPE(MERGES)
    mix = traffic.load("t2i512-closed")
    for i in range(20):
        p = traffic.request(mix, 99, 0, i).prompt
        toks, wts = lpw.tokenize_weighted(tok, [p], 75)
        toks, wts = lpw.pad_tokens_and_weights(toks, wts, 77, tok.start_of_text, tok.end_of_text, 49407,
                                               no_boseos_middle=False)
        assert (toks[0], wts[0]) == prompt_rows(bpe, p)
    for seed in (0, 7, 2**31 + 5):
        assert np.array_equal(philox.stateless_normal((1, 8, 8, 4), seed), rng.stateless_normal((1, 8, 8, 4), seed))


CASES = [  # (controlnet, mix settings over the 512px mix)
    (False, {}),
    (True, {}),
    (False, {"scheduler": "tcd", "batch_size": 2, "steps": [2, 3], "guidance": [0.0, 1.5]}),
    (False, {"scheduler": "dpm_karras", "steps": 5, "guidance": [5.0, 7.5], "rescale": [0.0, 0.7]}),
]


@pytest.mark.parametrize("controlnet, settings", CASES, ids=["ddim", "controlnet", "tcd-b2", "dpm-karras"])
def test_reference_agrees_with_the_library(controlnet, settings):
    cfg = small.config(controlnet)
    w = weights_lib.make(cfg, 2**31 + 3, "cpu")
    mix = dict(traffic.load("t2i512-edges-closed" if controlnet else "t2i512-closed"), height=64, width=64,
               steps=4)
    mix.update(settings)
    with small.library_widths(cfg):
        pipe = sd15.build_pipeline(cfg, w, mix, "cpu", MERGES, torch.float32)
    ref = Reference(cfg, w, MERGES, "cpu")
    for i in range(2):
        r = traffic.request(mix, 5, 0, i)
        got = pipe.text_to_image(r.prompt, batch_size=r.batch, num_steps=r.steps,
                                 unconditional_guidance_scale=r.guidance, guidance_rescale=r.rescale, seed=r.seed,
                                 control_net_image=r.control)
        want = ref.request(r, mix)
        assert got.shape == want.shape == (r.batch, 64, 64, 3)
        gap = np.abs(got.astype(int) - want.astype(int))
        assert gap.max() <= 1 and gap.mean() < 0.01 and want.std() > 20
