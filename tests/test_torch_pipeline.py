"""The port's slice as a whole: ``StableDiffusion.text_to_image`` against the JAX
pipeline on the same params, fp32 on the CPU; and the port's independence from
JAX and from the JAX package."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from minsdtf_tpu_torch import StableDiffusion
from torch_port_utils import (  # noqa: F401 (one_torch_thread)
    assert_same_image, make_pipelines, one_torch_thread, write_merges,
)

PORT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "minsdtf_tpu_torch")


@pytest.fixture(scope="module")
def bpe_path(tmp_path_factory):
    return write_merges(tmp_path_factory.mktemp("bpe") / "merges.txt.gz")


@pytest.fixture(scope="module")
def pipelines(bpe_path):
    """The JAX pipeline and the port's, fp32, holding the same small params."""
    return make_pipelines(bpe_path)


def test_text_to_image_matches_jax_pipeline(pipelines):
    jpipe, pipe = pipelines
    # JAX's text_to_image is encode + generate_image(guidance_rescale=0.7)
    want = jpipe.generate_image(
        jpipe._encode_text_dev("hello world"), num_steps=3, seed=7,
        unconditional_guidance_scale=7.5, guidance_rescale=0.7, return_latent=True)
    got = pipe.text_to_image("hello world", num_steps=3, seed=7, return_latent=True)
    assert_same_image(got, want)


def test_negative_prompt_and_given_noise_match_jax_pipeline(pipelines):
    """A negative prompt two LPW chunks long: the CFG pair has unequal context
    lengths and takes two UNet calls a step. The noise is the caller's."""
    jpipe, pipe = pipelines
    noise = np.random.RandomState(5).normal(0, 1, (1, 8, 8, 4)).astype(np.float32)
    negative = " ".join(["the cat"] * 40)
    assert pipe.encode_text(negative).shape == (1, 154, 768)
    kw = dict(negative_prompt=negative, num_steps=3, diffusion_noise=noise,
              unconditional_guidance_scale=5.0, return_latent=True)
    want = jpipe.generate_image(jpipe.encode_text("hello world"), **kw)
    got = pipe.generate_image(pipe.encode_text("hello world"), **kw)
    assert_same_image(got, want)


def test_import_leaves_out_jax_and_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import minsdtf_tpu_torch\n"
        "for m in pkgutil.walk_packages(minsdtf_tpu_torch.__path__, 'minsdtf_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "for m in ('weights.mapping', 'weights.lora', 'weights.fetch', 'tools.convert',\n"
        "          'tools.serve', 'tools.generate', 'tools.golden', 'tools.selfcheck',\n"
        "          'profiling', 'apps.common', 'apps.app', 'apps.text_to_image',\n"
        "          'training.train_step', 'parallel.mesh', 'parallel.comm',\n"
        "          'parallel.sharding', 'parallel.dryrun', 'ops.ring_attention'):\n"
        "    assert 'minsdtf_tpu_torch.' + m in sys.modules, m\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', 'optax', 'minsdtf_tpu')\n"
        "       or m.startswith(('jax.', 'jaxlib.', 'optax.', 'minsdtf_tpu.'))]\n"
        "print(bad)\n"
    )
    root = os.path.dirname(PORT_DIR)
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_sources_import_neither_jax_nor_the_jax_package():
    root = os.path.dirname(PORT_DIR)
    files = [os.path.join(root, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT_DIR):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            for line in f:
                words = line.split()
                if words[:1] in (["import"], ["from"]) and len(words) > 1:
                    module = words[1].split(".")[0]
                    assert module not in ("jax", "jaxlib", "optax", "minsdtf_tpu"), (path, line)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device is usable here")


def test_default_device_is_cuda_and_raises_without_it(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StableDiffusion()
    assert StableDiffusion(device="cpu").compute_dtype == torch.float32
