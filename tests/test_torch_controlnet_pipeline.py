"""``text_to_image(control_net_image=...)`` of the port against the JAX pipeline
on the same small params, fp32 on the CPU."""

import numpy as np
import pytest

from minsdtf_tpu_torch import StableDiffusion
from torch_port_utils import (  # noqa: F401 (one_torch_thread)
    assert_same_image, edge_image, make_pipelines, one_torch_thread, write_merges,
)


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    bpe = write_merges(tmp_path_factory.mktemp("bpe") / "merges.txt.gz")
    return make_pipelines(bpe, controlnet=True)


@pytest.mark.parametrize("negative_prompt", [None, " ".join(["the cat"] * 40)],
                         ids=["batched", "two_calls"])
def test_text_to_image_with_controlnet_matches_jax_pipeline(pipelines, negative_prompt):
    """The CFG pair batched with the hint doubled, and (a negative prompt two LPW
    chunks long) two UNet calls a step, each with the hint."""
    jpipe, pipe = pipelines
    kw = dict(negative_prompt=negative_prompt, num_steps=3, seed=7,
              control_net_image=edge_image(48, 40), unconditional_guidance_scale=7.5)
    want = jpipe.generate_image(jpipe.encode_text("hello world"), guidance_rescale=0.7,
                                return_latent=True, **kw)
    steps = []
    got = pipe.text_to_image("hello world", callback=steps.append, return_latent=True, **kw)
    assert_same_image(got, want)
    assert steps == [1, 2, 3]
    plain = pipe.text_to_image("hello world", num_steps=3, seed=7, return_latent=True,
                               negative_prompt=negative_prompt)
    assert np.abs(plain[1] - got[1]).max() > 1e-3  # the ControlNet changes the latent


def test_control_net_image_needs_a_controlnet(tmp_path):
    pipe = StableDiffusion(64, 64, device="cpu", bpe_path=write_merges(tmp_path / "m.txt.gz"))
    with pytest.raises(ValueError, match="ControlNet"):
        pipe.generate_image(np.zeros((77, 768), np.float32), control_net_image=edge_image(64, 64))
    missing = StableDiffusion(64, 64, device="cpu",
                              controlnet_path=str(tmp_path / "controlnet.safetensors"))
    with pytest.raises(FileNotFoundError, match="controlnet"):
        missing.generate_image(np.zeros((77, 768), np.float32), control_net_image=edge_image(64, 64))
    with pytest.raises(ValueError, match="textual-inversion"):
        pipe.text_to_image("hello", embedding=np.zeros((1, 640), np.float32))
