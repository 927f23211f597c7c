"""The port's pipeline at batch 2 through every entry point (txt2img with
Euler-a and its trajectory, img2img, inpaint, ControlNet txt2img), and with
``prediction_type="v"``, against the JAX pipeline on the same small params, fp32
on the CPU at 64x64. The port's step-noise draw replays JAX's stream."""

import numpy as np
import pytest
import torch

from minsdtf_tpu_torch import pipeline as tpipeline
from torch_port_utils import (  # noqa: F401 (one_torch_thread)
    LATENT_TOL, assert_same_image, disc_mask, edge_image, jax_step_noise, make_pipelines,
    one_torch_thread, reference_image, with_settings, write_merges,
)

# at CFG 3, as in test_torch_sampler_pipeline.py, which says why
CFG = 3.0


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    bpe = write_merges(tmp_path_factory.mktemp("bpe") / "merges.txt.gz")
    return make_pipelines(bpe, controlnet=True)


@pytest.fixture
def jax_noise(monkeypatch):
    monkeypatch.setattr(tpipeline, "draw_step_noise", jax_step_noise)


def test_v_prediction_at_batch_2_matches_jax_pipeline(pipelines, jax_noise):
    """A v-predicting UNet under Euler-a at batch 2 (step noise (n, 2, h, w, 4))
    with a prompt per image, and the trajectory (one JAX compile for all four)."""
    jpipe, pipe = with_settings(pipelines, scheduler_type="euler_a", prediction_type="v")
    prompts = ["hello world", "the (cat:1.2) dog"]
    kw = dict(num_steps=4, seed=7, batch_size=2, unconditional_guidance_scale=CFG,
              guidance_rescale=0.7, return_latent=True, return_trajectory=True)
    want = jpipe.generate_image(jpipe._encode_text_dev(prompts), **kw)
    with torch.backends.mkldnn.flags(enabled=False):
        got = pipe.generate_image(pipe.encode_text(prompts), **kw)
    assert_same_image(got[:2], want[:2], batch=2)
    assert got[2].shape == want[2].shape == (4, 2, 8, 8, 4)
    np.testing.assert_allclose(got[2], want[2], rtol=LATENT_TOL, atol=LATENT_TOL)
    np.testing.assert_array_equal(got[2][-1], got[1])
    assert np.abs(got[1][0] - got[1][1]).max() > 1e-3  # each image its own noise
    _, eps = with_settings(pipelines, scheduler_type="euler_a")
    with torch.backends.mkldnn.flags(enabled=False):
        as_eps = eps.generate_image(eps.encode_text(prompts), **kw)
    assert np.abs(as_eps[1] - got[1]).max() > 1e-2  # the same UNet read as eps, not v
    image, trajectory = pipe.generate_image(pipe.encode_text("hello world"), num_steps=2,
                                            seed=7, return_trajectory=True)
    assert image.shape == (1, 64, 64, 3) and trajectory.shape == (2, 1, 8, 8, 4)


@pytest.mark.parametrize("entry", ["image_to_image", "inpaint", "control_net"])
def test_batch_of_two_matches_jax_pipeline(pipelines, entry):
    """DDIM at CFG 7.5 (its first t is 666): the start latent, the inpaint blends
    and the hint at batch 2."""
    jpipe, pipe = pipelines
    kw = dict(num_steps=3, seed=7, batch_size=2, return_latent=True)
    if entry == "control_net":
        kw.update(control_net_image=edge_image(48, 40))
    else:
        kw.update(reference_image=reference_image(80, 72), reference_image_strength=0.8)
    if entry == "inpaint":
        kw.update(inpaint_mask=disc_mask(64, 64), mask_blur_strength=5)
    want = jpipe.generate_image(jpipe._encode_text_dev("hello world"), guidance_rescale=0.7, **kw)
    with torch.backends.mkldnn.flags(enabled=False):
        got = getattr(pipe, "text_to_image" if entry == "control_net" else entry)(
            "hello world", **kw)
    assert_same_image(got, want, batch=2)
    assert np.abs(got[1][0] - got[1][1]).max() > 1e-3
