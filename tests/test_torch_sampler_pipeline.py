"""``StableDiffusion(scheduler_type=...)`` of the port against the JAX pipeline on
the same small params, fp32 on the CPU at 64x64, for every scheduler type; the
port's step-noise draw replays JAX's fold_in stream (:func:`jax_step_noise`), the
one intended difference between the two pipelines. v-prediction and batches
above 1 are in ``test_torch_batch.py``.

CFG is 3 here, not 7.5: TCD, LCM and the Karras spacing start at t = 999, where
x0 = (x - nr*eps) / sr multiplies eps by 1/sr = 14.7. With CFG 7.5 on top, the
two packages' fp32 UNets, 2e-6 apart, end up 4e-4 apart in latents of +-40 made
by the random weights; at CFG 3 the latents stay within LATENT_TOL."""

import numpy as np
import pytest
import torch

from minsdtf_tpu_torch import StableDiffusion
from minsdtf_tpu_torch import pipeline as tpipeline
from torch_port_utils import (  # noqa: F401 (one_torch_thread)
    assert_same_image, jax_step_noise, make_pipelines, one_torch_thread, with_settings,
    write_merges,
)


CFG = 3.0


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    return make_pipelines(write_merges(tmp_path_factory.mktemp("bpe") / "merges.txt.gz"))


@pytest.fixture
def jax_noise(monkeypatch):
    monkeypatch.setattr(tpipeline, "draw_step_noise", jax_step_noise)


@pytest.mark.parametrize("scheduler_type",
                         ["ddim", "euler", "tcd", "lcm", "dpm", "dpm_karras", "euler_a"])
def test_scheduler_type_matches_jax_pipeline(pipelines, jax_noise, scheduler_type):
    jpipe, pipe = with_settings(pipelines, scheduler_type=scheduler_type)
    assert pipe.scheduler_type == scheduler_type
    # JAX's text_to_image is encode + generate_image(guidance_rescale=0.7)
    kw = dict(num_steps=4, seed=7, unconditional_guidance_scale=CFG, return_latent=True)
    want = jpipe.generate_image(jpipe._encode_text_dev("hello world"), guidance_rescale=0.7, **kw)
    with torch.backends.mkldnn.flags(enabled=False):
        got = pipe.text_to_image("hello world", **kw)
    assert_same_image(got, want)


def test_active_tcd_is_tcd(pipelines, jax_noise):
    """``active_tcd=True`` without a scheduler_type is TCD, through
    ``generate_image`` with its default eta of 0.3."""
    jpipe, pipe = with_settings(pipelines, active_tcd=True)
    assert pipe.scheduler_type == "tcd" and pipe.active_tcd and pipe.scheduler.mode == "tcd"
    kw = dict(num_steps=4, seed=7, unconditional_guidance_scale=CFG, return_latent=True)
    want = jpipe.generate_image(jpipe._encode_text_dev("hello world"), **kw)
    with torch.backends.mkldnn.flags(enabled=False):
        got = pipe.generate_image(pipe.encode_text("hello world"), **kw)
    assert_same_image(got, want)


def test_step_noise_is_drawn_from_the_seed():
    """The host draw: the same seed gives the same z, a fresh seed other z."""
    a = tpipeline.draw_step_noise(7, (4, 2, 8, 8, 4))
    assert a.shape == (4, 2, 8, 8, 4) and a.dtype == torch.float32 and a.device.type == "cpu"
    torch.testing.assert_close(tpipeline.draw_step_noise(7, (4, 2, 8, 8, 4)), a, rtol=0, atol=0)
    assert not torch.equal(tpipeline.draw_step_noise(8, (4, 2, 8, 8, 4)), a)


def test_stochastic_sampler_repeats_with_its_seed(pipelines):
    """Euler-a with the port's own draw: a seed gives one image; given noise and
    no seed, the step noise comes from a fresh seed."""
    _, pipe = with_settings(pipelines, scheduler_type="euler_a")
    first = pipe.text_to_image("hello world", num_steps=3, seed=11, return_latent=True)
    again = pipe.text_to_image("hello world", num_steps=3, seed=11, return_latent=True)
    np.testing.assert_array_equal(first[1], again[1])
    noise = np.random.RandomState(2).normal(0, 1, (1, 8, 8, 4)).astype(np.float32)
    kw = dict(num_steps=3, diffusion_noise=noise, return_latent=True)
    enc = pipe.encode_text("hello world")
    assert np.abs(pipe.generate_image(enc, **kw)[1] - pipe.generate_image(enc, **kw)[1]).max() > 0


def test_bad_settings_raise(tmp_path):
    with pytest.raises(ValueError, match="unknown scheduler_type"):
        StableDiffusion(64, 64, device="cpu", scheduler_type="heun")
    with pytest.raises(ValueError, match="prediction_type"):
        StableDiffusion(64, 64, device="cpu", prediction_type="sample")
