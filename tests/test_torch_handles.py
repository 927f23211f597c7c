"""The port's reference-compatible sub-model handles (``diffusion_model``,
``image_encoder``, ``image_decoder``, ``hint_net``, ``control_net``) against the
JAX pipeline's, on small-width modules assigned to both pipelines, fp32 on the
CPU: numpy in and out, NHWC latents, images, hints and residuals."""

import jax
import numpy as np
import pytest

from minsdtf_tpu.models import controlnet as jcontrolnet
from torch_port_utils import make_pipelines, one_torch_thread, write_merges  # noqa: F401

MODULE_TOL = 1e-4


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    return make_pipelines(write_merges(tmp_path_factory.mktemp("bpe") / "merges.txt.gz"),
                          controlnet=True)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    return dict(
        latent=rng.normal(0, 1, (1, 8, 8, 4)).astype(np.float32),
        t_emb=rng.normal(0, 1, (1, 320)).astype(np.float32),
        context=rng.normal(0, 1, (1, 77, 768)).astype(np.float32),
        image=rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32),
        hint_image=rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32),
    )


def close(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=MODULE_TOL, atol=MODULE_TOL)


def test_vae_handles_match_jax(pipelines, inputs):
    jpipe, pipe = pipelines
    latent = pipe.image_encoder.predict_on_batch(inputs["image"])
    close(latent, np.asarray(jpipe.image_encoder.predict_on_batch(inputs["image"])))
    assert latent.shape == (1, 8, 8, 4)
    image = pipe.image_decoder(inputs["latent"])
    close(image, jpipe.image_decoder.predict_on_batch(inputs["latent"]))
    assert image.shape == (1, 64, 64, 3)


def test_unet_and_controlnet_handles_match_jax(pipelines, inputs):
    jpipe, pipe = pipelines
    hint = pipe.hint_net.predict_on_batch(inputs["hint_image"])
    close(hint, jpipe.hint_net.predict_on_batch(inputs["hint_image"]))
    assert hint.shape == (1, 8, 8, 320)
    args = [inputs["latent"], inputs["t_emb"], inputs["context"]]
    controls = pipe.control_net.predict_on_batch(args + [hint])
    # the JAX handle runs controlnet.apply op by op, which is slow on the CPU;
    # jitted it is the same function
    want_controls = jax.jit(jcontrolnet.apply)(jpipe.controlnet_params, *args, hint)
    assert len(controls) == len(want_controls) == 13
    for got, want in zip(controls, want_controls):
        close(got, np.asarray(want))
    controlled = pipe.diffusion_model.predict_on_batch(args + controls)
    close(controlled, jpipe.diffusion_model.predict_on_batch(args + list(want_controls)))
    assert np.abs(controlled - pipe.diffusion_model(args)).max() > 1e-3
