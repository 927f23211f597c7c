"""``image_to_image`` of the port against the JAX pipeline on the same small
params, fp32 on the CPU at 64x64: img2img at strength 0.8 (the schedule cut to
its last steps, the encoded reference noised to the first), and at strength 1.0,
which is txt2img."""

import numpy as np
import pytest

from torch_port_utils import (  # noqa: F401 (one_torch_thread)
    assert_same_image, make_pipelines, one_torch_thread, reference_image, write_merges,
)


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    return make_pipelines(write_merges(tmp_path_factory.mktemp("bpe") / "merges.txt.gz"))


@pytest.mark.parametrize("strength", [0.8, 1.0])
def test_image_to_image_matches_jax_pipeline(pipelines, strength):
    jpipe, pipe = pipelines
    ref = reference_image(80, 72)
    kw = dict(num_steps=3, seed=7, reference_image=ref, reference_image_strength=strength)
    # JAX's image_to_image is encode + generate_image(guidance_rescale=0.7)
    want = jpipe.generate_image(jpipe._encode_text_dev("hello world"), guidance_rescale=0.7,
                                return_latent=True, **kw)
    steps = []
    got = pipe.image_to_image("hello world", callback=steps.append, return_latent=True, **kw)
    assert_same_image(got, want)
    assert steps == list(range(1, (2 if strength < 1 else 3) + 1))
    if strength == 1.0:  # no img2img: the same image as text_to_image
        txt = pipe.text_to_image("hello world", num_steps=3, seed=7, return_latent=True)
        np.testing.assert_array_equal(got[1], txt[1])
