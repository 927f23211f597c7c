"""``inpaint`` of the port against the JAX pipeline on the same small params, fp32
on the CPU at 64x64: a blurred 2-D mask, a 3-channel mask (averaged, not
converted to grayscale), and a mask without a reference image, which is txt2img."""

import numpy as np
import pytest

from minsdtf_tpu_torch import imaging
from torch_port_utils import (  # noqa: F401 (one_torch_thread)
    assert_same_image, disc_mask, make_pipelines, one_torch_thread, reference_image, write_merges,
)


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    return make_pipelines(write_merges(tmp_path_factory.mktemp("bpe") / "merges.txt.gz"))


def _three_channel(mask):
    """Unequal channels: their mean is not what a grayscale conversion gives."""
    return np.stack([mask, mask // 2, mask // 4], axis=-1)


@pytest.mark.parametrize("three_channels,blur", [(False, 5), (True, None)],
                         ids=["blurred", "three_channels"])
def test_inpaint_matches_jax_pipeline(pipelines, three_channels, blur):
    jpipe, pipe = pipelines
    ref = reference_image(64, 64)
    mask = disc_mask(48, 56)
    if three_channels:
        mask = _three_channel(mask)
    kw = dict(num_steps=3, seed=7, reference_image=ref, inpaint_mask=mask,
              mask_blur_strength=blur)
    want = jpipe.generate_image(jpipe._encode_text_dev("hello world"), guidance_rescale=0.7,
                                reference_image_strength=0.8, return_latent=True, **kw)
    got = pipe.inpaint("hello world", return_latent=True, **kw)
    assert_same_image(got, want)
    # outside the pixel mask the image is the reference
    keep = imaging.preprocess_mask(mask, 64, 64, blur)[0][0, ..., 0] == 0
    assert keep.any()
    assert np.abs(got[0][0].astype(int) - ref.astype(int))[keep].max() <= 1


def test_inpaint_without_reference_image_is_text_to_image(pipelines):
    jpipe, pipe = pipelines
    kw = dict(num_steps=3, seed=7, inpaint_mask=disc_mask(64, 64))
    want = jpipe.generate_image(jpipe._encode_text_dev("hello world"), guidance_rescale=0.7,
                                return_latent=True, **kw)
    got = pipe.inpaint("hello world", return_latent=True, **kw)
    assert_same_image(got, want)
    txt = pipe.text_to_image("hello world", num_steps=3, seed=7, return_latent=True)
    np.testing.assert_array_equal(got[1], txt[1])
