"""The port's host image utilities (``minsdtf_tpu_torch.imaging``) against the JAX
package's ``minsdtf_tpu.imaging`` on the same seeded numpy inputs."""

import numpy as np
import pytest

from minsdtf_tpu import imaging as jimaging
from minsdtf_tpu_torch import imaging as timaging

TOL = 1e-6


def _image(h, w, c, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (h, w, c)).astype(np.uint8)


@pytest.mark.parametrize("shape,new", [((40, 24, 3), (64, 48)), ((64, 64, 1), (8, 8)),
                                       ((33, 17, 4), (16, 40)), ((16, 16, 3), (16, 16))])
def test_bilinear_resize_matches(shape, new):
    image = _image(*shape)
    want = jimaging.bilinear_resize(image, *new)
    got = timaging.bilinear_resize(image, *new)
    assert got.shape == want.shape == (*new, shape[-1]) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [0, 1, 2, 5, 9])
def test_binomial_filter1d_matches(size):
    np.testing.assert_array_equal(timaging.binomial_filter1d(size),
                                  jimaging.binomial_filter1d(size))


@pytest.mark.parametrize("radius", [3, 5])
def test_gaussian_blur_matches(radius):
    mask = np.random.RandomState(1).uniform(0, 1, (48, 40, 1)).astype(np.float32)
    want = jimaging.gaussian_blur(mask, radius=radius)
    got = timaging.gaussian_blur(mask, radius=radius)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape", [(64, 48, 3), (80, 32, 4), (64, 48, 1)])
def test_preprocess_image_matches(shape):
    image = _image(*shape, seed=2)
    for got, want in zip(timaging.preprocess_image(image, 64, 64),
                         jimaging.preprocess_image(image, 64, 64)):
        assert got.shape == want.shape and got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("channels,blur", [(None, None), (None, 5), (3, None), (3, 3), (1, 5)])
def test_preprocess_mask_matches(channels, blur):
    """A 2-D mask, a 3-channel one (averaged, not converted to grayscale) and a
    1-channel one, with and without the blur."""
    yy, xx = np.mgrid[:40, :56]
    mask = np.where(np.hypot(yy - 20, xx - 30) < 12, 255, 0).astype(np.uint8)
    if channels:
        mask = np.stack([mask, mask // 2, 255 - mask][:channels], axis=-1)
    got = timaging.preprocess_mask(mask, 64, 64, blur)
    want = jimaging.preprocess_mask(mask, 64, 64, blur)
    for g, w, shape in zip(got, want, ((1, 64, 64, 1), (1, 8, 8, 1))):
        assert g.shape == w.shape == shape and g.dtype == w.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def test_load_image_passes_arrays_through():
    image = _image(8, 8, 3)
    np.testing.assert_array_equal(timaging.load_image(image), jimaging.load_image(image))
    np.testing.assert_array_equal(timaging.load_image(image.tolist()), image)
