"""Host-side image utilities for img2img, inpaint and ControlNet: resize, blur,
pre-processing. numpy only, run once per generation.

  - bilinear resize with corner-aligned sample grids, in float64;
  - binomial-kernel "gaussian" blur: a normalized Pascal-triangle row of length
    ``radius`` applied separably with a reflect boundary (scipy ``correlate1d``);
  - image normalization to [-1, 1], and mask -> pixel mask + 8x-down latent mask.

Images and masks are numpy arrays (or anything ``np.array`` takes). A path string
is opened with PIL, imported only then: the card's machine has no PIL.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def bilinear_resize(image: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """(H, W, C) -> (new_h, new_w, C), corner-aligned bilinear, float64. The same
    size returns ``image`` itself."""
    h, w, _ = image.shape
    if (new_h, new_w) == (h, w):
        return image
    y = np.linspace(0, h - 1, new_h)[:, None]
    x = np.linspace(0, w - 1, new_w)[None, :]
    y0 = np.clip(np.floor(y).astype(int), 0, h - 1)
    y1 = np.clip(np.ceil(y).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(x).astype(int), 0, w - 1)
    x1 = np.clip(np.ceil(x).astype(int), 0, w - 1)
    dy = (y - y0)[..., None]
    dx = (x - x0)[..., None]
    top = image[y0, x0] * (1.0 - dx) + image[y0, x1] * dx
    bot = image[y1, x0] * (1.0 - dx) + image[y1, x1] * dx
    return top * (1.0 - dy) + bot * dy


def binomial_filter1d(kernel_size: int) -> np.ndarray:
    """Normalized Pascal-triangle row of length ``kernel_size``."""
    if kernel_size <= 1:
        return np.ones((1,))
    row = np.ones(1)
    for _ in range(kernel_size - 1):
        row = np.convolve(row, [1.0, 1.0])
    return row / row.sum()


def gaussian_blur(image: np.ndarray, radius: int = 3, h_axis: int = 0,
                  v_axis: int = 1) -> np.ndarray:
    """Separable binomial blur with a reflect boundary."""
    from scipy.ndimage import correlate1d

    weights = binomial_filter1d(radius)
    out = correlate1d(image, weights, axis=h_axis, mode="reflect")
    return correlate1d(out, weights, axis=v_axis, mode="reflect")


def load_image(x, mode: str = "RGB") -> np.ndarray:
    """An array as it is; a path string opened with PIL and converted to ``mode``."""
    if isinstance(x, str):
        from PIL import Image

        return np.array(Image.open(x).convert(mode))
    return np.array(x)


def preprocess_image(x, img_height: int, img_width: int) -> Tuple[np.ndarray, np.ndarray]:
    """-> (image01 (1,H,W,3) in [0,1], tensor (1,H,W,3) in [-1,1]), fp32."""
    arr = load_image(x, "RGB")
    arr = bilinear_resize(arr, img_height, img_width)
    image01 = np.asarray(arr, dtype=np.float32)[None, ..., :3] / 255.0
    return image01, image01 * 2.0 - 1.0


def preprocess_mask(
    x, img_height: int, img_width: int, blur_radius: Optional[int] = 5
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (pixel mask (1,H,W,1) in [0,1], latent mask (1,H/8,W/8,1)), fp32.

    1 = region to generate, 0 = keep the original. An array mask is not converted
    to grayscale: its channels are averaged after the resize. No blur when
    ``blur_radius`` is None."""
    arr = load_image(x, "L")
    if arr.ndim == 2:
        arr = arr[..., None]
    arr = bilinear_resize(arr, img_height, img_width)
    if arr.shape[-1] != 1:
        arr = np.mean(arr, axis=-1, keepdims=True)
    mask = np.asarray(arr, dtype=np.float32) / 255.0
    if blur_radius is not None:
        mask = gaussian_blur(mask, radius=blur_radius, h_axis=0, v_axis=1)
    latent_mask = bilinear_resize(mask, img_height // 8, img_width // 8)
    return mask[None].astype(np.float32), latent_mask[None].astype(np.float32)
