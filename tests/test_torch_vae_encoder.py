"""The port's VAE encoder against the JAX package's ``vae.encode``, fp32 on the CPU
at small widths, and the split of the JAX VAE params into encoder and decoder."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minsdtf_tpu.models import vae as jvae
from minsdtf_tpu_torch.models import vae as tvae
from minsdtf_tpu_torch.weights.from_jax import split_vae
from torch_port_utils import load, one_torch_thread, perturb_norms  # noqa: F401

MODULE_TOL = 1e-4
ENC = (32, 32, 64, 64)
DEC = (64, 64, 32, 32)


@pytest.fixture(scope="module")
def vae_params():
    return perturb_norms(jvae.init_params(jax.random.PRNGKey(2), scale=0.05,
                                          enc_widths=ENC, dec_widths=DEC), 3)


@pytest.mark.parametrize("h,w", [(64, 64), (64, 48)])
def test_vae_encode_matches(vae_params, h, w):
    encoder = load(tvae.VAEEncoder(ENC), split_vae(vae_params)[0])
    image = np.random.RandomState(4).uniform(-1, 1, (1, h, w, 3)).astype(np.float32)
    want = np.asarray(jvae.encode(vae_params, jnp.asarray(image)))
    with torch.inference_mode():
        got = encoder(torch.from_numpy(image))
    assert got.shape == want.shape == (1, h // 8, w // 8, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=MODULE_TOL, atol=MODULE_TOL)


def test_split_vae_feeds_both_modules(vae_params):
    enc, dec = split_vae(vae_params)
    assert set(enc) | set(dec) == set(vae_params) and not set(enc) & set(dec)
    assert "quant_conv" in enc and "post_quant_conv" in dec
    # each half loads with no key missing or left over (from_jax raises otherwise)
    load(tvae.VAEEncoder(ENC), enc)
    load(tvae.VAEDecoder(DEC), dec)
    specs = tvae.encoder_param_specs(ENC)
    assert len(specs) == sum(len(leaves) for leaves in enc.values())
    full = jvae.param_specs()
    assert tvae.encoder_param_specs() == {
        f"{name}.{'bias' if leaf == 'bias' else 'weight'}": _torch_shape(shape)
        for name, leaves in full.items() if name.startswith("encoder.") or name == "quant_conv"
        for leaf, shape in leaves.items()}


def _torch_shape(shape):
    """A JAX conv kernel's HWIO shape as OIHW; other shapes as they are."""
    return (shape[3], shape[2], shape[0], shape[1]) if len(shape) == 4 else tuple(shape)
