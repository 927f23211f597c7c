"""The port's UNet and VAE decoder against the JAX package, fp32 on the CPU at
small widths. Params come from the JAX package's ``init_params`` and reach the
port through ``weights.from_jax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minsdtf_tpu import scheduler as jsched
from minsdtf_tpu.models import unet as junet
from minsdtf_tpu.models import vae as jvae
from minsdtf_tpu_torch.models import unet as tunet
from minsdtf_tpu_torch.models import vae as tvae
from torch_port_utils import load, one_torch_thread, perturb_norms  # noqa: F401

MODULE_TOL = 1e-4
SMALL = dict(widths=(32, 64, 128, 128), temb_dim=128)


@pytest.mark.parametrize("fused", [True, False])
def test_unet_apply_matches(fused):
    params = perturb_norms(junet.init_params(jax.random.PRNGKey(0), scale=0.04, **SMALL), 1)
    if fused:
        params = junet.fuse_attention_projections(params)
    unet = tunet.UNet(**SMALL)
    if fused:
        tunet.fuse_attention_projections(unet)
    load(unet, params)
    rs = np.random.RandomState(2)
    latent = rs.normal(0, 1, (2, 16, 8, 4)).astype(np.float32)
    t_emb = jsched.timestep_embedding(np.array([999, 500]), dim=32)
    ctx = rs.normal(0, 1, (2, 77, 768)).astype(np.float32)
    want = np.asarray(junet.apply(params, jnp.asarray(latent), jnp.asarray(t_emb),
                                  jnp.asarray(ctx)))
    with torch.inference_mode():
        got = unet(torch.from_numpy(latent), torch.from_numpy(t_emb), torch.from_numpy(ctx))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=MODULE_TOL, atol=MODULE_TOL)


def test_vae_decode_matches():
    widths = (64, 64, 32, 32)
    params = perturb_norms(jvae.init_params(jax.random.PRNGKey(2), scale=0.05,
                                             enc_widths=(32, 32, 64, 64), dec_widths=widths), 3)
    dec_params = {k: v for k, v in params.items()
                  if not k.startswith("encoder.") and k != "quant_conv"}
    decoder = load(tvae.VAEDecoder(widths), dec_params)
    latent = np.random.RandomState(4).normal(0, 1, (1, 8, 6, 4)).astype(np.float32)
    want = np.asarray(jvae.decode(params, jnp.asarray(latent)))
    with torch.inference_mode():
        got = decoder(torch.from_numpy(latent))
    assert got.shape == want.shape == (1, 64, 48, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=MODULE_TOL, atol=MODULE_TOL)
