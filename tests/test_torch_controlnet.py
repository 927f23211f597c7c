"""The port's ControlNet modules against the JAX package, fp32 on the CPU at small
widths: the HintNet, the control branch's 13 residuals, and the UNet with those
residuals (``tests/test_torch_controlnet_pipeline.py`` holds the pipeline)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minsdtf_tpu import scheduler as jsched
from minsdtf_tpu.models import controlnet as jcontrolnet
from minsdtf_tpu.models import unet as junet
from minsdtf_tpu_torch.models import controlnet as tcontrolnet
from minsdtf_tpu_torch.models import unet as tunet
from torch_port_utils import load, nchw, one_torch_thread, perturb_norms  # noqa: F401

MODULE_TOL = 1e-4
SMALL = dict(widths=(32, 64, 128, 128), temb_dim=128)


@pytest.fixture(scope="module")
def controlnet():
    """JAX ControlNet params at small widths and the port's module holding them."""
    params = perturb_norms(jcontrolnet.init_params(jax.random.PRNGKey(3), scale=0.04, **SMALL), 5)
    return params, load(tcontrolnet.ControlNet(**SMALL), params)


@pytest.fixture(scope="module")
def inputs():
    rs = np.random.RandomState(6)
    return dict(
        latent=rs.normal(0, 1, (2, 16, 8, 4)).astype(np.float32),
        t_emb=jsched.timestep_embedding(np.array([999, 500]), dim=32),
        ctx=rs.normal(0, 1, (2, 77, 768)).astype(np.float32),
        hint=rs.normal(0, 1, (2, 16, 8, 32)).astype(np.float32),
        image=rs.uniform(0, 1, (2, 128, 64, 3)).astype(np.float32),
    )


def test_hint_net_matches(controlnet, inputs):
    params, module = controlnet
    want = np.asarray(jcontrolnet.hint_net(params, jnp.asarray(inputs["image"])))
    with torch.inference_mode():
        got = module.controlnet_cond_embedding(torch.from_numpy(inputs["image"]))
    assert want.shape == (2, 16, 8, 32) and tuple(got.shape) == (2, 32, 16, 8)
    np.testing.assert_allclose(got.numpy(), want.transpose(0, 3, 1, 2),
                               rtol=MODULE_TOL, atol=MODULE_TOL)


@pytest.mark.parametrize("fused", [False, True])
def test_control_residuals_match(controlnet, inputs, fused):
    params, module = controlnet
    if fused:  # the pipeline fuses the projections; the JAX package does not
        module = load(tunet.fuse_attention_projections(tcontrolnet.ControlNet(**SMALL)), params)
    want = jcontrolnet.apply(params, *(jnp.asarray(inputs[k]) for k in
                                       ("latent", "t_emb", "ctx", "hint")))
    with torch.inference_mode():
        got = module(*(torch.from_numpy(inputs[k]) for k in ("latent", "t_emb", "ctx")),
                     nchw(inputs["hint"]))
    assert len(got) == len(want) == 13
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=MODULE_TOL, atol=MODULE_TOL)


def test_unet_with_controls_matches(inputs):
    params = perturb_norms(junet.init_params(jax.random.PRNGKey(0), scale=0.04, **SMALL), 1)
    unet = load(tunet.UNet(**SMALL), params)
    # the 12 skips (conv_in, then each level's pairs and downsample) and the mid block
    shapes = ([(16, 8, 32)] * 3 + [(8, 4, 32)] + [(8, 4, 64)] * 2 + [(4, 2, 64)]
              + [(4, 2, 128)] * 2 + [(2, 1, 128)] * 4)
    rs = np.random.RandomState(7)
    controls = [rs.normal(0, 0.5, (2,) + s).astype(np.float32) for s in shapes]
    args = [inputs[k] for k in ("latent", "t_emb", "ctx")]
    want = np.asarray(junet.apply(params, *map(jnp.asarray, args),
                                  controls=tuple(map(jnp.asarray, controls))))
    plain = np.asarray(junet.apply(params, *map(jnp.asarray, args)))
    with torch.inference_mode():
        got = unet(*map(torch.from_numpy, args), controls=[nchw(c) for c in controls])
    assert np.abs(want - plain).max() > 1e-2  # the residuals change the output
    np.testing.assert_allclose(got.numpy(), want, rtol=MODULE_TOL, atol=MODULE_TOL)
