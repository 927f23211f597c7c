"""A whole small UNet with int8 sites in the port and in the JAX package, fp32 on
the CPU: fused against unfused sites (and ``from_jax`` across the two forms), and
dynamic, baked and hybrid sites against the JAX package's ``unet.apply`` with the
port's roundings held to its (``torch_port_utils.Int8Replay``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minsdtf_tpu import scheduler as jsched
from minsdtf_tpu.models import unet as junet
from minsdtf_tpu.weights import calibrate as jcalibrate
from minsdtf_tpu.weights import quantize as jquantize
from minsdtf_tpu_torch.models import unet as tunet
from minsdtf_tpu_torch.models.common import Int8Site, apply_dense
from minsdtf_tpu_torch.weights import calibrate as tcalibrate
from minsdtf_tpu_torch.weights import quantize as tquantize
from minsdtf_tpu_torch.weights.from_jax import install_int8_sites
from test_torch_int8 import SMALL, assert_sites_equal, port_unet, small_params, synthetic_scales
from torch_port_utils import Int8Replay, load, one_torch_thread  # noqa: F401

# The small UNet on the same int8 sites in each package, with the ties replayed:
# what is left is the fp32 difference of the float work, as in the float UNet's
# comparison (test_torch_models, 1e-4); test_small_unet_matches_jax prints it.
UNET_TOL = 1e-5


def test_fused_and_unfused_sites_equal():
    """Per-output-channel weight scales and per-token activation scales make a
    fused projection's int8 site the concatenation of the unfused ones, with the
    same outputs; from_jax moves quantized params across the two forms."""
    params = small_params()
    fused = tquantize.quantize_params(port_unet(params, fused=True), min_k=32)
    unfused = tquantize.quantize_params(port_unet(params, fused=False), min_k=32)
    attn = "mid_block.attentions.0.transformer_blocks.0"
    f1, u1 = fused.get_submodule(f"{attn}.attn1"), unfused.get_submodule(f"{attn}.attn1")
    f2, u2 = fused.get_submodule(f"{attn}.attn2"), unfused.get_submodule(f"{attn}.attn2")
    assert isinstance(f1.to_qkv, Int8Site) and isinstance(u1.to_q, Int8Site)
    for site, parts in ((f1.to_qkv, (u1.to_q, u1.to_k, u1.to_v)), (f2.to_kv, (u2.to_k, u2.to_v))):
        for leaf in ("weight_q", "weight_scale"):
            assert torch.equal(getattr(site, leaf), torch.cat([getattr(p, leaf) for p in parts]))
    rs = np.random.RandomState(9)
    x = torch.from_numpy(rs.normal(0, 1, (2, 16, 128)).astype(np.float32))
    ctx = torch.from_numpy(rs.normal(0, 1, (2, 77, 768)).astype(np.float32))
    with torch.inference_mode():
        assert torch.equal(apply_dense(f1.to_qkv, x),
                           torch.cat([apply_dense(p, x) for p in (u1.to_q, u1.to_k, u1.to_v)], -1))
        assert torch.equal(apply_dense(f2.to_kv, ctx),
                           torch.cat([apply_dense(p, ctx) for p in (u2.to_k, u2.to_v)], -1))
        latent = torch.from_numpy(rs.normal(0, 1, (2, 8, 8, 4)).astype(np.float32))
        t_emb = torch.from_numpy(jsched.timestep_embedding(np.array([999, 500]), dim=32))
        torch.testing.assert_close(fused(latent, t_emb, ctx), unfused(latent, t_emb, ctx),
                                   rtol=1e-6, atol=1e-6)
    # the JAX package's fused quantized params into the port's unfused UNet, and
    # its unfused ones into the port's fused UNet
    for target_fused, want in ((False, unfused), (True, fused)):
        source = params if target_fused else junet.fuse_attention_projections(params)
        jq = jquantize.quantize_params(source, min_k=32)
        model = tunet.UNet(**SMALL)
        if target_fused:
            tunet.fuse_attention_projections(model)
        model = load(install_int8_sites(jq, model), jq)
        got_sd, want_sd = model.state_dict(), want.state_dict()
        assert sorted(got_sd) == sorted(want_sd)
        for key in want_sd:
            assert torch.equal(got_sd[key], want_sd[key]), key


@pytest.mark.parametrize("mode", ["dynamic", "baked", "hybrid"])
def test_small_unet_matches_jax(mode):
    """The whole small UNet (CFG batch of 2) on the same int8 sites, with the
    port's roundings held to the JAX package's (``Int8Replay``: every difference
    must be a one-step tie of inputs within 1e-5 of the amax)."""
    params = junet.fuse_attention_projections(small_params())
    scales = synthetic_scales(params)
    jq = jquantize.quantize_params(params, min_k=64)
    unet = tquantize.quantize_params(port_unet(params), min_k=64)
    if mode == "baked":
        jq = jcalibrate.bake_act_scales(jq, scales, include_dense=True)
        unet = tcalibrate.bake_act_scales(unet, scales, include_dense=True)
    elif mode == "hybrid":
        jq = jquantize.hybridize_params(params, scales, min_k=64)
        unet = tquantize.hybridize_params(port_unet(params), scales, min_k=64)
    assert_sites_equal(unet, jq)
    rs = np.random.RandomState(10)
    latent = rs.normal(0, 1, (2, 8, 8, 4)).astype(np.float32)
    t_emb = jsched.timestep_embedding(np.array([999, 500]), dim=32)
    ctx = rs.normal(0, 1, (2, 77, 768)).astype(np.float32)
    replay = Int8Replay()
    with replay.recording():
        want = np.asarray(jax.jit(junet.apply)(jq, jnp.asarray(latent), jnp.asarray(t_emb),
                                               jnp.asarray(ctx)))
    with replay.replaying(), torch.inference_mode():
        got = unet(torch.from_numpy(latent), torch.from_numpy(t_emb), torch.from_numpy(ctx))
    assert len(replay.tape) == len(tquantize.int8_sites(unet))
    assert got.shape == want.shape
    print(f"{mode}: max |diff| {np.abs(got.numpy() - want).max():.3e} (max |y| "
          f"{np.abs(want).max():.3f}), {replay.flips} ties replayed")
    np.testing.assert_allclose(got.numpy(), want, rtol=UNET_TOL, atol=UNET_TOL)
