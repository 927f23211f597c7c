"""The port's DDIM+CFG step loop against the JAX package's golden latent, and its
two-call CFG fallback, fp32 on the CPU at small UNet widths."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from minsdtf_tpu.models import unet as junet
from minsdtf_tpu_torch import sampler as tsampler
from minsdtf_tpu_torch import scheduler as tsched
from minsdtf_tpu_torch.models import unet as tunet
from torch_port_utils import load, one_torch_thread  # noqa: F401

MODULE_TOL = 1e-4
LATENT_TOL = 5e-5
SMALL = dict(widths=(32, 64, 128, 128), temb_dim=128)
GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden", "sampler_latent.npz")


def test_sampler_reproduces_golden_latent():
    """The inputs of tests/test_golden_regression.py through the port's step loop."""
    params = junet.fuse_attention_projections(
        junet.init_params(jax.random.PRNGKey(0), dtype=jnp.float32, scale=0.04, **SMALL))
    unet = tunet.fuse_attention_projections(tunet.UNet(**SMALL))
    load(unet, params)
    schedule = tsched.build_denoise_schedule(tsched.Scheduler(active_tcd=False), 3)
    t_embs = tsched.timestep_embedding(schedule.timesteps, dim=32)
    rows = {k: getattr(schedule, k) for k in tsched.ROW_KEYS}
    rng = np.random.RandomState(42)
    latent0 = rng.normal(0, 1, (1, 8, 8, 4)).astype(np.float32)
    ctx = rng.normal(0, 1, (1, 77, 768)).astype(np.float32)
    unc = rng.normal(0, 1, (1, 77, 768)).astype(np.float32)
    # oneDNN's fp32 convolutions sum in another order than a plain GEMM and double
    # the UNet's fp32 error against a float64 reference (4.0e-6 vs 2.1e-6, below
    # XLA's 2.7e-6); CFG x7.5 and the 1/sr_t of the DDIM update amplify it 40-fold
    with torch.backends.mkldnn.flags(enabled=False):
        _, latent = tsampler.generate(
            unet, None, torch.from_numpy(latent0), torch.from_numpy(ctx), torch.from_numpy(unc),
            torch.from_numpy(t_embs), rows, 7.5, 0.7)
    with open(GOLDEN_PATH, "rb") as f:
        golden = np.load(f)["latent"]
    np.testing.assert_allclose(latent.numpy(), golden, rtol=LATENT_TOL, atol=LATENT_TOL)


def test_sampler_two_call_fallback_matches_batched():
    """Unequal cond/uncond context lengths take two UNet calls a step; with equal
    contents padded to the same length the batched pair gives the same latent."""
    unet = tunet.UNet(**SMALL)
    load(unet, junet.init_params(jax.random.PRNGKey(5), scale=0.04, **SMALL))
    schedule = tsched.build_denoise_schedule(tsched.Scheduler(active_tcd=False), 2)
    t_embs = torch.from_numpy(tsched.timestep_embedding(schedule.timesteps, dim=32))
    rows = {k: getattr(schedule, k) for k in tsched.ROW_KEYS}
    rs = np.random.RandomState(6)
    latent0 = torch.from_numpy(rs.normal(0, 1, (1, 8, 8, 4)).astype(np.float32))
    ctx = torch.from_numpy(rs.normal(0, 1, (1, 77, 768)).astype(np.float32))
    unc = torch.from_numpy(rs.normal(0, 1, (1, 77, 768)).astype(np.float32))
    _, batched = tsampler.generate(unet, None, latent0, ctx, unc, t_embs, rows, 7.5, 0.7)
    ctx2 = torch.cat([ctx, ctx], dim=1)  # 154 tokens: same attention output per query
    _, split = tsampler.generate(unet, None, latent0, ctx2, unc, t_embs, rows, 7.5, 0.7)
    np.testing.assert_allclose(split.numpy(), batched.numpy(), rtol=MODULE_TOL, atol=MODULE_TOL)
