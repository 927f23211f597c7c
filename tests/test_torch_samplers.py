"""The port's step loop in every mode against ``minsdtf_tpu.sampler.generate``, fp32
on the CPU at small UNet widths, batch 2 under CFG: DPM-Solver++(2M), LCM, Euler-a,
TCD stochastic and deterministic, v-prediction and the per-step trajectory. The
stochastic modes get JAX's own fold_in noise as ``step_noise``. Also DPM against
the JAX package's golden latent."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minsdtf_tpu import sampler as jsampler
from minsdtf_tpu import scheduler as jsched
from minsdtf_tpu.models import unet as junet
from minsdtf_tpu_torch import sampler as tsampler
from minsdtf_tpu_torch import scheduler as tsched
from minsdtf_tpu_torch.models import unet as tunet
from torch_port_utils import JAX_SCHEDULERS, jax_step_noise, load, one_torch_thread  # noqa: F401

SAMPLER_TOL = 2e-4  # as tests/test_sampler.py holds the scan against its host loop
GOLDEN_TOL = 5e-5
SMALL = dict(widths=(32, 64, 128, 128), temb_dim=128)
DPM_GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden", "sampler_latent_dpm.npz")
SEED = 9


@pytest.fixture(scope="module")
def unets():
    params = junet.fuse_attention_projections(
        junet.init_params(jax.random.PRNGKey(0), dtype=jnp.float32, scale=0.04, **SMALL))
    return params, load(tunet.fuse_attention_projections(tunet.UNet(**SMALL)), params)


def _inputs(batch=2):
    rs = np.random.RandomState(3)
    latent0 = rs.normal(0, 1, (batch, 8, 8, 4)).astype(np.float32)
    ctx = rs.normal(0, 1, (batch, 77, 768)).astype(np.float32)
    unc = rs.normal(0, 1, (1, 77, 768)).astype(np.float32)
    return latent0, ctx, unc


# case: (scheduler, eta, v_prediction, trace_latents); each is one JAX compile, so
# v-prediction and the trajectory ride on other cases
CASES = {
    "dpm": ("dpm", 0.3, False, False),
    "lcm": ("lcm", 0.3, False, False),
    "euler_a_trace_latents": ("euler_a", 0.3, False, True),
    "tcd_stochastic": ("tcd", 0.3, False, False),
    "tcd_deterministic_v_prediction": ("tcd", 0.0, True, False),
    "ddim_v_prediction": ("ddim", 0.3, True, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_loop_matches_jax_sampler(unets, case):
    sched_name, eta, v_pred, trace = CASES[case]
    params, unet = unets
    schedule = tsched.build_denoise_schedule(tsched.make_scheduler(sched_name), 4, eta=eta)
    t_embs = tsched.timestep_embedding(schedule.timesteps, dim=32)
    latent0, ctx, unc = _inputs()
    mode = schedule.mode
    stochastic = mode in ("lcm", "euler_a") or (mode == "tcd" and eta > 0)
    jschedule = jsched.build_denoise_schedule(JAX_SCHEDULERS[sched_name](), 4, eta=eta)
    jrows = {k: np.asarray(getattr(jschedule, k), np.float32) for k in tsched.ROW_KEYS}
    # with the flags the JAX pipeline passes for this schedule (minsdtf_tpu/pipeline.py)
    want = jsampler.generate(
        params, None, jnp.asarray(latent0), jnp.asarray(ctx), jnp.asarray(unc),
        jnp.asarray(t_embs), jrows, jnp.float32(7.5), jnp.float32(0.7),
        noise_key=jax.random.fold_in(jax.random.PRNGKey(SEED), 1) if stochastic else None,
        use_cfg=True, active_tcd=mode == "tcd", stochastic=mode == "tcd" and eta > 0,
        lcm=mode == "lcm", dpm=mode == "dpm", euler_a=mode == "euler_a",
        v_prediction=v_pred, trace_latents=trace,
        use_controls=False, use_inpaint=False, decode=False)
    step_noise = jax_step_noise(SEED, (4, *latent0.shape)) if stochastic else None
    # oneDNN's fp32 convolutions sum in another order than XLA's and double the
    # UNet's error (test_torch_sampler.py); CFG x7.5 amplifies it
    with torch.backends.mkldnn.flags(enabled=False):
        got = tsampler.generate(
            unet, None, torch.from_numpy(latent0), torch.from_numpy(ctx), torch.from_numpy(unc),
            torch.from_numpy(t_embs), schedule.rows, 7.5, 0.7, mode=mode, step_noise=step_noise,
            v_prediction=v_pred, trace_latents=trace)
    assert len(got) == len(want) == (3 if trace else 2)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=SAMPLER_TOL, atol=SAMPLER_TOL)
    if trace:
        assert got[2].shape == (4, *latent0.shape)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=SAMPLER_TOL, atol=SAMPLER_TOL)
        np.testing.assert_array_equal(got[2][-1].numpy(), got[1].numpy())


def test_dpm_reproduces_golden_latent(unets):
    """The inputs of tests/test_golden_regression.py::test_golden_latent_dpm through
    the port's DPM loop."""
    _, unet = unets
    schedule = tsched.build_denoise_schedule(tsched.DPMSolverScheduler(), 4)
    t_embs = tsched.timestep_embedding(schedule.timesteps, dim=32)
    rng = np.random.RandomState(42)
    latent0 = rng.normal(0, 1, (1, 8, 8, 4)).astype(np.float32)
    ctx = rng.normal(0, 1, (1, 77, 768)).astype(np.float32)
    unc = rng.normal(0, 1, (1, 77, 768)).astype(np.float32)
    with torch.backends.mkldnn.flags(enabled=False):
        _, latent = tsampler.generate(
            unet, None, torch.from_numpy(latent0), torch.from_numpy(ctx), torch.from_numpy(unc),
            torch.from_numpy(t_embs), schedule.rows, 7.5, 0.7, mode="dpm")
    with open(DPM_GOLDEN_PATH, "rb") as f:
        golden = np.load(f)["latent"]
    np.testing.assert_allclose(latent.numpy(), golden, rtol=GOLDEN_TOL, atol=GOLDEN_TOL)
