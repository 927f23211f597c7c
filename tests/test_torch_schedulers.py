"""The port's schedulers against the JAX package's: the Karras spacing, each host
``step()``, and the step loop's row update against the port's own ``step()``.
The rows of every mode are compared in ``test_torch_host.py``."""

import numpy as np
import pytest
import torch

from minsdtf_tpu import scheduler as jsched
from minsdtf_tpu_torch import sampler as tsampler
from minsdtf_tpu_torch import scheduler as tsched
from torch_port_utils import JAX_SCHEDULERS, one_torch_thread  # noqa: F401


@pytest.mark.parametrize("num_steps", [2, 3, 4, 10, 15, 25, 30, 50])
def test_karras_timesteps_equal(num_steps):
    """Equal where the JAX spacing is defined; where its snapped grid runs below
    t = 0 (50 steps), both raise."""
    acp = jsched.make_alphas_cumprod()
    try:
        want = jsched.karras_timesteps(num_steps, acp)
    except ValueError:
        with pytest.raises(ValueError, match="collapsed"):
            tsched.karras_timesteps(num_steps, tsched.make_alphas_cumprod())
        return
    got = tsched.karras_timesteps(num_steps, tsched.make_alphas_cumprod())
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (np.diff(got) < 0).all()


@pytest.mark.parametrize("scheduler_type,cls,mode", [
    ("ddim", tsched.Scheduler, "ddim"), ("euler", tsched.Scheduler, "ddim"),
    ("tcd", tsched.Scheduler, "tcd"), ("lcm", tsched.LCMScheduler, "lcm"),
    ("dpm", tsched.DPMSolverScheduler, "dpm"), ("dpm_karras", tsched.DPMSolverScheduler, "dpm"),
    ("euler_a", tsched.EulerAncestralScheduler, "euler_a"),
])
def test_make_scheduler(scheduler_type, cls, mode):
    sched = tsched.make_scheduler(scheduler_type)
    assert type(sched) is cls and sched.mode == mode
    assert getattr(sched, "karras_sigmas", False) == (scheduler_type == "dpm_karras")
    assert tsched.make_scheduler(None, active_tcd=True).mode == "tcd"
    with pytest.raises(ValueError, match="unknown scheduler_type"):
        tsched.make_scheduler("heun")


@pytest.mark.parametrize("mode", ["ddim", "tcd", "lcm", "dpm", "dpm_karras", "euler_a"])
def test_host_step_matches_jax(mode):
    """Each scheduler's host ``step`` over a whole schedule, bit for bit: TCD and
    LCM draw from numpy's global generator, seeded alike before each call, and
    Euler-a is given ``noise=``."""
    j = JAX_SCHEDULERS[mode]()
    t = tsched.make_scheduler(mode)
    j.set_timesteps(6)
    t.set_timesteps(6)
    np.testing.assert_array_equal(t.timesteps, j.timesteps)
    rs = np.random.RandomState(0)
    x_j = x_t = rs.normal(0, 1, (2, 4, 4, 4)).astype(np.float32)
    for i, ts in enumerate(t.timesteps):
        eps = rs.normal(0, 1, x_t.shape).astype(np.float32)
        kw = {}
        if mode == "euler_a":
            kw = dict(noise=rs.normal(0, 1, x_t.shape).astype(np.float32))
        np.random.seed(100 + i)
        x_j = j.step(eps, int(ts), x_j, eta=0.3, **kw)
        np.random.seed(100 + i)
        x_t = t.step(eps, int(ts), x_t, eta=0.3, **kw)
        np.testing.assert_array_equal(x_t, x_j)


class _LinearEps(torch.nn.Module):
    """A stand-in UNet: eps = a * x + b, the same for every timestep and context."""

    def forward(self, lat, t_emb, ctx, controls=None):
        return 0.3 * lat + 0.1


@pytest.mark.parametrize("mode", ["ddim", "tcd", "lcm", "dpm", "dpm_karras", "euler_a"])
def test_loop_update_matches_host_step(monkeypatch, mode):
    """The step loop's update from the schedule's rows equals the host ``step``
    chain, with the same z: TCD's and LCM's host steps draw theirs from numpy's
    generator, which the loop is handed as ``step_noise``."""
    num_steps, shape = 5, (2, 4, 4, 4)
    schedule = tsched.build_denoise_schedule(tsched.make_scheduler(mode), num_steps, eta=0.3)
    rs = np.random.RandomState(1)
    x0 = rs.normal(0, 1, shape).astype(np.float32)
    z = rs.normal(0, 1, (num_steps, *shape)).astype(np.float32)

    host = tsched.make_scheduler(mode)
    host.set_timesteps(num_steps)
    x = x0.astype(np.float64)
    for i, ts in enumerate(host.timesteps):
        eps = 0.3 * x + 0.1
        if mode == "euler_a":
            x = host.step(eps, int(ts), x, eta=0.3, noise=z[i])
        else:  # the host steps' own draw, replaced by z[i]
            monkeypatch.setattr(np.random, "randn", lambda *s, _z=z[i]: _z.astype(np.float64))
            x = host.step(eps, int(ts), x, eta=0.3)
    t_embs = torch.zeros(num_steps, 320)
    _, got = tsampler.generate(
        _LinearEps(), None, torch.from_numpy(x0), torch.zeros(1, 77, 768), None, t_embs,
        schedule.rows, 7.5, 0.0, mode=schedule.mode,
        step_noise=torch.from_numpy(z) if mode in ("tcd", "lcm", "euler_a") else None)
    np.testing.assert_allclose(got.numpy(), x, rtol=2e-5, atol=2e-5)


def test_unknown_mode_and_missing_noise_raise():
    schedule = tsched.build_denoise_schedule(tsched.Scheduler(active_tcd=False), 2)
    args = (_LinearEps(), None, torch.zeros(1, 4, 4, 4), torch.zeros(1, 77, 768), None,
            torch.zeros(2, 320), schedule.rows, 7.5, 0.0)
    with pytest.raises(ValueError, match="unknown sampler mode"):
        tsampler.generate(*args, mode="heun")
    for mode in ("lcm", "euler_a"):
        with pytest.raises(ValueError, match="needs step_noise"):
            tsampler.generate(*args, mode=mode)
    with pytest.raises(ValueError, match="step_noise is"):
        tsampler.generate(*args, mode="euler_a", step_noise=torch.zeros(3, 1, 4, 4, 4))
    sched = tsched.Scheduler()
    sched.mode = "heun"
    with pytest.raises(ValueError, match="unknown scheduler mode"):
        tsched.build_denoise_schedule(sched, 2)
