"""The port's training step (``minsdtf_tpu_torch/training/train_step.py``) against
the JAX package's (``minsdtf_tpu/training/train_step.py``), fp32 on the CPU at
small widths: the loss, every gradient, AdamW against ``optax.adamw`` on the same
gradients, two whole steps, the traced timestep embedding and the random batch.
The attention routing and the plain path the step takes are in
``test_torch_attention_impl.py``.

Params come from the JAX package's ``init_params`` and reach the port through
``weights.from_jax``; both sides take the same numpy batch (the port cannot
replay JAX's threefry stream). The JAX reference compiles one
``jax.value_and_grad(denoising_loss)`` for the whole file (about 20 s) and,
apart from it, one ``optax.adamw`` update whose learning rate lives in its
state, so that both rates below share the compile (op by op, the update took
17 s here)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from minsdtf_tpu import scheduler as jsched
from minsdtf_tpu.models import unet as junet
from minsdtf_tpu.training import train_step as jts
from minsdtf_tpu_torch import scheduler as tsched
from minsdtf_tpu_torch.models import unet as tunet
from minsdtf_tpu_torch.ops import attention as tattn
from minsdtf_tpu_torch.training import train_step as tts
from minsdtf_tpu_torch.weights.from_jax import from_jax
from torch_port_utils import one_torch_thread  # noqa: F401

SMALL = dict(widths=(32, 64, 128, 128), temb_dim=128)
LR = 1e-3  # large enough that two steps move the loss clearly

# Tolerances, fp32 on both sides. The forward agrees with JAX to ~1e-6 relative
# (tests/test_torch_models.py holds the UNet at 1e-4); the loss is a mean of
# squares of O(1) values.
LOSS_RTOL = 1e-5
# A gradient sums O(1e3..1e5) products whose order differs between XLA and torch:
# relative to the tensor's largest element, 1e-4; elementwise 1e-3 above that.
# Some gradients are zero in exact arithmetic (at width 32 each GroupNorm group is
# one channel, so a bias before it changes nothing) and hold fp32 noise of ~1e-8
# on both sides: the absolute floor is 1e-6 of the model's largest gradient.
GRAD_RTOL, GRAD_ATOL_REL, GRAD_ATOL_MODEL = 1e-3, 1e-4, 1e-6
# AdamW on identical gradients: both compute p - lr*(m̂/(√v̂+ε) + wd*p) in fp32,
# in another order; the parameters (|p| < 1) agree to a few ulps.
ADAMW_RTOL, ADAMW_ATOL = 1e-6, 1e-7
# Two whole steps: step 2's loss sees step 1's update, where Adam's first step
# m̂/(√v̂+ε) = g/(|g|+ε) turns a gradient near zero into ±1 either way (about 4e-4
# of the weights end up lr apart); those weights barely move the loss, which
# agrees to 1e-5 relative.
TWO_STEP_LOSS_RTOL = 1e-5


ADAMW = optax.inject_hyperparams(optax.adamw)


@jax.jit
def adamw_init(params, lr):
    return ADAMW(learning_rate=lr).init(params)


@jax.jit
def adamw_update(grads, state, params):
    """One ``optax.adamw`` step at the learning rate held in ``state``."""
    updates, state = ADAMW(learning_rate=0.0).update(grads, state, params)
    return optax.apply_updates(params, updates), state


def numpy_batch(batch_size: int, latent_hw: int, seed: int) -> dict:
    rs = np.random.RandomState(seed)
    return dict(
        latents=rs.normal(0, 1, (batch_size, latent_hw, latent_hw, 4)).astype(np.float32),
        context=rs.normal(0, 1, (batch_size, 77, 768)).astype(np.float32),
        timesteps=rs.randint(0, 1000, (batch_size,)).astype(np.int32),
        noise=rs.normal(0, 1, (batch_size, latent_hw, latent_hw, 4)).astype(np.float32),
    )


def torch_batch(batch: dict) -> tts.TrainBatch:
    return tts.TrainBatch(**{k: torch.from_numpy(v.astype(np.int64) if k == "timesteps" else v)
                             for k, v in batch.items()})


def port_unet(params, fused: bool) -> tunet.UNet:
    unet = tunet.UNet(**SMALL)
    if fused:
        tunet.fuse_attention_projections(unet)
    unet.load_state_dict(from_jax(params, unet))
    return unet


@pytest.fixture(scope="module")
def reference():
    """Two JAX steps of ``optax.adamw(LR)`` from the small params on one numpy
    batch of 4 at an 8x8 latent: the params before each step and after the
    second, the two losses and the two gradients, as numpy."""
    params = junet.init_params(jax.random.PRNGKey(0), jnp.float32, scale=0.04, **SMALL)
    batch = numpy_batch(4, 8, seed=3)
    jbatch = jts.TrainBatch(**{k: jnp.asarray(v) for k, v in batch.items()})
    sched = jsched.Scheduler(active_tcd=False)
    rates = (jnp.asarray(sched.signal_rates, jnp.float32),
             jnp.asarray(sched.noise_rates, jnp.float32))
    value_and_grad = jax.jit(jax.value_and_grad(jts.denoising_loss))
    state = adamw_init(params, LR)
    out = dict(batch=batch, params=[jax.tree.map(np.asarray, params)], losses=[], grads=[])
    for _ in range(2):
        loss, grads = value_and_grad(params, jbatch, *rates)
        params, state = adamw_update(grads, state, params)
        out["losses"].append(float(loss))
        out["grads"].append(jax.tree.map(np.asarray, grads))
        out["params"].append(jax.tree.map(np.asarray, params))
    return out


@pytest.mark.parametrize("fused", [True, False])
def test_loss_and_every_gradient_match_jax(reference, fused):
    unet = port_unet(reference["params"][0], fused)
    sched = tsched.Scheduler(active_tcd=False)
    rates = [torch.from_numpy(r.astype(np.float32))
             for r in (sched.signal_rates, sched.noise_rates)]
    with tattn.plain_scope():
        loss = tts.denoising_loss(unet, torch_batch(reference["batch"]), *rates)
        loss.backward()
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(loss.item(), reference["losses"][0], rtol=LOSS_RTOL)
    want = {k: w.numpy() for k, w in from_jax(reference["grads"][0], unet).items()}
    got = {name: p.grad for name, p in unet.named_parameters()}
    assert got.keys() == want.keys()
    floor = GRAD_ATOL_MODEL * max(np.abs(w).max() for w in want.values())
    for name, g in got.items():
        assert g is not None, name
        atol = max(GRAD_ATOL_REL * np.abs(want[name]).max(), floor)
        np.testing.assert_allclose(g.numpy(), want[name], rtol=GRAD_RTOL, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("lr", [None, LR])
def test_adamw_matches_optax_on_the_same_gradients(reference, lr):
    """``None``: the port's default optimizer against ``optax.adamw(1e-5)``, the
    JAX step's default. At ``LR`` the reference's own two updates are the JAX
    side."""
    p0, g0, g1 = reference["params"][0], *reference["grads"]
    if lr is None:
        params, state = p0, adamw_init(p0, 1e-5)
        for grads in (g0, g1):
            params, state = adamw_update(grads, state, params)
    else:
        params = reference["params"][2]
    unet = port_unet(p0, fused=True)
    torch_opt = tts.adamw(unet.parameters()) if lr is None else tts.adamw(unet.parameters(), lr)
    for grads in (g0, g1):
        for name, g in from_jax(grads, unet).items():
            unet.get_parameter(name).grad = g
        torch_opt.step()
    want, start = from_jax(jax.tree.map(np.asarray, params), unet), from_jax(p0, unet)
    for name, p in unet.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=ADAMW_RTOL,
                                   atol=ADAMW_ATOL, err_msg=name)
        assert not torch.equal(p.detach(), start[name]), name


@pytest.mark.parametrize("fused", [True, False])
def test_two_steps_match_jax_and_the_loss_falls(reference, fused):
    unet = port_unet(reference["params"][0], fused)
    init_fn, step_fn = tts.make_train_step(functools.partial(tts.adamw, lr=LR))
    opt = init_fn(unet)
    batch = torch_batch(reference["batch"])
    losses = [float(step_fn(unet, opt, batch)) for _ in range(2)]
    np.testing.assert_allclose(losses, reference["losses"], rtol=TWO_STEP_LOSS_RTOL)
    assert losses[1] < losses[0], losses


@pytest.mark.parametrize("dim", [320, 128])
def test_timestep_embedding_traced_matches_jax(dim):
    t = np.array([0, 1, 17, 250, 500, 999], np.int64)
    want = np.asarray(jsched.timestep_embedding_traced(jnp.asarray(t, jnp.int32), dim=dim))
    got = tsched.timestep_embedding_traced(torch.from_numpy(t), dim=dim)
    assert got.dtype == torch.float32 and got.shape == (6, dim)
    # the same fp32 arguments; cos and sin differ by an ulp or two between libraries
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)


def test_sample_batch_shapes_range_and_seed():
    def draw(seed):
        gen = torch.Generator(device="cpu").manual_seed(seed)
        return tts.sample_batch(64, latent_hw=16, ctx_len=20, num_train_timesteps=50,
                                device="cpu", generator=gen)

    batch = draw(1)
    assert batch.latents.shape == batch.noise.shape == (64, 16, 16, 4)
    assert batch.context.shape == (64, 20, 768)
    assert batch.timesteps.shape == (64,) and batch.timesteps.dtype == torch.int64
    assert all(t.dtype == torch.float32 for t in (batch.latents, batch.context, batch.noise))
    assert int(batch.timesteps.min()) >= 0 and int(batch.timesteps.max()) < 50
    assert len(set(batch.timesteps.tolist())) > 20
    again, other = draw(1), draw(2)
    for a, b, c in zip(batch, again, other):
        assert torch.equal(a, b) and not torch.equal(a, c)
    assert all(torch.equal(a, b) for a, b in zip(
        tts.sample_batch(2, device="cpu"), tts.sample_batch(2, device="cpu")))
    bf16 = tts.sample_batch(2, dtype=torch.bfloat16, device="cpu")
    assert bf16.latents.dtype == torch.bfloat16 and bf16.timesteps.dtype == torch.int64
