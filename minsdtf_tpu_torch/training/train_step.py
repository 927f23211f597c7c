"""Diffusion fine-tuning: the ε-prediction MSE loss and an AdamW step on the UNet.

The counterpart of ``minsdtf_tpu/training/train_step.py``: the same loss,
line for line, and optax's ``adamw`` defaults in ``torch.optim.AdamW``. The step
updates the module and the optimizer in place, which is PyTorch's idiom where
the JAX step returns new params and optimizer state.

Attention runs the plain path, selected by name around the forward and the
backward (:func:`minsdtf_tpu_torch.ops.attention.plain_scope`): K1 and K2 have no
backward, as the JAX kernels have none, and their wrappers raise if asked for a
gradient. Nothing falls back quietly.

Under a mesh (``make_train_step(mesh=...)``) each rank takes the step on its rows
of the batch (:func:`minsdtf_tpu_torch.parallel.sharding.shard_batch`) with the
UNet TP-sharded (:func:`~minsdtf_tpu_torch.parallel.sharding.shard_module`):
the TP gradients come from Megatron's ``f``/``g``, and after ``backward()`` every
gradient is averaged over the data axis, in one all-reduce, before the optimizer
steps. The returned loss is the mean over the whole batch, which is what the JAX
package's GSPMD step returns.
"""

from __future__ import annotations

from typing import Callable, Iterable, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from minsdtf_tpu_torch import scheduler as sched_lib
from minsdtf_tpu_torch.ops import attention
from minsdtf_tpu_torch.parallel import comm
from minsdtf_tpu_torch.parallel.mesh import DATA_AXIS, axis_size


class TrainBatch(NamedTuple):
    latents: torch.Tensor    # (B, h, w, 4) clean VAE latents (already scaled)
    context: torch.Tensor    # (B, S, 768) text conditioning
    timesteps: torch.Tensor  # (B,) int64 in [0, num_train_timesteps)
    noise: torch.Tensor      # (B, h, w, 4) target ε


def denoising_loss(unet: nn.Module, batch: TrainBatch, signal_rates: torch.Tensor,
                   noise_rates: torch.Tensor) -> torch.Tensor:
    """MSE(ε̂, ε) at per-example timesteps (forward process q(x_t|x_0) noising),
    computed in fp32; a 0-d tensor."""
    sr = signal_rates[batch.timesteps][:, None, None, None].to(batch.latents.dtype)
    nr = noise_rates[batch.timesteps][:, None, None, None].to(batch.latents.dtype)
    noised = sr * batch.latents + nr * batch.noise
    # the timestep-embedding width is the UNet's first time-embedding input
    # (320 for SD1.5; smaller for test-width models)
    t_dim = unet.time_embedding.linear_1.in_features
    t_emb = sched_lib.timestep_embedding_traced(batch.timesteps, dim=t_dim).to(
        batch.latents.dtype)
    eps = unet(noised, t_emb, batch.context)
    return torch.mean(torch.square(eps.float() - batch.noise.float()))


def adamw(params: Iterable[nn.Parameter], lr: float = 1e-5) -> torch.optim.Optimizer:
    """``optax.adamw(lr)``'s exact counterpart, with optax's defaults (its weight
    decay is 1e-4, not torch's 0.01)."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def make_train_step(
    optimizer: Optional[Callable[[Iterable[nn.Parameter]], torch.optim.Optimizer]] = None,
    num_train_timesteps: int = 1000,
    mesh=None,
):
    """-> (init_fn, step_fn). ``init_fn(unet)`` returns the optimizer over the
    UNet's parameters (``optimizer(params)``, :func:`adamw` by default);
    ``step_fn(unet, opt, batch)`` takes one step in place and returns the loss
    before it as a 0-d tensor on the UNet's device. The UNet's attention
    projections may be fused or not: AdamW is elementwise, so both give the same
    update. With ``mesh``, ``step_fn`` takes this rank's rows and a UNet sharded
    over the mesh, and returns the whole batch's loss (module docstring)."""
    optimizer = optimizer or adamw
    sched = sched_lib.Scheduler(active_tcd=False, num_train_timesteps=num_train_timesteps)
    host_rates = (sched.signal_rates.astype(np.float32), sched.noise_rates.astype(np.float32))
    rates = {}  # device -> (signal_rates, noise_rates), fp32 tensors

    def init_fn(unet: nn.Module) -> torch.optim.Optimizer:
        return optimizer(unet.parameters())

    def step_fn(unet: nn.Module, opt: torch.optim.Optimizer, batch: TrainBatch) -> torch.Tensor:
        device = next(unet.parameters()).device
        if device not in rates:
            rates[device] = tuple(torch.from_numpy(r).to(device) for r in host_rates)
        opt.zero_grad(set_to_none=True)
        with attention.plain_scope():
            loss = denoising_loss(unet, batch, *rates[device])
            loss.backward()
        loss = loss.detach()
        if mesh is not None and axis_size(mesh, DATA_AXIS) > 1:
            loss = _average_over_data(unet, loss, mesh)
        opt.step()
        return loss

    return init_fn, step_fn


def _average_over_data(unet: nn.Module, loss: torch.Tensor, mesh) -> torch.Tensor:
    """Every gradient of ``unet`` and ``loss`` averaged over the mesh's data axis in
    one all-reduce of their concatenation (one per dtype). Returns the mean loss."""
    group, n = mesh.get_group(DATA_AXIS), axis_size(mesh, DATA_AXIS)
    grads = [p.grad for p in unet.parameters() if p.grad is not None]
    by_dtype = {}
    for g in grads + [loss]:
        by_dtype.setdefault(g.dtype, []).append(g)
    for tensors in by_dtype.values():
        summed = comm.all_reduce_sum(torch.cat([t.reshape(-1) for t in tensors]), group)
        for t, part in zip(tensors, summed.split([t.numel() for t in tensors])):
            t.copy_(part.view_as(t) / n)
    return loss


def sample_batch(batch_size: int, latent_hw: int = 8, ctx_len: int = 77,
                 num_train_timesteps: int = 1000, dtype=torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None) -> TrainBatch:
    """A random batch for smoke runs, drawn on ``device`` from ``generator`` (a
    ``torch.Generator`` on that device; ``None`` seeds a new one with 0).
    Timesteps are uniform in [0, num_train_timesteps). It cannot reproduce the
    JAX package's threefry stream."""
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device, dtype=dtype)

    return TrainBatch(
        latents=normal(batch_size, latent_hw, latent_hw, 4),
        context=normal(batch_size, ctx_len, 768),
        timesteps=torch.randint(0, num_train_timesteps, (batch_size,), generator=generator,
                                device=device, dtype=torch.int64),
        noise=normal(batch_size, latent_hw, latent_hw, 4),
    )
