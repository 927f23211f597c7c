"""The port's train step under DP x TP on 4 ``gloo`` ranks, mesh (2, 2), against the
JAX package's ``make_train_step`` under a (2, 2) mesh of the conftest's virtual
devices, on the same numpy batch of 4 at an 8x8 latent and the same small params:
two steps of ``adamw(1e-3)``. The losses agree to rtol 1e-5, and the weights after
two steps as ``tests/test_torch_training.py`` and ``chip_smoke.py`` 10b hold two
steps: Adam's first step turns a gradient within rounding of zero into +-1 either
way, so at most 1e-3 of the weights may end up more than lr/100 apart. (The JAX
package's own test, ``test_sharding.py:155``, asks only that the loss fall.)"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import NamedSharding, PartitionSpec as P
import pytest
import torch

import torch_parallel_ranks as ranks
from minsdtf_tpu.models import unet as junet
from minsdtf_tpu.parallel import mesh as jmesh
from minsdtf_tpu.parallel import sharding as jsharding
from minsdtf_tpu.training import train_step as jts
from minsdtf_tpu_torch.models import unet as tunet
from minsdtf_tpu_torch.parallel import sharding as tsharding
from minsdtf_tpu_torch.parallel.mesh import run_ranks
from minsdtf_tpu_torch.weights.from_jax import from_jax
from torch_port_utils import one_torch_thread  # noqa: F401

LR = 1e-3
LOSS_RTOL = 1e-5
PARAM_SHARE = 1e-3  # of the weights may be more than LR / 100 apart


def numpy_batch(batch_size: int, latent_hw: int, seed: int) -> dict:
    rs = np.random.RandomState(seed)
    return dict(
        latents=rs.normal(0, 1, (batch_size, latent_hw, latent_hw, 4)).astype(np.float32),
        context=rs.normal(0, 1, (batch_size, 77, 768)).astype(np.float32),
        timesteps=rs.randint(0, 1000, (batch_size,)).astype(np.int32),
        noise=rs.normal(0, 1, (batch_size, latent_hw, latent_hw, 4)).astype(np.float32),
    )


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    params = junet.init_params(jax.random.PRNGKey(0), jnp.float32, scale=0.04, **ranks.SMALL)
    batch = numpy_batch(4, 8, seed=3)
    path = tmp_path_factory.mktemp("train") / "unet.pt"
    torch.save(from_jax(params, tunet.UNet(**ranks.SMALL)), path)
    with ThreadPoolExecutor(1) as pool:  # the ranks run while JAX compiles
        future = pool.submit(run_ranks, ranks.train_steps, 4, (str(path), batch, LR),
                             timeout_s=300)
        mesh = jmesh.make_mesh(data=2, model=2, devices=jax.devices()[:4])
        placed = jsharding.shard_params(params, mesh)
        init_fn, step_fn = jts.make_train_step(optimizer=optax.adamw(LR))
        # every optimizer leaf committed to the mesh (the step count is on one
        # device otherwise), so that both steps see the same input shardings and
        # the second reuses the compiled step (another compile took 40 s here)
        opt_state = jax.tree.map(
            lambda x: jax.device_put(x, NamedSharding(mesh, P())) if x.ndim == 0 else x,
            init_fn(placed))
        jbatch = jts.TrainBatch(**{k: jsharding.shard_batch(jnp.asarray(v), mesh)
                                   for k, v in batch.items()})
        losses = []
        with mesh:
            for _ in range(2):
                placed, opt_state, loss = step_fn(placed, opt_state, jbatch)
                losses.append(float(loss))
        got = future.result()
    whole = {k: v.numpy() for k, v in from_jax(jax.tree.map(np.asarray, placed),
                                                tunet.UNet(**ranks.SMALL)).items()}
    return got, losses, whole


def test_losses_match_jax(runs):
    got, want, _ = runs
    for rank in got:
        np.testing.assert_allclose(rank["losses"], want, rtol=LOSS_RTOL)
    assert want[1] < want[0]


def test_weights_after_two_steps_match_jax(runs):
    got, _, whole = runs
    for rank in got:
        diffs = []
        for name, value in rank["params"].items():
            want = tsharding.shard_tensor(name, torch.from_numpy(whole[name]),
                                          rank["model_rank"], 2).numpy()
            assert value.shape == want.shape, name
            diffs.append(np.abs(value - want).ravel())
        diffs = np.concatenate(diffs)
        assert (diffs > LR / 100).mean() <= PARAM_SHARE, (diffs > LR / 100).mean()
        assert diffs.max() <= 3 * LR, diffs.max()


def test_data_ranks_agree_and_model_ranks_hold_their_shards(runs):
    """Ranks of one model rank (data ranks 0 and 1) hold the same weights after
    the averaged steps; the two model ranks hold different shards."""
    got, _, _ = runs
    by_model = {}
    for rank in got:
        by_model.setdefault(rank["model_rank"], []).append(rank["params"])
    assert sorted(by_model) == [0, 1]
    for same in by_model.values():
        for name in same[0]:
            np.testing.assert_array_equal(same[0][name], same[1][name], name)
    name = "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight"
    assert not np.array_equal(by_model[0][0][name], by_model[1][0][name])
