"""The small UNet's forward sharded over 8 ``gloo`` ranks, meshes (8, 1) and (4, 2),
against the JAX package's ``unet.apply`` under the same meshes of the conftest's
virtual devices, at ``tests/test_sharding.py``'s setting: fp32, batch 8 at an 8x8
latent, rtol = atol = 2e-4. The ranks take their rows of the batch, shard the
UNet by ``parallel.sharding.shard_module`` and gather the output."""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from minsdtf_tpu.models import unet as junet
from minsdtf_tpu.parallel import mesh as jmesh
from minsdtf_tpu.parallel import sharding as jsharding
from minsdtf_tpu_torch.models import unet as tunet
from minsdtf_tpu_torch.parallel.mesh import run_ranks
from minsdtf_tpu_torch.weights.from_jax import from_jax
from torch_port_utils import one_torch_thread  # noqa: F401

MESHES = [(8, 1), (4, 2)]
TOL = 2e-4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    params = junet.init_params(jax.random.PRNGKey(0), dtype=jnp.float32, scale=0.04,
                               **ranks.SMALL)
    rng = np.random.RandomState(0)
    inputs = [rng.normal(0, 1, shape).astype(np.float32)
              for shape in ((8, 8, 8, 4), (8, 32), (8, 77, 768))]
    path = tmp_path_factory.mktemp("unet") / "unet.pt"
    unet = tunet.UNet(**ranks.SMALL)
    torch.save(from_jax(params, unet), path)
    with ThreadPoolExecutor(1) as pool:  # the ranks run while JAX compiles
        future = pool.submit(run_ranks, ranks.unet_forward, 8, (str(path), inputs, MESHES),
                             timeout_s=300)
        want = {}
        for data, model in MESHES:
            mesh = jmesh.make_mesh(data=data, model=model)
            placed = jsharding.shard_params(params, mesh)
            with mesh:
                want[(data, model)] = np.asarray(jax.jit(junet.apply)(
                    placed, *(jsharding.shard_batch(jnp.asarray(a), mesh) for a in inputs)))
        return future.result(), want


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_forward_matches_jax_under_the_same_mesh(runs, mesh):
    got, want = runs
    for rank_out in got:
        np.testing.assert_allclose(rank_out[mesh], want[mesh], rtol=TOL, atol=TOL)


def test_every_rank_returns_the_whole_batch(runs):
    got, _ = runs
    for mesh in MESHES:
        assert got[0][mesh].shape == (8, 8, 8, 4)
        for rank_out in got[1:]:
            np.testing.assert_array_equal(rank_out[mesh], got[0][mesh])
