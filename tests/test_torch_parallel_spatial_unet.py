"""Spatial sequence parallelism of the small UNet (widths (32, 64, 128, 128)) on 8
``gloo`` ranks, mesh (1, 8), ``min_seq=1024``, at 64x64 latents, against the
JAX package's ``unet.apply`` under the same mesh of the conftest's virtual
devices with its SP anchors on (``tests/test_sequence_parallel_hlo.py:30-38``'s
setting): rtol = atol = 2e-4. Then the pattern of collectives that the JAX HLO
test pins for GSPMD: no rank runs a level-0 conv on all 64 rows, the ring
shifts, and nothing of 1024 tokens or more is gathered except the
downsampler's output out of level 0 and ``conv_out``'s."""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_ranks as ranks
from minsdtf_tpu.models import unet as junet
from minsdtf_tpu.ops import attention as jattn
from minsdtf_tpu.parallel import mesh as jmesh
from minsdtf_tpu.parallel import sharding as jsharding
from minsdtf_tpu_torch.models import unet as tunet
from minsdtf_tpu_torch.parallel.mesh import run_ranks
from minsdtf_tpu_torch.weights.from_jax import from_jax
from torch_port_utils import one_torch_thread  # noqa: F401

N = 8
MIN_SEQ = 1024
TOL = 2e-4
W1 = ranks.SMALL["widths"][1]


@pytest.fixture(scope="module")
def runs():
    params = junet.init_params(jax.random.PRNGKey(0), dtype=jnp.float32, scale=0.04,
                               **ranks.SMALL)
    rng = np.random.RandomState(0)
    inputs = [rng.normal(0, 1, shape).astype(np.float32)
              for shape in ((2, 64, 64, 4), (2, 32), (2, 77, 768))]
    state = {k: v.numpy() for k, v in from_jax(params, tunet.UNet(**ranks.SMALL)).items()}
    with ThreadPoolExecutor(1) as pool:  # the ranks run while JAX compiles
        future = pool.submit(run_ranks, ranks.spatial_unet, N, (state, inputs, MIN_SEQ),
                             timeout_s=240)
        mesh = jmesh.make_mesh(data=1, model=N)
        jattn.set_sequence_parallel(mesh, "model", min_seq=MIN_SEQ)
        try:
            with mesh:
                want = np.asarray(jax.jit(junet.apply)(
                    jsharding.replicate_params(params, mesh), *(jnp.asarray(a) for a in inputs)))
        finally:
            jattn.set_sequence_parallel(None)
        return future.result(), want


def test_spatial_forward_matches_jax_under_the_same_mesh(runs):
    got, want = runs
    for rank in got:
        assert rank["out"].shape == (2, 64, 64, 4)
        np.testing.assert_allclose(rank["out"], want, rtol=TOL, atol=TOL)


def test_no_rank_runs_a_level_0_conv_on_all_rows(runs):
    got, _ = runs
    for rank in got:
        level0 = [shape for shape in rank["convs"] if shape[3] in (64, 66)]
        assert level0, rank["convs"]
        # 8 rows a rank plus at most one halo row on each side
        assert max(shape[2] for shape in level0) <= 64 // N + 2, level0


def test_the_ring_shifts_and_only_the_exits_of_level_0_are_gathered(runs):
    got, _ = runs
    for rank in got:
        # the self-attentions of levels 0 and 1, 5 each, on the sharded ring
        assert rank["ring_sharded"] == 10 and rank["ring_whole"] == 0
        assert rank["comm"]["ring_shift"] == 10 * (N - 1)
        assert rank["comm"]["halo"] > 0 and rank["comm"]["all_reduce"] > 0
        big = [(shape, dim) for shape, dim in rank["gathers"]
               if shape[2] * N * shape[3] >= MIN_SEQ]
        assert big == [((2, 4, 64 // N, 64), 2)], rank["gathers"]  # conv_out's rows
        # and the downsampler's output rows out of level 1 (16x16, 256 tokens)
        assert rank["gathers"] == [((2, W1, 16 // N, 16), 2)] + big
        assert rank["spatial"]["gather_rows"] == 2
