"""The port's ring attention (``minsdtf_tpu_torch/ops/ring_attention.py``) on 2, 4
and 8 ``gloo`` ranks against the JAX package's ``ring_multi_head_attention`` on
as many of the conftest's virtual devices, and against the port's
``plain_attention`` on one process, at ``tests/test_ring_attention.py``'s shapes
and inputs: fp32, rtol = atol = 2e-4. Also the SP routing of
``ops/attention.py`` inside ``sequence_parallel_scope``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from minsdtf_tpu.ops.ring_attention import ring_multi_head_attention as jax_ring
from minsdtf_tpu.parallel import mesh as jmesh
from minsdtf_tpu_torch.ops import attention as tattn
from minsdtf_tpu_torch.parallel.mesh import run_ranks
from torch_port_utils import one_torch_thread  # noqa: F401

SHAPES = [(1024, 8, 40), (512, 2, 64)]
TOL = 2e-4
_RUNS = {}


def ranked(n: int):
    """Each rank's ``(outputs, routes)`` of :func:`torch_parallel_ranks.ring` on
    ``n`` ranks, run once per module."""
    if n not in _RUNS:
        _RUNS[n] = run_ranks(ranks.ring, n, args=(SHAPES,), timeout_s=300)
    return _RUNS[n]


def inputs(s, heads, d):
    rng = np.random.RandomState(0)
    return [rng.normal(0, 1, (2, s, heads * d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n", [2, 4, 8])
def test_ring_matches_jax_ring(n, shape):
    import jax

    mesh = jmesh.make_mesh(data=n, model=1, devices=jax.devices()[:n])
    q, k, v = (jnp.asarray(a) for a in inputs(*shape))
    want = np.asarray(jax_ring(q, k, v, num_heads=shape[1], mesh=mesh))
    for outs, _ in ranked(n):
        np.testing.assert_allclose(outs[shape], want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n", [2, 4, 8])
def test_ring_matches_plain_attention(n, shape):
    s, heads, d = shape
    q, k, v = (torch.from_numpy(a).unflatten(-1, (heads, d)) for a in inputs(*shape))
    want = tattn.plain_attention(q, k, v, d ** -0.5).reshape(2, s, heads * d).numpy()
    for outs, _ in ranked(n):
        np.testing.assert_allclose(outs[shape], want, rtol=TOL, atol=TOL)


def test_every_rank_gets_the_same_whole_output():
    results = ranked(4)
    for shape in SHAPES:
        assert results[0][0][shape].shape == (2, shape[0], shape[1] * shape[2])
        for outs, _ in results[1:]:
            np.testing.assert_array_equal(outs[shape], results[0][0][shape])


def test_sequence_parallel_routing():
    """Inside ``sequence_parallel_scope(mesh, "data", min_seq=512)`` on 2 ranks: a
    1024-token self-attention runs the ring, also inside ``plain_scope`` (the JAX
    rule comes first); fewer tokens, causal and cross-attention do not; the ring
    refuses a gradient; the key names the mesh; the scope ends with the block."""
    for _, routes in ranked(2):
        assert routes["key"] == ("data", 512, (("data", 2), ("model", 1)))
        assert routes["self 1024"] == 1
        assert routes["self 1024 in plain_scope"] == 1
        assert routes["self 256"] == routes["causal 1024"] == routes["cross 1024x77"] == 0
        assert routes["grad"] is not None and "no backward" in routes["grad"]
        assert routes["key after"] is None
    assert tattn.sequence_parallel_key() is None
