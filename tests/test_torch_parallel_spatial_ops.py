"""``minsdtf_tpu_torch/parallel/spatial.py`` on 2 and 4 ``gloo`` ranks (mesh (1, n)),
each output gathered: ``halo_conv2d`` for the 3x3 stride-1 conv, the UNet's
downsampler (stride 2, padding 1) and the VAE encoder's (stride 2, padding
``((0, 1), (0, 1))``), from sharded and from whole inputs, and
``upsample2x_conv3x3`` into a sharded level from a whole and from a sharded
input, against the whole operation: exact in fp64, 1e-6 in fp32; and
``group_norm`` (with and without SiLU) against the JAX package's
``group_norm`` / ``group_norm_silu``: 1e-6. The counts of calls and collectives
are the ones the operations imply."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from minsdtf_tpu.ops import basic as jbasic
from minsdtf_tpu_torch.ops import basic as tbasic
from minsdtf_tpu_torch.parallel.mesh import run_ranks
from torch_port_utils import one_torch_thread  # noqa: F401

CONVS = {"3x3": (1, 1), "unet down": (2, 1), "encoder down": (2, ((0, 1), (0, 1)))}
CASES = list(CONVS) + ["3x3 whole input", "upsample whole input", "upsample sharded input"]
TOL = {"float64": 0.0, "float32": 1e-6}


def make_inputs():
    rng = np.random.RandomState(0)
    normal = lambda loc, scale, shape: rng.normal(loc, scale, shape)  # noqa: E731
    return dict(
        x=normal(0, 1, (2, 8, 16, 12)), small=normal(0, 1, (2, 8, 6, 12)),
        weight=normal(0, 0.2, (6, 8, 3, 3)), bias=normal(0, 0.2, 6),
        up_weight=normal(0, 0.2, (6, 8, 3, 3)), up_bias=normal(0, 0.2, 6),
        gn_x=normal(0.5, 2, (2, 64, 8, 6)).astype(np.float32),
        gn_scale=normal(1, 0.3, 64).astype(np.float32),
        gn_bias=normal(0, 0.3, 64).astype(np.float32), convs=CONVS)


def whole(inputs, dtype):
    """Each case's output from the whole tensors on one process."""
    t = {k: torch.from_numpy(v).to(dtype) for k, v in inputs.items() if k != "convs"}
    want = {case: tbasic.conv2d(t["x"], t["weight"], t["bias"], stride, padding).numpy()
            for case, (stride, padding) in CONVS.items()}
    want["3x3 whole input"] = want["3x3"]
    want["upsample whole input"] = tbasic.upsample2x_conv3x3(
        t["small"], t["up_weight"], t["up_bias"]).numpy()
    want["upsample sharded input"] = tbasic.upsample2x_conv3x3(
        t["x"], t["up_weight"], t["up_bias"]).numpy()
    return want


@pytest.fixture(scope="module")
def runs():
    inputs = make_inputs()
    return inputs, {n: run_ranks(ranks.spatial_ops, n, (inputs,), timeout_s=120) for n in (2, 4)}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_sharded_convs_equal_the_whole_conv(runs, n, dtype):
    inputs, got = runs
    want = whole(inputs, getattr(torch, dtype))
    for outs, _, _ in got[n]:
        for case in CASES:
            assert outs[dtype, case].shape == want[case].shape, case
            np.testing.assert_allclose(outs[dtype, case], want[case], rtol=TOL[dtype],
                                       atol=TOL[dtype], err_msg=case)


@pytest.mark.parametrize("n", [2, 4])
def test_group_norm_over_the_axis_matches_jax(runs, n):
    inputs, got = runs
    x = jnp.asarray(inputs["gn_x"].transpose(0, 2, 3, 1))  # NHWC
    p = {"scale": jnp.asarray(inputs["gn_scale"]), "bias": jnp.asarray(inputs["gn_bias"])}
    for silu, fn in ((False, jbasic.group_norm), (True, jbasic.group_norm_silu)):
        want = np.asarray(fn(x, p)).transpose(0, 3, 1, 2)
        for outs, _, _ in got[n]:
            for dtype in ("float64", "float32"):
                np.testing.assert_allclose(outs[dtype, f"group_norm silu={silu}"], want,
                                           rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
def test_rows_gather_channels_last(runs, n):
    """Channels-last rows and weights give channels-last output rows from every
    sharded operation, and a channels-last whole from their gather, as the whole
    levels after a gather take it (their GroupNorm kernel on the card takes NHWC
    memory only), with the values of the NCHW runs."""
    _, got = runs
    for outs, _, _ in got[n]:
        for dtype in ("float64", "float32"):
            layout = outs[dtype, "channels-last"]
            assert all(layout.values()), layout
            for case in list(CONVS) + ["upsample sharded input", "group_norm silu=True"]:
                np.testing.assert_allclose(outs[dtype, f"{case} channels-last"],
                                           outs[dtype, case], rtol=1e-6, atol=1e-6,
                                           err_msg=case)


def test_calls_and_collectives(runs):
    _, got = runs
    for n in (2, 4):
        for _, calls, comm in got[n]:
            # per dtype: 3 + 1 halo convs, 2 upsamplers, 2 group norms
            assert calls == {"local_rows": 12, "gather_rows": 16, "halo_conv2d": 8,
                             "group_norm": 4, "upsample2x_conv3x3": 4}
            # halos: the 3 sharded convs and the sharded upsampler; 2 sums a norm
            assert comm == {"all_reduce": 8, "all_gather": 16, "ring_shift": 0, "halo": 8}
