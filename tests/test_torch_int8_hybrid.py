"""The port's ``weight_dtype="int8_hybrid"`` pipeline against the JAX package's,
fp32 on the CPU at 64 px: ``calibrate_int8`` (the trajectories on a temporary
conv-only dynamic copy, then the live UNet hybridized) and txt2img. Both pipelines
build their UNet through their own ``unet`` property from the same small fp32
params (``torch_port_utils.int8_pipelines``), and the port's int8 roundings are
held to the JAX package's (``Int8Replay``)."""

import numpy as np
import pytest

from minsdtf_tpu_torch.weights import quantize as tquantize
from torch_port_utils import (  # noqa: F401
    Int8Replay, assert_int8_image, assert_same_int8_sites, int8_pipelines, int8_txt2img_pair,
    make_pipelines, one_torch_thread, write_merges,
)

# with the ties replayed the statistics differ in the 7th digit (the fp32
# summation order of the float work and of the means)
STATS_RTOL = 1e-5


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return make_pipelines(write_merges(tmp_path_factory.mktemp("bpe") / "merges.txt.gz"))


def test_int8_hybrid_after_calibration_matches_jax(base, monkeypatch):
    """``calibrate_int8`` under int8_hybrid: the statistics of the JAX pipeline's,
    on a temporary conv-only dynamic copy; the live UNet then hybridized from them
    as the JAX pipeline hybridizes its UNet from the same statistics; then
    txt2img. (Each package's weights hybridized from its own statistics could
    differ at a weight-rounding tie, since the statistics differ in the 7th
    digit.)"""
    j, t = int8_pipelines(base, monkeypatch, "int8_hybrid")
    assert not tquantize.int8_sites(t.unet)  # float until calibrated
    replay = Int8Replay()
    with replay.recording():
        want = j.calibrate_int8(num_steps=3, seeds=(0, 1))
    with replay.replaying():
        got = t.calibrate_int8(num_steps=3, seeds=(0, 1))
    assert set(got) == set(want) and want
    for name, w in want.items():
        for key, value in w.items():
            np.testing.assert_allclose(got[name][key], value, rtol=STATS_RTOL,
                                       atol=STATS_RTOL * float(np.abs(value).max()),
                                       err_msg=f"{name} {key}")
    sites = tquantize.int8_sites(t.unet)
    assert sites and all(s.is_conv and s.act_scale is not None for s in sites.values())
    j2, _ = int8_pipelines(base, monkeypatch, "int8_hybrid", int8_act_scales=got)
    assert_same_int8_sites(t.unet, j2.unet_params)
    out, ref, _ = int8_txt2img_pair(j2, t)
    assert_int8_image(out, ref)
