"""The port's activation-scale calibration (``weights/calibrate.py``) against the
JAX package's, on the CPU: the statistics of the 3-step CFG + DDIM trajectory of
the JAX package's own calibration test (``tests/test_quantize.py``), the sites
that ``bake_act_scales`` bakes, and the ``.npz`` files each package writes and
reads, the committed calibration fixtures among them. The port's int8 roundings
are held to the JAX package's (``torch_port_utils.Int8Replay``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minsdtf_tpu import scheduler as jsched
from minsdtf_tpu.models import unet as junet
from minsdtf_tpu.weights import calibrate as jcalibrate
from minsdtf_tpu.weights import quantize as jquantize
from minsdtf_tpu_torch.models import unet as tunet
from minsdtf_tpu_torch.weights import calibrate as tcalibrate
from minsdtf_tpu_torch.weights import quantize as tquantize
from torch_port_utils import Int8Replay, load, one_torch_thread  # noqa: F401

WIDTHS = (32, 64, 128, 128)  # the JAX test's, with its default 1280-wide time embedding
# with the ties replayed the statistics differ only by the fp32 summation order of
# the float work and of the means; test_collect_unet_amax_matches_jax prints it
STATS_RTOL = 1e-5
FIXTURES = ("fixtures/int8_scales_random512.npz", "fixtures/hybrid_scales_random512.npz",
            "fixtures/hybrid_scales_random512_v2.npz")


@pytest.fixture(scope="module")
def calibrated():
    """(JAX stats, port stats, JAX int8 params, port int8 UNet) on the trajectory
    of ``tests/test_quantize.py::test_calibrated_static_scales_match_dynamic``."""
    params = junet.init_params(jax.random.PRNGKey(3), widths=WIDTHS)
    qparams = jquantize.quantize_params(params, min_k=64)
    unet = tunet.UNet(WIDTHS, temb_dim=1280)
    unet = tquantize.quantize_params(load(unet, params), min_k=64)

    rs = np.random.RandomState(5)
    latent0 = rs.normal(0, 1, (1, 8, 8, 4)).astype(np.float32)
    context = rs.normal(0, 1, (1, 77, 768)).astype(np.float32)
    uncond = rs.normal(0, 1, (1, 77, 768)).astype(np.float32)
    schedule = jsched.build_denoise_schedule(jsched.Scheduler(), 3, eta=0.3)
    t_embs = jsched.timestep_embedding(schedule.timesteps, dim=WIDTHS[0])
    rows = {k: np.asarray(getattr(schedule, k), np.float32)
            for k in ("sr_t", "nr_t", "sr_prev", "nr_prev", "is_last")}
    replay = Int8Replay()
    with replay.recording():
        want = jcalibrate.collect_unet_amax(qparams, jnp.asarray(latent0), context, uncond,
                                            t_embs, rows)
    with replay.replaying():
        got = tcalibrate.collect_unet_amax(unet, torch.from_numpy(latent0), context, uncond,
                                           t_embs, rows)
    return want, got, qparams, unet


def assert_stats_close(got, want, rtol=STATS_RTOL):
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        for key in ("amax", "ratio", "out_msq"):
            np.testing.assert_allclose(g[key], w[key], rtol=rtol, err_msg=f"{name} {key}")
        for key in ("ch_amax", "ch_mean", "ch_msq"):
            assert g[key].shape == w[key].shape and g[key].dtype == np.float32, (name, key)
            # a channel mean near zero is held to the scale of the site's means
            np.testing.assert_allclose(g[key], w[key], rtol=rtol,
                                       atol=rtol * float(np.abs(w[key]).max()),
                                       err_msg=f"{name} {key}")


def test_collect_unet_amax_matches_jax(calibrated):
    want, got, qparams, unet = calibrated
    assert set(want) == {n for n, leaves in qparams.items() if "kernel_q" in leaves}
    assert set(got) == set(tquantize.int8_sites(unet))
    worst = max(abs(got[k]["amax"] - w["amax"]) / w["amax"] for k, w in want.items())
    print(f"{len(want)} sites, amax max relative difference {worst:.3e}")
    assert_stats_close(got, want)
    # the statistics' axes: per input channel of each site
    site = "mid_block.resnets.0.conv1"
    assert got[site]["ch_amax"].shape == (unet.get_submodule(site).weight_q.shape[1],)
    assert abs(float(np.max(got[site]["ch_amax"])) - got[site]["amax"]) < 1e-6 * got[site]["amax"]


@pytest.mark.parametrize("kw", [{}, {"include_dense": True, "margin": 1.1},
                                {"stability_threshold": np.inf}])
def test_bake_act_scales_chooses_the_jax_sites(calibrated, kw):
    want, got, qparams, unet = calibrated
    baked = jcalibrate.bake_act_scales(qparams, want, **kw)
    want_scales = {n: float(leaves["act_scale"]) for n, leaves in baked.items()
                   if "act_scale" in leaves}
    model = tcalibrate.bake_act_scales(unet, got, **kw)
    sites = tquantize.int8_sites(model)
    got_scales = {n: float(s.act_scale) for n, s in sites.items() if s.act_scale is not None}
    assert set(got_scales) == set(want_scales) and want_scales
    for name, value in want_scales.items():
        np.testing.assert_allclose(got_scales[name], value, rtol=STATS_RTOL)
    for site in sites.values():  # leave the module fixture dynamic again
        site.act_scale = None


def test_each_package_reads_the_others_npz(calibrated, tmp_path):
    want, got, _, _ = calibrated
    plain = {"site.a": 2.5, "site.b": {"amax": 1.0, "ratio": 1.25}}
    for stats in (got, plain):
        tcalibrate.save_scales(str(tmp_path / "port.npz"), stats)
        jcalibrate.save_scales(str(tmp_path / "jax.npz"), stats)
        for path in ("port.npz", "jax.npz"):
            a = jcalibrate.load_scales(str(tmp_path / path))
            b = tcalibrate.load_scales(str(tmp_path / path))
            assert sorted(a) == sorted(b) == sorted(stats)
            for name in a:
                assert sorted(a[name]) == sorted(b[name])
                for key in a[name]:
                    np.testing.assert_array_equal(b[name][key], a[name][key])
    back = tcalibrate.load_scales(str(tmp_path / "port.npz"))
    assert back["site.a"] == {"amax": 2.5, "ratio": 1.0}
    jcalibrate.save_scales(str(tmp_path / "round.npz"), got)
    assert_stats_close(tcalibrate.load_scales(str(tmp_path / "round.npz")), got, rtol=1e-6)


@pytest.mark.parametrize("path", FIXTURES)
def test_fixtures_load_as_in_jax(path):
    a, b = jcalibrate.load_scales(path), tcalibrate.load_scales(path)
    assert sorted(a) == sorted(b) and a
    for name in a:
        assert sorted(a[name]) == sorted(b[name])
        for key in a[name]:
            np.testing.assert_array_equal(b[name][key], a[name][key])


def test_merge_stats_matches_jax(calibrated):
    want, got, _, _ = calibrated
    other = {k: dict(v, amax=v["amax"] * 1.3, ratio=v["ratio"] * 0.9,
                     ch_amax=v["ch_amax"] * 0.8) for k, v in want.items()}
    a = {k: dict(v) for k, v in want.items()}
    b = {k: dict(v) for k, v in want.items()}
    jcalibrate.merge_stats(a, other)
    tcalibrate.merge_stats(b, other)
    for name in a:
        for key in a[name]:
            np.testing.assert_array_equal(b[name][key], a[name][key])
