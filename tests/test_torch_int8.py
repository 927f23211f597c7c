"""The port's W8A8 int8 path against the JAX package's, on the CPU at small widths:
the weight quantizers (``weights/quantize.py``), the activation quantize in each
mode, the int8 conv and dense, and the full-width UNet's site names against the
calibration fixtures (a whole small UNet is in ``test_torch_int8_unet.py``). Both
packages get the same numpy-seeded params; the port's through ``weights.from_jax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minsdtf_tpu.models import unet as junet
from minsdtf_tpu.ops import basic as jbasic
from minsdtf_tpu.weights import quantize as jquantize
from minsdtf_tpu_torch.models import unet as tunet
from minsdtf_tpu_torch.models.common import Int8Site
from minsdtf_tpu_torch.ops import basic as tbasic
from minsdtf_tpu_torch.weights import calibrate as tcalibrate
from minsdtf_tpu_torch.weights import quantize as tquantize
from torch_port_utils import load, nchw, one_torch_thread, perturb_norms  # noqa: F401

SMALL = dict(widths=(32, 64, 128, 128), temb_dim=128)
SCALE_RTOL = 1e-6
OP_RTOL = 1e-6
FIXTURE_INT8 = "fixtures/int8_scales_random512.npz"
FIXTURE_HYBRID = ("fixtures/hybrid_scales_random512.npz",
                  "fixtures/hybrid_scales_random512_v2.npz")


def _port_layout(a: np.ndarray) -> np.ndarray:
    """A JAX kernel (HWIO or (in, out)) in the port's layout (OIHW or (out, in))."""
    a = np.asarray(a)
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T


def small_params(seed: int = 3):
    return perturb_norms(junet.init_params(jax.random.PRNGKey(seed), scale=0.04, **SMALL), 1)


def port_unet(params, fused: bool = True) -> tunet.UNet:
    """The port's small UNet holding the JAX ``params`` (fp32, fused when ``fused``)."""
    unet = tunet.UNet(**SMALL)
    if fused:
        tunet.fuse_attention_projections(unet)
    return load(unet, params)


def assert_sites_equal(model, jparams, names=None):
    """Every int8 site of ``model`` holds the JAX module's int8 values, scales and
    bias; ``names``, if given, is the set the two must both have."""
    sites = tquantize.int8_sites(model)
    jnames = {n for n, leaves in jparams.items() if "kernel_q" in leaves}
    assert set(sites) == jnames
    if names is not None:
        assert jnames == set(names)
    for name, site in sites.items():
        leaves = jparams[name]
        np.testing.assert_array_equal(site.weight_q.numpy(), _port_layout(leaves["kernel_q"]))
        np.testing.assert_allclose(site.weight_scale.numpy(), leaves["kernel_scale"],
                                   rtol=SCALE_RTOL, atol=0)
        for leaf in ("act_scale", "act_qmul", "bias"):
            got = getattr(site, leaf)
            assert (got is None) == (leaf not in leaves), (name, leaf)
            if got is not None:
                np.testing.assert_allclose(got.numpy(), np.asarray(leaves[leaf]),
                                           rtol=SCALE_RTOL, atol=0)


@pytest.mark.parametrize("shape", [(3, 3, 64, 48), (1, 1, 320, 640), (320, 1280), (768, 64)])
def test_quantize_kernel_bits(shape):
    w = np.random.RandomState(0).normal(0, 0.05, shape).astype(np.float32)
    w[..., 1] = 0.0  # an all-zero output channel takes the 1e-12 floor
    q, scale = jquantize.quantize_kernel(w)
    tq, tscale = tquantize.quantize_kernel(torch.from_numpy(_port_layout(w).copy()))
    assert tq.dtype == torch.int8 and tscale.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), _port_layout(q))
    np.testing.assert_array_equal(tscale.numpy(), scale)
    np.testing.assert_array_equal(
        tquantize.dequantize_kernel(Int8Site("w", tq, tscale)).numpy(),
        _port_layout(jquantize.dequantize_kernel({"kernel_q": q, "kernel_scale": scale})))


@pytest.mark.parametrize("kw", [
    {},
    {"min_k": 64},
    {"min_k": 64, "conv_only": True},
    {"min_k": 64, "skip_suffixes": ("conv_in", "conv_out", "conv_shortcut", "to_qkv")},
])
def test_quantize_params_sites(kw):
    """The skip list, ``min_k`` and ``conv_only`` pick the JAX package's sites,
    with its bits."""
    params = junet.fuse_attention_projections(small_params())
    jq = jquantize.quantize_params(params, **kw)
    unet = tquantize.quantize_params(port_unet(params), **kw)
    assert_sites_equal(unet, jq)
    assert tquantize.int8_sites(unet)


def _conv_stats(x, out_msq=1.0):
    """Calibration-like per-channel statistics of an NHWC activation."""
    xf = np.asarray(x, np.float64)
    return {"amax": float(np.max(np.abs(xf))), "ratio": 1.0,
            "ch_amax": np.max(np.abs(xf), axis=(0, 1, 2)).astype(np.float32),
            "ch_mean": np.mean(xf, axis=(0, 1, 2)).astype(np.float32),
            "ch_msq": np.mean(xf ** 2, axis=(0, 1, 2)).astype(np.float32),
            "out_msq": out_msq}


@pytest.mark.parametrize("alpha,clip_sigmas,bias_correct", [
    (0.5, None, True), (0.5, None, False), (0.3, 3.0, True)])
def test_equalized_module_matches_jax(alpha, clip_sigmas, bias_correct):
    rs = np.random.RandomState(21)
    x = rs.normal(0.4, 1.0, (2, 12, 12, 64)).astype(np.float32)
    x[..., 5] *= 30.0  # an outlier channel
    w = rs.normal(0, 0.05, (3, 3, 64, 48)).astype(np.float32)
    b = rs.normal(0, 0.05, (48,)).astype(np.float32)
    stats = _conv_stats(x, out_msq=0.37)
    want, want_est = jquantize._equalized_module(
        {"kernel": w, "bias": b}, stats, margin=1.05, alpha=alpha, clip_sigmas=clip_sigmas,
        bias_correct=bias_correct)
    conv = torch.nn.Conv2d(64, 48, 3)
    conv.load_state_dict({"weight": torch.from_numpy(_port_layout(w).copy()),
                          "bias": torch.from_numpy(b)})
    site, est = tquantize._equalized_module("c", conv, stats, margin=1.05, alpha=alpha,
                                            clip_sigmas=clip_sigmas, bias_correct=bias_correct)
    np.testing.assert_array_equal(site.weight_q.numpy(), _port_layout(want["kernel_q"]))
    for leaf, got in (("kernel_scale", site.weight_scale), ("act_scale", site.act_scale),
                      ("act_qmul", site.act_qmul), ("bias", site.bias)):
        np.testing.assert_allclose(got.numpy(), want[leaf], rtol=SCALE_RTOL, atol=0)
    for k in ("rel_mse", "act_rel", "w_rel"):
        np.testing.assert_allclose(est[k], want_est[k], rtol=1e-9)
    np.testing.assert_allclose(tquantize.dequantize_kernel(site).numpy(),
                               _port_layout(jquantize.dequantize_kernel(want)), rtol=1e-6)


def synthetic_scales(params, seed: int = 7):
    """Calibration-like statistics for every conv and dense module of ``params``,
    a third of them unstable (ratio 3)."""
    rs = np.random.RandomState(seed)
    scales = {}
    for i, (name, leaves) in enumerate(sorted(params.items())):
        k = leaves.get("kernel")
        if k is None:
            continue
        c = k.shape[2] if k.ndim == 4 else k.shape[0]
        ch_amax = rs.uniform(0.5, 4.0, c).astype(np.float32)
        scales[name] = {"amax": float(ch_amax.max()), "ratio": 3.0 if i % 3 == 0 else 1.2,
                        "ch_amax": ch_amax,
                        "ch_mean": rs.normal(0.2, 0.1, c).astype(np.float32),
                        "ch_msq": rs.uniform(0.3, 1.5, c).astype(np.float32),
                        "out_msq": float(rs.uniform(0.01, 0.1))}
    return scales


@pytest.mark.parametrize("gate", [False, True])
def test_hybridize_params_matches_jax(gate):
    """int8_hybrid: the stable conv sites only, equalized and bias-corrected, the
    report, and the ``max_site_rel_mse`` gate dropping the JAX package's sites."""
    params = junet.fuse_attention_projections(small_params())
    scales = synthetic_scales(params)
    kw = dict(min_k=64)
    if gate:
        probe = {}
        jquantize.hybridize_params(params, scales, report=probe, **kw)
        kw["max_site_rel_mse"] = float(np.median([v["rel_mse"] for v in probe.values()]))
    want_report, report = {}, {}
    jh = jquantize.hybridize_params(params, scales, report=want_report, **kw)
    unet = tquantize.hybridize_params(port_unet(params), scales, report=report, **kw)
    assert_sites_equal(unet, jh)
    assert set(report) == set(want_report)
    for name, est in want_report.items():
        assert report[name]["quantized"] == est["quantized"], name
        np.testing.assert_allclose(report[name]["rel_mse"], est["rel_mse"], rtol=1e-9)
    n = len(tquantize.int8_sites(unet))
    assert 0 < n < len(report) if gate else n == len(report)
    # a site with a scalar amax gets the plain per-tensor grid with a static scale
    plain = {k: {"amax": v["amax"], "ratio": v["ratio"]} for k, v in scales.items()}
    jh = jquantize.hybridize_params(params, plain, dense_dynamic=True, **kw)
    unet = tquantize.hybridize_params(port_unet(params), plain, dense_dynamic=True, **kw)
    assert_sites_equal(unet, jh)


def _site(q, scale, bias, act_scale=None, act_qmul=None):
    """A port site and the JAX module dict holding the same values."""
    p = {"kernel_q": q, "kernel_scale": scale, "bias": bias}
    site = Int8Site("s", torch.from_numpy(_port_layout(q).copy()), torch.from_numpy(scale),
                    torch.from_numpy(bias))
    if act_scale is not None:
        p["act_scale"] = np.float32(act_scale)
        site.act_scale = torch.tensor(np.float32(act_scale))
    if act_qmul is not None:
        p["act_qmul"] = act_qmul
        site.act_qmul = torch.from_numpy(act_qmul)
    return p, site


MODES = {"dynamic": {}, "static": {"act_scale": 0.031},
         "equalized": {"act_scale": 0.029, "act_qmul": "vector"}}


def _mode_site(kernel, mode: str, rs):
    q, scale = jquantize.quantize_kernel(kernel)
    cin = kernel.shape[2] if kernel.ndim == 4 else kernel.shape[0]
    kw = dict(MODES[mode])
    if "act_qmul" in kw:
        kw["act_qmul"] = rs.uniform(10.0, 40.0, cin).astype(np.float32)
    bias = rs.normal(0, 0.05, kernel.shape[-1]).astype(np.float32)
    return _site(q, scale, bias, **kw)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("conv", [True, False])
def test_quantize_acts_bits(mode, conv):
    rs = np.random.RandomState(4)
    if conv:
        x = rs.normal(0, 1.5, (2, 9, 7, 64)).astype(np.float32)
        p, site = _mode_site(rs.normal(0, 0.05, (3, 3, 64, 16)).astype(np.float32), mode, rs)
        want, want_asc = jbasic._quantize_acts(jnp.asarray(x), p, axes=(1, 2, 3))
        got, asc = tbasic._quantize_acts(nchw(x), site, dims=(1, 2, 3), channel_dim=1)
        got = got.permute(0, 2, 3, 1)
    else:
        x = rs.normal(0, 1.5, (2, 5, 64)).astype(np.float32)
        x[0, 1] = 0.0  # an all-zero token takes the 1e-12 floor
        p, site = _mode_site(rs.normal(0, 0.05, (64, 16)).astype(np.float32), mode, rs)
        want, want_asc = jbasic._quantize_acts(jnp.asarray(x), p, axes=-1)
        got, asc = tbasic._quantize_acts(torch.from_numpy(x), site, dims=-1, channel_dim=-1)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(asc.numpy(), np.asarray(want_asc))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kernel,stride,padding", [
    ((3, 3, 64, 48), 1, 1), ((3, 3, 64, 48), 2, 1), ((1, 1, 64, 32), 1, 0),
    ((3, 3, 64, 40), 2, ((0, 1), (0, 1))),
])
def test_int8_conv_matches_jax(mode, kernel, stride, padding):
    rs = np.random.RandomState(5)
    x = rs.normal(0, 1.0, (2, 10, 9, kernel[2])).astype(np.float32)
    p, site = _mode_site(rs.normal(0, 0.05, kernel).astype(np.float32), mode, rs)
    want = np.asarray(jbasic.conv2d(jnp.asarray(x), p, stride=stride, padding=padding))
    calls = tbasic.int8_matmul.calls
    got = tbasic.int8_conv2d(nchw(x), site, stride=stride, padding=padding)
    assert tbasic.int8_matmul.calls == calls + 1
    assert got.shape == (want.shape[0], want.shape[3], want.shape[1], want.shape[2])
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=OP_RTOL, atol=0)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("rows", [(2,), (2, 77), (1, 40)])
def test_int8_dense_matches_jax(mode, rows):
    """Two rows (the batch-1 ``time_emb_proj``, padded to 17 for the product) and
    token batches."""
    rs = np.random.RandomState(6)
    x = rs.normal(0, 1.0, (*rows, 96)).astype(np.float32)
    p, site = _mode_site(rs.normal(0, 0.05, (96, 40)).astype(np.float32), mode, rs)
    want = np.asarray(jbasic.dense(jnp.asarray(x), p))
    got = tbasic.int8_dense(torch.from_numpy(x), site)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=OP_RTOL, atol=0)


def test_int8_matmul_is_exact():
    rs = np.random.RandomState(8)
    for m, k, n in ((2, 1280, 320), (17, 24, 8), (300, 5760, 64)):
        a = rs.randint(-127, 128, (m, k)).astype(np.int8)
        w = rs.randint(-127, 128, (n, k)).astype(np.int8)
        got = tbasic.int8_matmul(torch.from_numpy(a), torch.from_numpy(w))
        assert got.dtype == torch.int32 and got.shape == (m, n)
        np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ w.astype(np.int64).T)


def full_width_sites() -> dict:
    """The int8 sites of the port's full-width fused UNet, quantized on ``meta``."""
    with torch.device("meta"):
        unet = tunet.fuse_attention_projections(tunet.UNet())
    return tquantize.int8_sites(tquantize.quantize_params(unet))


def test_full_width_site_names_match_the_fixtures():
    """227 sites, the JAX package's full-width count and the names of its int8
    calibration fixture; the hybrid fixtures name conv sites of them."""
    sites = full_width_sites()
    assert len(sites) == 227
    assert set(sites) == set(tcalibrate.load_scales(FIXTURE_INT8))
    assert sum(s.is_conv for s in sites.values()) == 93
    v2 = tcalibrate.load_scales(FIXTURE_HYBRID[1])
    assert len(v2) == 93
    for path in FIXTURE_HYBRID:
        names = tcalibrate.load_scales(path)
        assert names and all(n in sites and sites[n].is_conv for n in names), path
