"""The port's primitive ops and attention against the JAX package, fp32 on the CPU.

Inputs are made with numpy from a seed and handed to both frameworks. JAX layouts
(NHWC, HWIO, (in, out)) are converted to the port's (NCHW, OIHW, (out, in)) here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minsdtf_tpu.ops import attention as jattn
from minsdtf_tpu.ops import basic as jb
from minsdtf_tpu.ops import flash_attention as jfa
from minsdtf_tpu_torch.ops import attention as tattn
from minsdtf_tpu_torch.ops import basic as tb
from minsdtf_tpu_torch.ops import flash_attention as tfa
from torch_port_utils import one_torch_thread  # noqa: F401

OPS_TOL = 1e-5
ATTN_TOL = 2e-5


def _rs(seed=0):
    return np.random.RandomState(seed)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nchw(a):
    return _t(a.transpose(0, 3, 1, 2))


def _to_nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("k,stride,padding,cin,cout", [
    (3, 1, 1, 8, 16),
    (1, 1, 0, 16, 8),
    (3, 2, 1, 8, 8),                 # UNet downsampler
    (3, 2, ((0, 1), (0, 1)), 8, 8),  # VAE encoder asymmetric downsampler
])
def test_conv2d(k, stride, padding, cin, cout):
    rs = _rs(1)
    x = rs.normal(0, 1, (2, 9, 10, cin)).astype(np.float32)
    w = rs.normal(0, 0.2, (k, k, cin, cout)).astype(np.float32)
    b = rs.normal(0, 0.2, (cout,)).astype(np.float32)
    want = np.asarray(jb.conv2d(jnp.asarray(x), {"kernel": w, "bias": b}, stride, padding))
    got = tb.conv2d(_nchw(x), _t(w.transpose(3, 2, 0, 1)), _t(b), stride, padding)
    np.testing.assert_allclose(_to_nhwc(got), want, rtol=OPS_TOL, atol=OPS_TOL)


def test_upsample2x_conv3x3():
    rs = _rs(2)
    x = rs.normal(0, 1, (2, 5, 6, 8)).astype(np.float32)
    w = rs.normal(0, 0.2, (3, 3, 8, 12)).astype(np.float32)
    b = rs.normal(0, 0.2, (12,)).astype(np.float32)
    want = np.asarray(jb.upsample2x_conv3x3(jnp.asarray(x), {"kernel": w, "bias": b}))
    got = tb.upsample2x_conv3x3(_nchw(x), _t(w.transpose(3, 2, 0, 1)), _t(b))
    np.testing.assert_allclose(_to_nhwc(got), want, rtol=OPS_TOL, atol=OPS_TOL)


@pytest.mark.parametrize("bias", [True, False])
def test_dense(bias):
    rs = _rs(3)
    x = rs.normal(0, 1, (2, 7, 24)).astype(np.float32)
    w = rs.normal(0, 0.2, (24, 40)).astype(np.float32)
    p = {"kernel": w}
    b = None
    if bias:
        b = rs.normal(0, 0.2, (40,)).astype(np.float32)
        p["bias"] = b
    want = np.asarray(jb.dense(jnp.asarray(x), p))
    got = tb.dense(_t(x), _t(w.T), None if b is None else _t(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=OPS_TOL, atol=OPS_TOL)


@pytest.mark.parametrize("silu", [False, True])
def test_group_norm(silu):
    rs = _rs(4)
    x = rs.normal(0.5, 2, (2, 6, 5, 64)).astype(np.float32)
    scale = rs.normal(1, 0.3, (64,)).astype(np.float32)
    bias = rs.normal(0.1, 0.3, (64,)).astype(np.float32)
    jfn, tfn = (jb.group_norm_silu, tb.group_norm_silu) if silu else (jb.group_norm, tb.group_norm)
    want = np.asarray(jfn(jnp.asarray(x), {"scale": scale, "bias": bias}))
    got = tfn(_nchw(x), _t(scale), _t(bias))
    np.testing.assert_allclose(_to_nhwc(got), want, rtol=OPS_TOL, atol=OPS_TOL)


def test_layer_norm():
    rs = _rs(5)
    x = rs.normal(0.3, 2, (2, 7, 48)).astype(np.float32)
    scale = rs.normal(1, 0.3, (48,)).astype(np.float32)
    bias = rs.normal(0.1, 0.3, (48,)).astype(np.float32)
    want = np.asarray(jb.layer_norm(jnp.asarray(x), {"scale": scale, "bias": bias}))
    got = tb.layer_norm(_t(x), _t(scale), _t(bias))
    np.testing.assert_allclose(got.numpy(), want, rtol=OPS_TOL, atol=OPS_TOL)


@pytest.mark.parametrize("name", ["silu", "quick_gelu", "gelu_tanh"])
def test_activations(name):
    x = _rs(6).normal(0, 3, (4, 33)).astype(np.float32)
    want = np.asarray(getattr(jb, name)(jnp.asarray(x)))
    got = getattr(tb, name)(_t(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=OPS_TOL, atol=OPS_TOL)


def test_geglu():
    rs = _rs(7)
    x = rs.normal(0, 1, (2, 5, 16)).astype(np.float32)
    w = rs.normal(0, 0.3, (16, 64)).astype(np.float32)
    b = rs.normal(0, 0.3, (64,)).astype(np.float32)
    want = np.asarray(jb.geglu(jnp.asarray(x), {"kernel": w, "bias": b}, output_dim=32))
    got = tb.geglu(_t(x), _t(w.T), _t(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=OPS_TOL, atol=OPS_TOL)


# ---- the kernels' plain versions against the Pallas kernels (interpret mode) ----

def _qkv(b, sq, sk, h, d, seed):
    rs = _rs(seed)
    q = rs.normal(0, 1, (b, sq, h, d)).astype(np.float32)
    k = rs.normal(0, 1, (b, sk, h, d)).astype(np.float32)
    v = rs.normal(0, 1, (b, sk, h, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("b,sq,sk,d,h,route", [
    (2, 256, 256, 40, 2, "onepass"),     # the JAX test's shapes
    (2, 512, 512, 80, 1, "onepass"),
    (2, 256, 77, 160, 1, "onepass"),
    (2, 256, 154, 40, 2, "onepass"),
    (1, 4096, 4096, 40, 1, "onepass"),   # the 512px UNet self-attention
    (1, 1024, 1024, 80, 2, "onepass"),
    (1, 256, 1024, 512, 1, "online"),    # online route: d > 160
    (1, 512, 4096, 40, 1, "online"),     # fp32 kv 4096: JAX's online route
    (1, 256, 8192, 40, 1, "online"),     # long KV, as the 1024px UNet level 0
    (1, 128, 4096, 512, 1, "online"),    # the VAE mid-block's width at 512px
])
def test_kernel_plain_versions_match_pallas(b, sq, sk, d, h, route):
    """K1's and K2's plain versions against ``fa.flash_attention(interpret=True)``
    (JAX picks its own kernel for the shape and dtype)."""
    q, k, v = _qkv(b, sq, sk, h, d, seed=sq + sk + d)
    scale = d ** -0.5
    want = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          scale=scale, interpret=True))
    plain = tfa.onepass_attention_plain if route == "onepass" else tfa.online_attention_plain
    got = plain(_t(q), _t(k), _t(v), scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=ATTN_TOL, atol=ATTN_TOL)


def test_wrappers_use_plain_version_on_cpu():
    q, k, v = _qkv(1, 512, 600, 2, 40, seed=9)
    before = (tfa.onepass_attention.launches, tfa.online_attention.launches)
    for wrapper, plain in ((tfa.onepass_attention, tfa.onepass_attention_plain),
                           (tfa.online_attention, tfa.online_attention_plain)):
        got = wrapper(_t(q), _t(k), _t(v), 0.3)
        torch.testing.assert_close(got, plain(_t(q), _t(k), _t(v), 0.3), rtol=0, atol=0)
    assert (tfa.onepass_attention.launches, tfa.online_attention.launches) == before


@pytest.mark.parametrize("kernel,dtype,d,width", [
    *(pytest.param("onepass", torch.bfloat16, d, w, id=f"{d}-{w}")
      for d, w in ((8, 40), (36, 40), (72, 80))),
    *(pytest.param("online", torch.bfloat16, d, w, id=f"online-{d}-{w}")
      for d, w in ((8, 40), (40, 40), (72, 80), (160, 160), (192, 512), (512, 512))),
    *(pytest.param("onepass", torch.float32, d, w, id=f"fp32-{d}-{w}")
      for d, w in ((8, 40), (36, 40), (72, 80), (100, 160))),
    *(pytest.param("online", torch.float32, d, w, id=f"online-fp32-{d}-{w}")
      for d, w in ((36, 40), (72, 80), (160, 160), (170, 192), (192, 192), (200, 512))),
])
def test_onepass_pad_path(kernel, dtype, d, width):
    """The kernels, K1's first, run other head widths zero-padded to the next width
    they are built for (``KERNEL_WIDTHS``; K2's bf16: 40/80/160 on path A, 512 on
    path B; its fp32: 40/80/160/192, then 512): the padded call, sliced, equals
    the unpadded one (plain version)."""
    q, k, v = (_t(a) for a in _qkv(2, 64, 96, 3, d, seed=d))
    assert tfa.kernel_width(kernel, dtype, d) == width
    padded = [tfa.pad_head_dim(t, width) for t in (q, k, v)]
    for t, pt in zip((q, k, v), padded):
        assert pt.shape == (*t.shape[:-1], width) and pt.is_contiguous()
        assert torch.equal(pt[..., :d], t) and not pt[..., d:].any()
    scale = d ** -0.5
    plain = getattr(tfa, f"{kernel}_attention_plain")
    got = plain(*padded, scale)
    torch.testing.assert_close(got[..., :d], plain(q, k, v, scale), rtol=1e-6, atol=1e-6)
    assert not got[..., d:].any()


@pytest.mark.parametrize("dtype,layout,aligned", [
    (torch.float32, "contiguous", True),
    (torch.float32, "fused_qkv", True),       # the UNet's to_qkv views: no copy
    (torch.float32, "odd_stride", False),     # rows 4 bytes apart from 16-byte starts
    (torch.bfloat16, "fused_qkv", True),
    (torch.bfloat16, "odd_stride", False),
])
def test_rows_16b(dtype, layout, aligned):
    """Which inputs the kernels take as they are, and which go through the
    zero-padded copy: every (B, S, H) row must start on 16 bytes."""
    b, s, h, d = 1, 8, 2, 40
    if layout == "fused_qkv":
        x = torch.zeros(b, s, 3 * h * d, dtype=dtype)
        ts = [t.unflatten(-1, (h, d)) for t in x.chunk(3, dim=-1)]
    elif layout == "odd_stride":
        ts = [torch.zeros(b, s, h, d + 1, dtype=dtype)[..., :d] for _ in range(3)]
    else:
        ts = [torch.zeros(b, s, h, d, dtype=dtype) for _ in range(3)]
    assert all(tfa._rows_16b(t) == aligned for t in ts)


@pytest.mark.parametrize("scale", [-0.3, 0.0, 0.2])
def test_positive_scale_keeps_the_scores(scale):
    """K2's bf16 wrapper runs a scale <= 0 as a positive one on a negated or zeroed
    k: the scores, and so the attention, are exactly those of the given scale."""
    q, k, v = (_t(a) for a in _qkv(1, 64, 96, 2, 40, seed=3))
    k2, scale2 = tfa.positive_scale(k, scale)
    assert scale2 > 0
    torch.testing.assert_close(tfa._scores(q, k2) * scale2, tfa._scores(q, k) * scale,
                               rtol=0, atol=0)
    torch.testing.assert_close(tfa.online_attention_plain(q, k2, v, scale2),
                               tfa.online_attention_plain(q, k, v, scale), rtol=0, atol=0)


def _jax_route(sq, sk, d, causal):
    if not jfa.supports(sq, sk, d, causal, itemsize=2):
        return "plain"
    return "onepass" if jfa._use_onepass(sq, sk, d, itemsize=2) else "online"


@pytest.mark.parametrize("sq,sk,d,causal", [
    (4096, 4096, 40, False),
    (1024, 1024, 80, False),
    (4096, 4096, 512, False),
    (16384, 16384, 40, False),
    (4096, 77, 40, False),
    (256, 256, 160, False),
    (77, 77, 64, True),
])
def test_routing_matches_jax(sq, sk, d, causal):
    assert tfa.route(sq, sk, d, causal) == _jax_route(sq, sk, d, causal)


@pytest.mark.parametrize("sq,sk,heads,causal", [
    (77, 77, 12, True),     # CLIP causal
    (64, 77, 8, False),     # cross-attention
    (64, 64, 8, False),     # self-attention at a small level
    (9, 13, 2, True),       # causal with sq != sk
])
def test_multi_head_attention(sq, sk, heads, causal):
    rs = _rs(10)
    hd = heads * 8
    q = rs.normal(0, 1, (2, sq, hd)).astype(np.float32)
    k = rs.normal(0, 1, (2, sk, hd)).astype(np.float32)
    v = rs.normal(0, 1, (2, sk, hd)).astype(np.float32)
    want = np.asarray(jattn.multi_head_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), num_heads=heads, causal=causal))
    got = tattn.multi_head_attention(_t(q), _t(k), _t(v), num_heads=heads, causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=ATTN_TOL, atol=ATTN_TOL)


def test_single_head_spatial_attention():
    rs = _rs(11)
    q, k, v = (rs.normal(0, 1, (1, 64, 32)).astype(np.float32) for _ in range(3))
    want = np.asarray(jattn.single_head_spatial_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = tattn.single_head_spatial_attention(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), want, rtol=ATTN_TOL, atol=ATTN_TOL)
