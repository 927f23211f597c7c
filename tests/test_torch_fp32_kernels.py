"""The fp32 attention kernels' plain versions against the JAX package (its Pallas
kernels in interpret mode), fp32 on the CPU, at the shapes the fp32 kernels take:
ragged q and KV tiles, the widths of the fp32 pipelines (40, 80, 160) and the
small VAE's 192 and the VAE's 512 on K2's route.

Inputs are made with numpy from a seed and handed to both frameworks. On the CPU
the wrappers compute these plain versions; on the card ``chip_smoke.py`` phase 3
holds each kernel against them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minsdtf_tpu.ops import attention as jattn
from minsdtf_tpu.ops import flash_attention as jfa
from minsdtf_tpu_torch.ops import flash_attention as tfa
from torch_port_utils import one_torch_thread  # noqa: F401

# fp32 against fp32: the products and sums run in another order on each side
ATTN_TOL = 2e-5


def _qkv(b, sq, sk, h, d, seed):
    rs = np.random.RandomState(seed)
    return tuple(rs.normal(0, 1, (b, s, h, d)).astype(np.float32) for s in (sq, sk, sk))


@pytest.mark.parametrize("sq,sk,d", [
    (1024, 777, 40),     # ragged KV tiles on K1's route: the Pallas one-pass kernel
    (1000, 777, 40),     # ragged q and KV tiles: the XLA path
    (1000, 4095, 40),
    (1024, 777, 80),
    (1000, 777, 80),
    (1000, 4095, 80),
    (1024, 777, 160),
    (1000, 777, 192),    # the small VAE's width on K2's route
    (320, 1000, 192),    # the Pallas online kernel
    (1000, 1000, 512),   # the VAE's width, ragged tiles
])
def test_fp32_plain_versions_match_jax(sq, sk, d):
    """The plain version of the kernel the port routes to, against what the JAX
    package runs for the shape: ``fa.flash_attention(interpret=True)`` where its
    Pallas kernels take it (JAX picks its own: fp32 past 2048 keys goes to its
    online kernel), else the XLA path (``Precision.HIGHEST``) that its attention
    routes it to, since the Pallas kernels take only q and KV lengths their blocks
    divide."""
    q, k, v = _qkv(1, sq, sk, 2, d, seed=sq + sk + d)
    scale = d ** -0.5
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    if jfa.supports(sq, sk, d, itemsize=4):
        want = jfa.flash_attention(jq, jk, jv, scale=scale, interpret=True)
    else:
        want = jattn._xla_attention(jq, jk, jv, scale, causal=False)
    route = tfa.route(sq, sk, d)
    assert route == ("onepass" if d <= 160 else "online")
    plain = getattr(tfa, f"{route}_attention_plain")
    got = plain(*(torch.from_numpy(a) for a in (q, k, v)), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATTN_TOL, atol=ATTN_TOL)


@pytest.mark.parametrize("sq,sk,d", [(1000, 777, 40), (300, 4095, 80), (200, 600, 160)])
def test_fp32_conventions_agree(sq, sk, d):
    """In fp32 K1's convention (exp2 of scores from a pre-scaled q) and K2's (exp of
    the scaled scores) compute one function up to fp32 rounding: the fp32 body
    serves both, and the route may send a call to either."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, sq, sk, 2, d, seed=d))
    scale = d ** -0.5
    torch.testing.assert_close(tfa.onepass_attention_plain(q, k, v, scale),
                               tfa.online_attention_plain(q, k, v, scale),
                               rtol=ATTN_TOL, atol=ATTN_TOL)


@pytest.mark.parametrize("kernel", ["onepass", "online"])
@pytest.mark.parametrize("layout", ["fused_qkv", "odd_stride"])
def test_fp32_wrappers_on_strided_cpu_tensors(kernel, layout):
    """On CPU tensors the wrappers give the plain version for the strided layouts
    the kernels meet on the card, with no launch."""
    b, s, h, d = 1, 600, 2, 40
    rs = np.random.RandomState(7)
    if layout == "fused_qkv":
        x = torch.from_numpy(rs.normal(0, 1, (b, s, 3 * h * d)).astype(np.float32))
        q, k, v = (t.unflatten(-1, (h, d)) for t in x.chunk(3, dim=-1))
    else:
        q, k, v = (torch.from_numpy(rs.normal(0, 1, (b, s, h, d + 1)).astype(np.float32))[..., :d]
                   for _ in range(3))
    wrapper = getattr(tfa, f"{kernel}_attention")
    before = wrapper.launches
    got = wrapper(q, k, v, 0.2)
    assert wrapper.launches == before
    want = getattr(tfa, f"{kernel}_attention_plain")(*(t.contiguous() for t in (q, k, v)), 0.2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("kernel", ["onepass", "online"])
def test_plain_versions_run_fp64_inputs_in_fp64(kernel):
    """Given fp64 inputs the plain versions compute their function with fp64
    rounding (the on-card checks hold the fp32 kernels to that), and their fp32
    evaluation stays within ATTN_TOL of it."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 300, 700, 2, 40, seed=11))
    scale = 40 ** -0.5
    plain = getattr(tfa, f"{kernel}_attention_plain")
    got = plain(q.double(), k.double(), v.double(), scale)
    assert got.dtype == torch.float64
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * scale
    p = torch.softmax(s, dim=-1)
    want = torch.einsum("bhqk,bkhd->bqhd", p, v.double())
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(plain(q, k, v, scale).double(), want, rtol=ATTN_TOL,
                               atol=ATTN_TOL)
