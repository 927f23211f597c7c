"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA card and ``nvcc`` (Hopper, ``sm_90a``) and skips
where torch sees no CUDA device. The JAX package is not imported, so the file also
runs where JAX is not installed; on the card, from the root of the checkout:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports JAX and hides the card.)
"""

import pytest
import torch

import chip_smoke
from minsdtf_tpu_torch.ops import attention as tattn
from minsdtf_tpu_torch.ops import flash_attention as tfa

pytestmark = pytest.mark.cuda

# (rtol, atol): the on-card smoke run's limits; chip_smoke.py says why.
TOL = chip_smoke.TOL


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(b, sq, sk, h, d, dtype, layout, device, seed=0):
    """(B, S, H, D) q, k, v laid out in memory as ``layout`` says
    (:func:`chip_smoke.qkv`)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return chip_smoke.qkv(b, sq, sk, h, d, dtype, gen, layout)


@pytest.mark.parametrize("kernel,b,sq,sk,h,d,dtype,layout", [
    ("onepass", 2, 512, 512, 2, 40, torch.bfloat16, "fused_qkv"),
    ("onepass", 1, 640, 700, 3, 40, torch.bfloat16, "contiguous"),   # ragged q and kv tiles
    ("onepass", 1, 100, 530, 1, 160, torch.float32, "heads_first"),
    ("onepass", 1, 64, 4096, 2, 8, torch.bfloat16, "contiguous"),   # zero-padded to 40
    ("onepass", 1, 1000, 777, 2, 40, torch.bfloat16, "contiguous"),  # ragged q and KV tiles
    ("onepass", 1, 1000, 4095, 2, 40, torch.bfloat16, "contiguous"),
    ("onepass", 1, 1000, 777, 2, 80, torch.bfloat16, "contiguous"),
    ("onepass", 1, 1000, 4095, 2, 80, torch.bfloat16, "contiguous"),
    ("onepass", 1, 512, 512, 2, 80, torch.bfloat16, "fused_qkv"),
    ("onepass", 1, 512, 512, 2, 160, torch.bfloat16, "fused_qkv"),
    ("onepass", 1, 300, 700, 2, 80, torch.bfloat16, "heads_first"),
    ("onepass", 1, 300, 700, 2, 160, torch.bfloat16, "heads_first"),
    ("onepass", 1, 300, 777, 2, 36, torch.bfloat16, "contiguous"),   # zero-padded to 40
    ("onepass", 1, 300, 600, 2, 40, torch.bfloat16, "odd_stride"),   # copied to 16-byte rows
    ("onepass", 1, 2048, 2048, 2, 40, torch.bfloat16, "adversarial"),
    ("onepass", 1, 1000, 1000, 2, 80, torch.bfloat16, "adversarial"),
    ("online", 1, 300, 1000, 1, 512, torch.bfloat16, "contiguous"),
    ("online", 1, 70, 513, 2, 192, torch.float32, "heads_first"),
    ("online", 1, 256, 4100, 1, 40, torch.bfloat16, "heads_first"),
    # K2 path A (d <= 160)
    ("online", 1, 300, 9000, 2, 40, torch.bfloat16, "fused_qkv"),
    ("online", 1, 1000, 5000, 2, 80, torch.bfloat16, "contiguous"),    # ragged q and KV tiles
    ("online", 1, 1000, 5000, 2, 160, torch.bfloat16, "heads_first"),
    ("online", 1, 300, 5000, 2, 36, torch.bfloat16, "contiguous"),     # zero-padded to 40
    ("online", 1, 300, 5000, 2, 40, torch.bfloat16, "odd_stride"),     # copied to 16-byte rows
    ("online", 1, 2048, 8192, 2, 40, torch.bfloat16, "adversarial"),
    ("online", 1, 70, 40, 2, 80, torch.bfloat16, "contiguous"),        # one ragged KV tile
    # K2 path B (d = 512)
    ("online", 1, 1000, 1000, 1, 512, torch.bfloat16, "contiguous"),   # ragged q and KV tiles
    ("online", 2, 256, 777, 2, 512, torch.bfloat16, "heads_first"),
    ("online", 1, 300, 1000, 1, 192, torch.bfloat16, "contiguous"),    # zero-padded to 512
    ("online", 1, 300, 600, 1, 512, torch.bfloat16, "odd_stride"),     # copied to 16-byte rows
    ("online", 1, 2048, 2048, 1, 512, torch.bfloat16, "adversarial"),
    ("online", 1, 70, 20, 1, 512, torch.bfloat16, "contiguous"),       # one ragged KV tile
])
def test_kernel_matches_plain(cuda, kernel, b, sq, sk, h, d, dtype, layout):
    wrapper = getattr(tfa, f"{kernel}_attention")
    plain = getattr(tfa, f"{kernel}_attention_plain")
    q, k, v = _qkv(b, sq, sk, h, d, dtype, layout, cuda)
    scale = d ** -0.5
    before = wrapper.launches
    got = wrapper(q, k, v, scale)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert got.shape == q.shape and got.dtype == dtype and got.is_contiguous()
    want = plain(q, k, v, scale)
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q, k, v = _qkv(1, 512, 512, 1, 40, torch.bfloat16, "contiguous", cuda)
    for wrapper in (tfa.onepass_attention, tfa.online_attention):
        before = wrapper.launches
        with pytest.raises(ValueError, match="dtype"):
            wrapper(q.half(), k.half(), v.half(), 0.1)
        with pytest.raises(ValueError, match="contiguous"):
            wrapper(q.transpose(2, 3), k.transpose(2, 3), v.transpose(2, 3), 0.1)
        with pytest.raises(ValueError, match="shape"):
            wrapper(q, k[:, :, :, :8], v, 0.1)
        with pytest.raises(ValueError):
            wrapper(q, k.cpu(), v, 0.1)
        assert wrapper.launches == before
    wide = _qkv(1, 512, 512, 1, 192, torch.bfloat16, "contiguous", cuda)
    with pytest.raises(ValueError, match="head dim"):
        tfa.onepass_attention(*wide, 0.1)


@pytest.mark.parametrize("d", [40, 512])
@pytest.mark.parametrize("sign", [-1, 0])
def test_online_bf16_takes_any_scale(cuda, d, sign):
    """K2's bf16 paths keep the running max on the unscaled scores; the wrapper
    hands them a positive scale with the same scores (:func:`positive_scale`)."""
    q, k, v = _qkv(1, 300, 1000, 2, d, torch.bfloat16, "contiguous", cuda)
    scale = sign * d ** -0.5
    before = tfa.online_attention.launches
    got = tfa.online_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert tfa.online_attention.launches == before + 1
    want = tfa.online_attention_plain(q, k, v, scale)
    rtol, atol = TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("sq,sk,heads,d,causal,route", [
    (512, 512, 2, 40, False, "onepass"),
    (256, 512, 1, 512, False, "online"),
    (256, 16384, 2, 40, False, "online"),   # the 1024px UNet level 0
    (512, 77, 2, 40, False, "plain"),
    (77, 77, 2, 64, True, "plain"),
])
def test_multi_head_attention_routes_on_the_card(cuda, sq, sk, heads, d, causal, route):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(2, sq, heads * d, generator=gen, device=cuda).bfloat16()
    k = torch.randn(2, sk, heads * d, generator=gen, device=cuda).bfloat16()
    v = torch.randn(2, sk, heads * d, generator=gen, device=cuda).bfloat16()
    before = (tfa.onepass_attention.launches, tfa.online_attention.launches)
    got = tattn.multi_head_attention(q, k, v, num_heads=heads, causal=causal)
    torch.cuda.synchronize()
    after = (tfa.onepass_attention.launches, tfa.online_attention.launches)
    assert after == (before[0] + (route == "onepass"), before[1] + (route == "online"))
    split = [t.unflatten(-1, (heads, d)) for t in (q, k, v)]
    want = tattn.plain_attention(*split, d ** -0.5, causal).flatten(2)
    rtol, atol = TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
