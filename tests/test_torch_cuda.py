"""The port's CUDA kernels on the card, against their plain PyTorch versions; the
VAE encoder and ControlNet that run them on the img2img and ControlNet paths,
against the same modules on the CPU; the step loop at batch 2 in bf16 on the
card against fp32 on the CPU; a merged batch of 2 against batch 1 in bf16; the
kernels' refusal of a gradient they cannot give, small-width training steps
on the card against the CPU, the int8 path's products (``torch._int_mm``) and
im2col convolution on the card against the CPU, with an int8 UNet that launches
K1; K1 at the shapes Megatron TP gives it, and ring attention on two ``gloo``
ranks sharing the card against the plain version.

Every test here needs an NVIDIA card and ``nvcc`` (Hopper, ``sm_90a``) and skips
where torch sees no CUDA device. The JAX package is not imported, so the file also
runs where JAX is not installed; on the card, from the root of the checkout:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports JAX and hides the card.)
"""

import numpy as np
import pytest
import torch

import chip_smoke
from minsdtf_tpu_torch.models.common import Int8Site
from minsdtf_tpu_torch.ops import attention as tattn
from minsdtf_tpu_torch.ops import basic as tbasic
from minsdtf_tpu_torch.ops import flash_attention as tfa
from minsdtf_tpu_torch.tools import selfcheck

pytestmark = pytest.mark.cuda

# (rtol, atol): the on-card smoke run's limits; the selfcheck module says why.
TOL = selfcheck.TOL


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    # fp32 (K1; K2's fp32 body at d <= 192, its d = 512 kernel)
    ("onepass", 2, 4096, 4096, 8, 40, torch.float32, "fused_qkv"),    # the fp32 512px shapes
    ("onepass", 2, 1024, 1024, 8, 80, torch.float32, "fused_qkv"),
    ("online", 1, 4096, 4096, 1, 512, torch.float32, "fused_qkv"),
    ("onepass", 1, 1000, 777, 2, 40, torch.float32, "contiguous"),    # ragged q and KV tiles
    ("onepass", 1, 1000, 4095, 2, 40, torch.float32, "contiguous"),
    ("onepass", 1, 1000, 777, 2, 80, torch.float32, "contiguous"),
    ("onepass", 1, 1000, 4095, 2, 80, torch.float32, "contiguous"),
    ("onepass", 1, 1000, 777, 2, 160, torch.float32, "contiguous"),
    ("onepass", 1, 1000, 4095, 2, 160, torch.float32, "contiguous"),
    ("onepass", 1, 1000, 777, 2, 36, torch.float32, "contiguous"),    # zero-padded to 40
    ("onepass", 1, 1000, 777, 2, 40, torch.float32, "odd_stride"),    # copied to 16-byte rows
    ("onepass", 1, 2048, 2048, 2, 40, torch.float32, "adversarial"),
    ("online", 1, 1024, 5000, 2, 40, torch.float32, "contiguous"),    # past 4096 keys
    ("online", 1, 1000, 5000, 2, 160, torch.float32, "contiguous"),
    ("online", 1, 1000, 1000, 1, 192, torch.float32, "contiguous"),   # the small VAE's width
    ("online", 1, 1000, 1000, 1, 512, torch.float32, "contiguous"),   # ragged q and KV tiles
    ("online", 1, 70, 20, 1, 512, torch.float32, "contiguous"),       # one ragged KV tile
    ("online", 1, 300, 1000, 1, 300, torch.float32, "contiguous"),    # zero-padded to 512
    ("online", 1, 1000, 5000, 2, 36, torch.float32, "contiguous"),    # zero-padded to 40
    ("online", 1, 1000, 5000, 2, 40, torch.float32, "odd_stride"),    # copied to 16-byte rows
    ("online", 1, 2048, 8192, 2, 40, torch.float32, "adversarial"),
    ("online", 1, 2048, 2048, 1, 512, torch.float32, "adversarial"),
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
    if dtype == torch.float32:  # the function itself: fp32's own rounding nears TOL
        got, want = got.double(), plain(q.double(), k.double(), v.double(), scale)
    else:
        got, want = got.float(), plain(q, k, v, scale).float()
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [40, 512])
@pytest.mark.parametrize("sign", [-1, 0])
def test_online_bf16_takes_any_scale(cuda, d, sign, dtype):
    """K2's kernels (bf16 and fp32) keep the running max on the unscaled scores;
    the wrapper hands them a positive scale with the same scores
    (:func:`positive_scale`)."""
    q, k, v = _qkv(1, 300, 1000, 2, d, dtype, "contiguous", cuda)
    scale = sign * d ** -0.5
    before = tfa.online_attention.launches
    got = tfa.online_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert tfa.online_attention.launches == before + 1
    want = tfa.online_attention_plain(q, k, v, scale)
    rtol, atol = TOL[dtype]
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


# The bf16 encoder against fp32 on the card: bf16 keeps 8 significant bits, so
# each of the encoder's ~30 layers rounds by up to 2**-9 relative; as independent
# roundings these add to about sqrt(30) * 2**-9 = 1.1e-2 of the output's rms.
# The bound allows about three times that.
ENCODER_BF16_REL_RMS = 2.0 ** -5


def _encoder_and_image(seed=0):
    """The full-width encoder on the CPU, and a (1, 256, 256, 3) image in [-1, 1]."""
    from minsdtf_tpu_torch.models import vae as tvae

    encoder = tvae.init_encoder("cpu", seed=4).eval()
    gen = torch.Generator().manual_seed(seed)
    image = torch.rand(1, 256, 256, 3, generator=gen) * 2 - 1
    return encoder, image


def test_vae_encoder_on_the_card_matches_the_cpu(cuda):
    """fp32 at full widths, 256x256: the mid block's (1, 1024, 1, 512) attention
    runs on K2 on the card and on its plain version on the CPU."""
    encoder, image = _encoder_and_image()
    with torch.inference_mode():
        want = encoder(image)
        before = tfa.online_attention.launches
        got = encoder.to(cuda)(image.to(cuda))
        torch.cuda.synchronize()
    assert tfa.online_attention.launches == before + 1
    assert got.shape == want.shape == (1, 32, 32, 4)
    scale = want.abs().max().item()
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4 * scale)


def test_vae_encoder_bf16_is_within_its_bound_of_fp32(cuda):
    from minsdtf_tpu_torch.models.common import cast_weights_

    encoder, image = _encoder_and_image(seed=1)
    encoder, image = encoder.to(cuda), image.to(cuda)
    with torch.inference_mode():
        want = encoder(image)
        got = cast_weights_(encoder, torch.bfloat16)(image.bfloat16()).float()
    assert torch.isfinite(got).all()
    rel_rms = ((got - want).square().mean() / want.square().mean()).sqrt().item()
    assert rel_rms <= ENCODER_BF16_REL_RMS, rel_rms


def test_controlnet_residuals_on_the_card_match_the_cpu(cuda):
    """fp32 at small widths on a 32x32 latent: the level-0 self-attention (1024
    tokens, d=40) runs on K1 on the card, twice a call."""
    from minsdtf_tpu_torch.models import controlnet as tcontrolnet
    from minsdtf_tpu_torch.models import unet as tunet

    small = dict(widths=(320, 64, 128, 128), temb_dim=128)
    model = tunet.fuse_attention_projections(tcontrolnet.init("cpu", seed=3, **small)).eval()
    gen = torch.Generator().manual_seed(2)
    latent = torch.randn(2, 32, 32, 4, generator=gen)
    t_emb = torch.randn(2, 320, generator=gen)
    context = torch.randn(2, 77, 768, generator=gen)
    image = torch.rand(2, 256, 256, 3, generator=gen)
    with torch.inference_mode():
        want = model(latent, t_emb, context, model.controlnet_cond_embedding(image))
        model = model.to(cuda)
        before = tfa.onepass_attention.launches
        got = model(latent.to(cuda), t_emb.to(cuda), context.to(cuda),
                    model.controlnet_cond_embedding(image.to(cuda)))
        torch.cuda.synchronize()
    assert tfa.onepass_attention.launches == before + 2
    assert len(got) == len(want) == 13
    for g, w in zip(got, want):
        scale = w.abs().max().item()
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("case", chip_smoke.BATCH_CASES, ids=lambda c: "-".join(map(str, c)))
def test_kernel_matches_plain_at_the_batch_shapes(cuda, case):
    """The shapes of TCD at batch 8 and of the two-call CFG path, as phase 3 of
    the smoke run checks them (its p-rounding slack included)."""
    wrapper = getattr(tfa, f"{case[0]}_attention")
    before = wrapper.launches
    ok, _, line = chip_smoke.check_case(case)
    assert wrapper.launches == before + 1
    assert ok, line


@pytest.mark.parametrize("case", chip_smoke.TP_CASES, ids=lambda c: "-".join(map(str, c)))
def test_kernel_matches_plain_at_the_tp_shapes(cuda, case):
    """The shapes of the UNet's self-attention under TP, 8 / model heads a rank,
    as phase 3 of the smoke run checks them."""
    wrapper = getattr(tfa, f"{case[0]}_attention")
    before = wrapper.launches
    ok, _, line = chip_smoke.check_case(case)
    assert wrapper.launches == before + 1
    assert ok, line


def _ring_rank(b, s, h, d):
    """One of two gloo ranks on the card: ring attention with the tokens split over
    the data axis, fp32 and bf16, against the plain version of the whole inputs on
    the card. Returns {dtype: (max error over the limit, K1/K2 launches)}."""
    from minsdtf_tpu_torch.ops.ring_attention import ring_multi_head_attention
    from minsdtf_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(2, 1)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn(b, s, h * d, generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        launches = tfa.onepass_attention.launches + tfa.online_attention.launches
        got = ring_multi_head_attention(q, k, v, h, mesh).float()
        launches = tfa.onepass_attention.launches + tfa.online_attention.launches - launches
        want = tattn.plain_attention(*(t.unflatten(-1, (h, d)) for t in (q, k, v)),
                                     d ** -0.5).reshape(b, s, h * d).float()
        rtol, atol = (2e-4, 2e-4) if dtype == torch.float32 else TOL[dtype]
        out[str(dtype)] = (float(((got - want).abs() / (atol + rtol * want.abs())).max()),
                           launches)
    return out


def test_ring_on_two_gloo_ranks_sharing_the_card(cuda):
    """Ring attention at the 512px UNet level-0 shape (2, 4096, 8, 40) on two gloo
    ranks on one card (NCCL refuses two ranks on one GPU): the K/V shifts go
    through pinned host memory, and each rank's output is within the plain
    version's limits (fp32 2e-4; bf16 the kernels' TOL), with no kernel launch."""
    from minsdtf_tpu_torch.parallel.mesh import run_ranks

    for rank in run_ranks(_ring_rank, 2, args=(2, 4096, 8, 40), device="cuda", timeout_s=300):
        for dtype, (ratio, launches) in rank.items():
            assert ratio <= 1.0, (dtype, ratio)
            assert launches == 0, dtype


@pytest.mark.parametrize("case", chip_smoke.SERVE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_kernel_matches_plain_at_the_serve_shapes(cuda, case):
    """The shapes of the server's merged batches of 2 and 4 images, as phase 3 of
    the smoke run checks them."""
    wrapper = getattr(tfa, f"{case[0]}_attention")
    before = wrapper.launches
    ok, _, line = chip_smoke.check_case(case)
    assert wrapper.launches == before + 1
    assert ok, line


def test_bf16_merged_batch_of_2_matches_batch_1(cuda, tmp_path):
    """Two requests merged as the server merges them (stacked contexts, each seed's
    noise row) at 256x256 with a small UNet and VAE in bf16, against each at batch
    1. The batch changes the order of the card's bf16 sums, so the two are two
    bf16 roundings of one fp32 result (the smoke run's phase 9b reads up to 21 of
    255 apart at full width, in nearly every pixel): each differs from the other
    by no more than twice the batch-1 run's own distance from fp32, in the
    latents' relative rms and in the images' largest difference."""
    from minsdtf_tpu_torch import StableDiffusion
    from minsdtf_tpu_torch import rng as trng
    from minsdtf_tpu_torch.models import clip as tclip
    from minsdtf_tpu_torch.models import unet as tunet
    from minsdtf_tpu_torch.models import vae as tvae
    from minsdtf_tpu_torch.models.common import cast_weights_

    small = dict(widths=(320, 64, 128, 128), temb_dim=128)
    modules = dict(_unet=tunet.fuse_attention_projections(tunet.init("cpu", seed=0, **small)),
                   _decoder=tvae.init_decoder("cpu", seed=2, dec_widths=(192, 64, 32, 32)),
                   _text_model=tclip.init("cpu", seed=1))
    bpe = chip_smoke.synthetic_merges(str(tmp_path))
    gen = torch.Generator().manual_seed(5)
    contexts = torch.randn(2, 77, 768, generator=gen)
    seeds = (7, 8)
    kw = dict(num_steps=3, unconditional_guidance_scale=7.5, guidance_rescale=0.7,
              return_latent=True)

    def run(dtype):
        pipe = StableDiffusion(256, 256, bpe_path=bpe, compute_dtype=dtype, device=cuda)
        for name, module in modules.items():
            setattr(pipe, name, cast_weights_(module.to(cuda), dtype).eval())
        merged = pipe.generate_image(
            contexts, batch_size=2,
            diffusion_noise=np.concatenate([trng.stateless_normal((1, 32, 32, 4), s)
                                            for s in seeds]), **kw)
        singles = [pipe.generate_image(contexts[i], seed=s, **kw) for i, s in enumerate(seeds)]
        return merged, tuple(np.concatenate(parts) for parts in zip(*singles))

    (img_m, lat_m), (img_1, lat_1) = run(torch.bfloat16)
    _, (img_32, lat_32) = run(torch.float32)

    def rel_rms(a, b):
        return float(np.sqrt(np.square(a - b).mean() / np.square(b).mean()))

    def max_diff(a, b):
        return int(np.abs(a.astype(int) - b.astype(int)).max())

    assert img_m.shape == img_1.shape == (2, 256, 256, 3)
    print(f"merged vs batch 1, bf16: latent rel rms {rel_rms(lat_m, lat_1):.3e} (batch 1 bf16 "
          f"vs fp32 {rel_rms(lat_1, lat_32):.3e}), image max |diff| {max_diff(img_m, img_1)} "
          f"(bf16 vs fp32 {max_diff(img_1, img_32)}), share of values that differ "
          f"{float((img_m != img_1).mean()):.6f}")
    assert rel_rms(lat_m, lat_1) <= 2 * rel_rms(lat_1, lat_32)
    assert max_diff(img_m, img_1) <= 2 * max_diff(img_1, img_32)


def _sampler_run(device, dtype, unet, mode):
    """Batch 2 under CFG 7.5, 3 steps, on a 32x32 latent: the UNet's level 0
    self-attention (1024 tokens, d=40) runs on K1 at B = 4 on the card."""
    from minsdtf_tpu_torch import sampler as tsampler
    from minsdtf_tpu_torch import scheduler as tsched
    from minsdtf_tpu_torch.models.common import cast_weights_

    schedule = tsched.build_denoise_schedule(tsched.make_scheduler(mode), 3)
    gen = torch.Generator().manual_seed(3)
    latent0 = torch.randn(2, 32, 32, 4, generator=gen)
    ctx = torch.randn(2, 77, 768, generator=gen)
    unc = torch.randn(1, 77, 768, generator=gen)
    noise = torch.randn(3, 2, 32, 32, 4, generator=gen)
    t_embs = torch.from_numpy(tsched.timestep_embedding(schedule.timesteps))
    unet = cast_weights_(unet.to(device), dtype)
    with torch.inference_mode():
        _, latent = tsampler.generate(
            unet, None, latent0.to(device, dtype), ctx.to(device), unc.to(device),
            t_embs.to(device), schedule.rows, 7.5, 0.7, mode=schedule.mode,
            step_noise=noise.to(device) if mode == "euler_a" else None)
    return latent.float().cpu()


@pytest.mark.parametrize("mode", ["ddim", "euler_a"])
def test_bf16_sampler_at_batch_2_on_the_card_matches_the_cpu(cuda, mode):
    """The card's bf16 run errs from the CPU's fp32 run by no more than twice as
    much as the same bf16 run on the CPU does: the card adds no error of its own
    beyond bf16's rounding."""
    from minsdtf_tpu_torch.models import unet as tunet

    def make():
        small = dict(widths=(320, 64, 128, 128), temb_dim=128)
        return tunet.fuse_attention_projections(tunet.init("cpu", seed=0, **small)).eval()

    want = _sampler_run("cpu", torch.float32, make(), mode)
    cpu_bf16 = _sampler_run("cpu", torch.bfloat16, make(), mode)
    before = tfa.onepass_attention.launches
    card_bf16 = _sampler_run(cuda, torch.bfloat16, make(), mode)
    # level 0's 2 down and 3 up self-attentions, once a step on the CFG pair
    assert tfa.onepass_attention.launches == before + 3 * 5

    def rel_rms(got):
        return ((got - want).square().mean() / want.square().mean()).sqrt().item()

    assert torch.isfinite(card_bf16).all() and card_bf16.shape == (2, 32, 32, 4)
    assert rel_rms(card_bf16) <= 2 * rel_rms(cpu_bf16), (rel_rms(card_bf16), rel_rms(cpu_bf16))


def test_checkpoint_files_load_on_the_card_as_assigned_modules(cuda, tmp_path):
    """Full-width CLIP and VAE written to ``.safetensors`` files and loaded by the
    pipeline in bf16 on the card give the same tensors and the same txt2img and
    img2img images as the same weights assigned directly (a small UNet shared by
    both). The VAE's attention runs on K2 and the UNet's level 0 on K1."""
    from minsdtf_tpu_torch import StableDiffusion
    from minsdtf_tpu_torch.models import clip as tclip
    from minsdtf_tpu_torch.models import unet as tunet
    from minsdtf_tpu_torch.models import vae as tvae
    from minsdtf_tpu_torch.models.common import cast_weights_

    text, enc, dec = (tclip.init("cpu", seed=1), tvae.init_encoder("cpu", seed=4),
                      tvae.init_decoder("cpu", seed=2))
    te = chip_smoke.write_safetensors(str(tmp_path / "te.safetensors"), text.state_dict())
    vae = chip_smoke.write_safetensors(str(tmp_path / "vae.safetensors"),
                                       {**enc.state_dict(), **dec.state_dict()})
    unet = tunet.fuse_attention_projections(tunet.init(
        cuda, seed=0, widths=(320, 64, 128, 128), temb_dim=128))
    unet = cast_weights_(unet, torch.bfloat16).eval()
    bpe = chip_smoke.synthetic_merges(str(tmp_path))
    loaded = StableDiffusion(256, 256, bpe_path=bpe, text_encoder_ckpt=te, vae_ckpt=vae)
    assigned = StableDiffusion(256, 256, bpe_path=bpe)
    assert loaded.compute_dtype == assigned.compute_dtype == torch.bfloat16
    loaded._unet = assigned._unet = unet
    for name, module in (("_text_model", text), ("_encoder", enc), ("_decoder", dec)):
        setattr(assigned, name, cast_weights_(module.to(cuda), torch.bfloat16).eval())
    for name in ("text_model", "encoder", "decoder"):
        got, want = getattr(loaded, name).state_dict(), getattr(assigned, name).state_dict()
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key
    reference, _, _ = chip_smoke.synthetic_inputs(256)
    for call in (lambda p: p.text_to_image("hello world", num_steps=3, seed=7),
                 lambda p: p.image_to_image("hello world", num_steps=3, seed=7,
                                            reference_image=reference)):
        before = tfa.online_attention.launches
        image = call(loaded)
        assert tfa.online_attention.launches > before
        assert image.shape == (1, 256, 256, 3) and image.max() > image.min()
        assert np.array_equal(image, call(assigned))


@pytest.mark.parametrize("kernel", ["onepass", "online"])
def test_kernels_refuse_a_gradient(cuda, kernel):
    """The kernels have no backward: with grad mode on and an input that requires
    grad, the wrapper raises before it launches."""
    wrapper = getattr(tfa, f"{kernel}_attention")
    q, k, v = _qkv(1, 512, 512, 2, 40, torch.float32, "contiguous", cuda)
    before = wrapper.launches
    for needs_grad in ((q,), (k,), (v,), (q, k, v)):
        args = [t.detach().requires_grad_(any(t is n for n in needs_grad)) for t in (q, k, v)]
        with pytest.raises(RuntimeError, match="no backward"):
            wrapper(*args, 0.1)
    assert wrapper.launches == before


@pytest.mark.parametrize("mode", ["inference_mode", "no_grad"])
@pytest.mark.parametrize("kernel", ["onepass", "online"])
def test_kernels_launch_without_gradients(cuda, kernel, mode):
    wrapper = getattr(tfa, f"{kernel}_attention")
    q, k, v = (t.detach().requires_grad_() for t in _qkv(
        1, 512, 512, 2, 40, torch.float32, "contiguous", cuda))
    before = wrapper.launches
    with getattr(torch, mode)():
        got = wrapper(q, k, v, 0.1)
        torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    rtol, atol = TOL[torch.float32]
    with torch.no_grad():
        want = getattr(tfa, f"{kernel}_attention_plain")(q, k, v, 0.1)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


def test_small_train_steps_on_the_card_match_the_cpu(cuda):
    """Phase 10b: two AdamW steps of the small fused UNet at a 32x32 latent on the
    card and on the CPU, within the ``chip_smoke.TRAIN_*`` tolerances; the step
    takes the plain attention path, so no kernel launches."""
    ok, numbers = chip_smoke.compare_small_training()
    assert ok, numbers


# (M, K, N) of int8 products: a batch-1 time_emb_proj (2 rows, padded to 17), the
# 64x64 level's 3x3 convs as im2col at CFG batch 2, a fused to_qkv and a to_kv
INT8_MATMUL_SHAPES = [(2, 1280, 320), (8192, 2880, 320), (8192, 320, 960), (154, 768, 1280)]


@pytest.mark.parametrize("m,k,n", INT8_MATMUL_SHAPES)
def test_int8_matmul_on_the_card_equals_the_cpu(cuda, m, k, n):
    gen = torch.Generator().manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), dtype=torch.int8, generator=gen)
    w = torch.randint(-127, 128, (n, k), dtype=torch.int8, generator=gen)
    got = tbasic.int8_matmul(a.to(cuda), w.to(cuda))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got.cpu(), tbasic.int8_matmul(a, w))


def _int8_site(o, c, k, device, seed=0, act_scale=None):
    gen = torch.Generator().manual_seed(seed)
    site = Int8Site("s", torch.randint(-127, 128, (o, c, k, k), dtype=torch.int8, generator=gen),
                    torch.rand(o, generator=gen) * 1e-3, torch.randn(o, generator=gen) * 0.05,
                    act_scale=None if act_scale is None else torch.tensor(act_scale))
    return site.to(device)


@pytest.mark.parametrize("b,c,hw,o,k,stride,act_scale", [
    (2, 320, 64, 320, 3, 1, None), (1, 640, 64, 320, 3, 1, 0.03), (2, 320, 64, 320, 3, 2, None),
    (2, 640, 32, 1280, 1, 1, None)])
def test_int8_conv_on_the_card_equals_the_cpu(cuda, b, c, hw, o, k, stride, act_scale):
    """The fp32 int8 convolution is bit-equal across devices (every step is exact
    or one correctly rounded operation), and its im2col product equals an fp64
    convolution of the integer values (|sums| < 2^53: exact)."""
    x = torch.randn(b, c, hw, hw, generator=torch.Generator().manual_seed(1)) * 2.0
    pad = k // 2
    cpu_site = _int8_site(o, c, k, "cpu", act_scale=act_scale)
    card_site = _int8_site(o, c, k, cuda, act_scale=act_scale)
    got = tbasic.int8_conv2d(x.to(cuda), card_site, stride=stride, padding=pad)
    assert torch.equal(got.cpu(), tbasic.int8_conv2d(x, cpu_site, stride=stride, padding=pad))
    xq = torch.randint(-127, 128, (b, c, hw, hw), dtype=torch.int8,
                       generator=torch.Generator().manual_seed(2)).to(cuda)
    acc = tbasic.int8_conv_acc(xq, card_site.weight_q, stride, pad)
    want = torch.nn.functional.conv2d(xq.double(), card_site.weight_q.double(), stride=stride,
                                      padding=pad)
    assert torch.equal(acc.permute(0, 3, 1, 2).double(), want)


def test_int8_unet_runs_on_the_card_and_launches_k1(cuda):
    """A small int8 UNet in bf16 at 1024 tokens: its self-attentions on K1, every
    int8 site a product, a finite output."""
    from minsdtf_tpu_torch.models import unet as unet_lib
    from minsdtf_tpu_torch.models.common import cast_weights_
    from minsdtf_tpu_torch.weights import quantize

    unet = unet_lib.fuse_attention_projections(
        unet_lib.init("cpu", seed=0, widths=(320, 64, 128, 128), temb_dim=128))
    unet = cast_weights_(quantize.quantize_params(unet), torch.bfloat16).to(cuda).eval()
    sites = quantize.int8_sites(unet)
    gen = torch.Generator().manual_seed(3)
    latent = torch.randn(2, 32, 32, 4, generator=gen).to(cuda, torch.bfloat16)
    t_emb = torch.randn(2, 320, generator=gen).to(cuda, torch.bfloat16)
    ctx = torch.randn(2, 77, 768, generator=gen).to(cuda, torch.bfloat16)
    k1, calls = tfa.onepass_attention.launches, tbasic.int8_matmul.calls
    with torch.inference_mode():
        out = unet(latent, t_emb, ctx)
    torch.cuda.synchronize()
    # the five self-attentions at 1024 tokens (down_blocks.0 and up_blocks.3)
    assert tfa.onepass_attention.launches - k1 == 5
    assert tbasic.int8_matmul.calls - calls == len(sites) > 0
    assert out.shape == (2, 32, 32, 4) and bool(torch.isfinite(out).all())



# ---- the step loop as a captured program -------------------------------------------

PROGRAM_CASES = ("ddim", "dpm", "euler_a", "tcd_inpaint", "two_calls_int8")


def _program_setup(device, case: str):
    """Small bf16 modules on ``device`` and one call's arguments for ``case``: batch
    2 under CFG, 3 steps, a 32x32 latent (K1 at the UNet's level 0), the decoder at
    (192, 64, 32, 32) (K2 path B in its mid block); "two_calls_int8" has a 154-token
    negative context and an int8 UNet."""
    from minsdtf_tpu_torch import sampler as tsampler
    from minsdtf_tpu_torch import scheduler as tsched
    from minsdtf_tpu_torch.models import unet as unet_lib
    from minsdtf_tpu_torch.models import vae as vae_lib
    from minsdtf_tpu_torch.models.common import cast_weights_
    from minsdtf_tpu_torch.weights import quantize

    unet = unet_lib.fuse_attention_projections(
        unet_lib.init("cpu", seed=0, widths=(320, 64, 128, 128), temb_dim=128))
    if case == "two_calls_int8":
        unet = quantize.quantize_params(unet)
    unet = cast_weights_(unet, torch.bfloat16).to(device).eval()
    decoder = cast_weights_(vae_lib.init_decoder("cpu", seed=2, dec_widths=(192, 64, 32, 32)),
                            torch.bfloat16).to(device).eval()
    mode = {"tcd_inpaint": "tcd", "two_calls_int8": "ddim"}.get(case, case)
    schedule = tsched.build_denoise_schedule(tsched.make_scheduler(mode), 3, eta=0.3)
    gen = torch.Generator().manual_seed(3)
    latent0 = torch.randn(2, 32, 32, 4, generator=gen)
    ctx = torch.randn(2, 77, 768, generator=gen)
    unc = torch.randn(1, 154 if case == "two_calls_int8" else 77, 768, generator=gen)
    kw = dict(mode=schedule.mode)
    if case in ("euler_a", "tcd_inpaint"):
        kw["step_noise"] = torch.randn(3, 2, 32, 32, 4, generator=gen).to(device)
    if case == "tcd_inpaint":
        kw["inpaint"] = tsampler.Inpaint(  # the reference latent NCHW in memory, as the encoder's
            torch.randn(1, 4, 32, 32, generator=gen).to(device).permute(0, 2, 3, 1),
            torch.randn(2, 32, 32, 4, generator=gen).to(device),
            (torch.rand(1, 32, 32, 1, generator=gen) > 0.5).float().to(device),
            torch.rand(1, 256, 256, 3, generator=gen).to(device),
            (torch.rand(1, 256, 256, 1, generator=gen) > 0.5).float().to(device))
    t_embs = torch.from_numpy(tsched.timestep_embedding(schedule.timesteps)).to(device)
    args = (unet, decoder, latent0.to(device, torch.bfloat16), ctx.to(device), unc.to(device),
            t_embs, schedule.rows)
    return args, kw


def _counted(fn):
    """``(fn()'s output synchronised, each launch counter's change)``."""
    from minsdtf_tpu_torch import sampler as tsampler

    before = tsampler._counts()
    out = fn()
    torch.cuda.synchronize()
    return out, [a - b for a, b in zip(tsampler._counts(), before)]


@pytest.mark.parametrize("case", PROGRAM_CASES)
def test_program_equals_the_step_loop_bit_for_bit(cuda, case):
    """The captured program's first call (step 0 and the decode eager, then
    captured) and its second (every step replayed) give the step loop's image and
    latent bit for bit, and move every launch counter as the loop does."""
    from minsdtf_tpu_torch import sampler as tsampler

    args, kw = _program_setup(cuda, case)
    (want_img, want_lat), want_counts = _counted(
        lambda: tsampler._generate_eager(*args, 7.5, 0.7, **kw))
    assert want_counts[0] > 0 and want_counts[1] > 0
    assert (want_counts[2] > 0) == (case == "two_calls_int8")
    programs = tsampler.ProgramCache()
    for call in ("capture", "replay"):
        (img, lat), counts = _counted(
            lambda: tsampler.generate(*args, 7.5, 0.7, programs=programs, **kw))
        assert torch.equal(img, want_img), (call, int((img.int() - want_img.int()).abs().max()))
        assert torch.equal(lat, want_lat), call
        assert counts == want_counts, (call, counts, want_counts)
    stats = programs.stats()
    assert stats["builds"] == 1 and stats["programs"] == 1
    # the first call replays steps 1 and 2, the second every step and the decode
    assert stats["each"][0]["replays"] == 2 + 4 and stats["each"][0]["capture_s"] > 0
    assert stats["pool_bytes"] is None or stats["pool_bytes"] > 0


def test_a_new_guidance_value_reuses_the_program(cuda):
    from minsdtf_tpu_torch import sampler as tsampler

    args, kw = _program_setup(cuda, "ddim")
    programs = tsampler.ProgramCache()
    for scale, rescale in ((7.5, 0.7), (5.0, 0.251953125)):  # 1 - 0.251953125 is not bf16
        img, lat = tsampler.generate(*args, scale, rescale, programs=programs, **kw)
        want_img, want_lat = tsampler._generate_eager(*args, scale, rescale, **kw)
        assert torch.equal(img, want_img) and torch.equal(lat, want_lat), scale
    assert programs.builds == 1


class _SyncingUNet(torch.nn.Module):
    """A UNet that reads a value back to the host in its forward, which a capture
    cannot hold."""

    def __init__(self, unet):
        super().__init__()
        self.unet = unet

    def forward(self, latent, t_emb, context, controls=None):
        if float(latent.float().abs().sum()) < 0:
            raise AssertionError("unreachable")
        return self.unet(latent, t_emb, context, controls)


def test_a_failing_capture_raises_and_keeps_no_program(cuda):
    from minsdtf_tpu_torch import sampler as tsampler

    (unet, *rest), kw = _program_setup(cuda, "ddim")
    programs = tsampler.ProgramCache()
    with pytest.raises(RuntimeError):
        tsampler.generate(_SyncingUNet(unet), *rest, 7.5, 0.7, programs=programs, **kw)
    torch.cuda.synchronize()
    assert len(programs.programs) == 0
    # the card still runs programs afterwards
    img, lat = tsampler.generate(unet, *rest, 7.5, 0.7, programs=programs, **kw)
    want_img, want_lat = tsampler._generate_eager(unet, *rest, 7.5, 0.7, **kw)
    assert torch.equal(img, want_img) and torch.equal(lat, want_lat)


# ---- the NHWC GroupNorm kernel ------------------------------------------------------


@pytest.mark.parametrize("case", chip_smoke.GN_CASES, ids=lambda c: "x".join(map(str, c)))
def test_group_norm_kernel_matches_plain(cuda, case):
    """The kernel at every UNet and VAE GroupNorm shape at 512px and 1024px at
    batch 1, 2 and 16, and ragged shapes, in bf16 and fp32, with and without SiLU,
    against the plain composition and fp64 (:func:`chip_smoke.gn_check`)."""
    gen = torch.Generator(device=cuda).manual_seed(sum(case))
    for dtype in (torch.bfloat16, torch.float32):
        for silu in (False, True):
            result = chip_smoke.gn_check(case, dtype, silu, gen)
            assert result["ok"], result
    torch.cuda.empty_cache()


def test_group_norm_routes_and_refuses_on_the_card(cuda):
    """bf16 and fp32 channels-last tensors go to the kernel; a CUDA tensor NCHW in
    memory or off 16 bytes raises and is not copied; fp64, fp16, other group counts
    and a call autograd records take the plain composition, with its gradient."""
    from minsdtf_tpu_torch.ops import group_norm as tgn

    gen = torch.Generator(device=cuda).manual_seed(0)
    x, weight, bias = chip_smoke.gn_inputs(2, 16, 16, 320, torch.bfloat16, gen)
    kernel, plain = tbasic.group_norm.kernel_calls, tbasic.group_norm.plain_calls
    launches = tgn.group_norm_nhwc.launches
    for t in (x, x.float()):
        out = tbasic.group_norm_silu(t, weight, bias)
        assert out.stride() == tbasic.nhwc_strides(out.shape) and out.dtype == t.dtype
    assert tbasic.group_norm.kernel_calls == kernel + 2
    assert tgn.group_norm_nhwc.launches == launches + 2 * tgn.KERNELS
    with pytest.raises(ValueError, match="NHWC"):
        tbasic.group_norm(x.contiguous(), weight, bias)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)[1:]
    shifted = flat.view(2, 16, 16, 320).permute(0, 3, 1, 2)
    with pytest.raises(ValueError, match="16 bytes"):
        tbasic.group_norm(shifted, weight, bias)
    assert tbasic.group_norm.kernel_calls == kernel + 2  # refused, not launched
    assert tgn.group_norm_nhwc.launches == launches + 2 * tgn.KERNELS
    for t, groups in ((x.double(), 32), (x.half(), 32), (x, 16)):
        tbasic.group_norm(t, weight, bias, num_groups=groups)
    leaf = x.float().requires_grad_()
    out = tbasic.group_norm_silu(leaf, weight, bias)
    out.float().square().sum().backward()
    assert leaf.grad is not None and bool(torch.isfinite(leaf.grad).all())
    assert tbasic.group_norm.plain_calls == plain + 4


def test_captured_512px_step_runs_every_group_norm_on_the_kernel(cuda):
    """The full-width bf16 UNet and decoder at 512px (a 64x64 latent, the CFG pair)
    through the captured program: each GroupNorm on the kernel (61 a UNet call, 30
    in the decode), none on the plain composition, no convolution that transposes,
    and the step loop's image and latent bit for bit."""
    from minsdtf_tpu_torch import sampler as tsampler
    from minsdtf_tpu_torch import scheduler as tsched
    from minsdtf_tpu_torch.models import unet as unet_lib
    from minsdtf_tpu_torch.models import vae as vae_lib
    from minsdtf_tpu_torch.models.common import cast_weights_

    unet = cast_weights_(unet_lib.fuse_attention_projections(unet_lib.init(cuda, seed=0)),
                         torch.bfloat16).eval()
    decoder = cast_weights_(vae_lib.init_decoder(cuda, seed=2), torch.bfloat16).eval()
    schedule = tsched.build_denoise_schedule(tsched.make_scheduler("ddim"), 2)
    gen = torch.Generator().manual_seed(5)
    args = (unet, decoder, torch.randn(1, 64, 64, 4, generator=gen).to(cuda, torch.bfloat16),
            torch.randn(1, 77, 768, generator=gen).to(cuda),
            torch.randn(1, 77, 768, generator=gen).to(cuda),
            torch.from_numpy(tsched.timestep_embedding(schedule.timesteps)).to(cuda),
            schedule.rows, 7.5, 0.7)
    (want_img, want_lat), want = _counted(lambda: tsampler._generate_eager(*args))
    programs = tsampler.ProgramCache()
    for call in ("capture", "replay"):
        (img, lat), counts = _counted(lambda: tsampler.generate(*args, programs=programs))
        assert torch.equal(img, want_img) and torch.equal(lat, want_lat), call
        assert counts == want, (call, counts, want)
        # GroupNorm kernel calls, plain calls, layout misses, the kernel's launches
        assert counts[3:] == [61 * 2 + 30, 0, 0, 3 * (61 * 2 + 30)], call


def test_an_uncast_model_through_a_one_pixel_level_runs_on_the_kernel(cuda):
    """A UNet whose conv weights stay OIHW (assigned, not loaded) at an 8x8 latent:
    its last level is one pixel, dense in both layouts, and the upsample out of it
    keeps the activations NHWC in memory for the GroupNorm kernel. The output
    matches the CPU's."""
    from minsdtf_tpu_torch.models import unet as unet_lib

    unet = unet_lib.init("cpu", seed=0, widths=(32, 64, 128, 128), temb_dim=128).eval()
    gen = torch.Generator().manual_seed(4)
    args = (torch.randn(2, 8, 8, 4, generator=gen), torch.randn(2, 32, generator=gen),
            torch.randn(2, 77, 768, generator=gen))
    with torch.inference_mode():
        want = unet(*args)
        kernel = tbasic.group_norm.kernel_calls
        got = unet.to(cuda)(*(t.to(cuda) for t in args))
    torch.cuda.synchronize()
    assert tbasic.group_norm.kernel_calls - kernel == 61
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3 * float(want.abs().max()))
