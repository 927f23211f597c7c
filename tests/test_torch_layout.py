"""The models' channels-last layout on the CPU, at small widths: each model with
its conv weights stored channels-last (``models.common.cast_weights_``) and
channels-last inputs equals the same model run NCHW in memory (OIHW weights, NCHW
inputs: the parent layout), and no convolution of the channels-last forward
transposes (``ops.basic.conv2d.layout_misses`` stays 0); the cast keeps each
weight's values; ambiguous strides are written out; and the GroupNorm on the CPU,
in fp64 and under autograd is the plain composition. The NHWC GroupNorm kernel
itself runs on the card (``tests/test_torch_cuda.py``)."""

import copy

import pytest
import torch

from minsdtf_tpu_torch.models import common
from minsdtf_tpu_torch.models import controlnet as tcontrolnet
from minsdtf_tpu_torch.models import unet as tunet
from minsdtf_tpu_torch.models import vae as tvae
from minsdtf_tpu_torch.ops import basic

SMALL = dict(widths=(32, 64, 128, 128), temb_dim=128)
VAE_ENC = (32, 32, 64, 64)
VAE_DEC = (64, 64, 32, 32)
# fp32: the two layouts run the same convolutions with sums in other orders
LAYOUT_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _nchw(t: torch.Tensor) -> torch.Tensor:
    """An NHWC-shaped input whose ``permute(0, 3, 1, 2)`` is NCHW in memory."""
    return t.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)


def _inputs(seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    # an 8x8 latent: the UNet's last level is one pixel, where both layouts are dense
    return dict(latent=torch.randn(2, 8, 8, 4, generator=gen),
                t_emb=torch.randn(2, 32, generator=gen),
                context=torch.randn(2, 77, 768, generator=gen),
                image=torch.rand(2, 64, 64, 3, generator=gen) * 2 - 1)


def _models():
    return dict(unet=tunet.init("cpu", seed=0, **SMALL),
                controlnet=tcontrolnet.init("cpu", seed=3, **SMALL),
                encoder=tvae.init_encoder("cpu", seed=4, enc_widths=VAE_ENC),
                decoder=tvae.init_decoder("cpu", seed=2, dec_widths=VAE_DEC))


def _forward(name: str, models: dict, inp: dict, layout) -> torch.Tensor:
    """``name``'s output, its inputs passed through ``layout``."""
    lat, t, ctx = layout(inp["latent"]), inp["t_emb"], inp["context"]
    cn = models["controlnet"]
    if name == "hintnet":
        return cn.controlnet_cond_embedding(layout(inp["image"]))
    if name == "vae_encoder":
        return models["encoder"](layout(inp["image"]))
    if name == "vae_decoder":
        return models["decoder"](lat)
    if name == "unet":
        return models["unet"](lat, t, ctx)
    hint = cn.controlnet_cond_embedding(layout(inp["image"]))
    controls = cn(lat, t, ctx, hint)
    if name == "controlnet":
        return torch.cat([c.flatten() for c in controls])
    return models["unet"](lat, t, ctx, controls)


@pytest.mark.parametrize("name", ["unet", "unet_controls", "controlnet", "hintnet",
                                  "vae_encoder", "vae_decoder"])
def test_channels_last_forward_equals_nchw(name):
    nchw = _models()
    channels_last = {k: common.cast_weights_(copy.deepcopy(m), torch.float32)
                     for k, m in nchw.items()}
    inp = _inputs()
    runs = {}
    for label, models, layout in (("nchw", nchw, _nchw), ("channels_last", channels_last,
                                                           lambda t: t)):
        basic.conv2d.layout_misses = 0
        plain = basic.group_norm.plain_calls
        with torch.inference_mode():
            out = _forward(name, models, inp, layout)
        runs[label] = out, basic.conv2d.layout_misses, basic.group_norm.plain_calls - plain
    (want, nchw_misses, nchw_norms), (got, misses, norms) = runs["nchw"], runs["channels_last"]
    assert misses == 0
    assert nchw_misses > 0  # the reference did run NCHW
    assert norms == nchw_norms  # every GroupNorm on the CPU is the plain composition
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=LAYOUT_TOL,
                               atol=LAYOUT_TOL * float(want.abs().max()))
    if name in ("unet", "unet_controls", "vae_encoder", "vae_decoder"):
        assert got.is_contiguous()  # the NHWC output is a dense view


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cast_weights_stores_conv_weights_channels_last(dtype):
    model = tcontrolnet.init("cpu", seed=3, **SMALL)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    common.cast_weights_(model, dtype)
    convs = 0
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            convs += 1
            w = m.weight
            assert w.stride() == basic.nhwc_strides(w.shape), name
            assert w.untyped_storage().nbytes() == w.numel() * w.element_size(), name
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            assert m.weight.dtype == dtype
            assert torch.equal(m.weight, before[f"{name}.weight"].to(dtype)), name
            if m.bias is not None:  # biases stay fp32
                assert m.bias.dtype == torch.float32
                assert torch.equal(m.bias, before[f"{name}.bias"])
        if isinstance(m, torch.nn.GroupNorm):
            assert m.weight.dtype == torch.float32
    assert convs > 20  # 1x1 zero convs and 3x3 convs, down path and HintNet


def test_nhwc_view_writes_out_ambiguous_strides():
    one_pixel = torch.randn(2, 64, 1, 1)  # contiguous: dense in both layouts
    assert one_pixel.stride() == (64, 1, 1, 1)
    view = basic.nhwc_view(one_pixel)
    assert view.stride() == (64, 1, 64, 64) and view.data_ptr() == one_pixel.data_ptr()
    assert torch.equal(view, one_pixel)
    weight = torch.randn(32, 64, 1, 1)
    made = basic.channels_last(weight, torch.bfloat16)
    assert made.stride() == basic.nhwc_strides(made.shape) and torch.equal(
        made, weight.to(torch.bfloat16))
    nchw = torch.randn(2, 64, 3, 3)  # not dense NHWC: left as it is
    assert basic.nhwc_view(nchw) is nchw
    # an upsample of a one-pixel activation stays channels-last
    weight3 = basic.channels_last(torch.randn(64, 64, 3, 3))
    basic.conv2d.layout_misses = 0
    basic.upsample2x_conv3x3(one_pixel, weight3)
    assert basic.conv2d.layout_misses == 0


def test_conv2d_counts_layout_misses():
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(1, 8, 8, 16, generator=gen).permute(0, 3, 1, 2)
    w = torch.randn(16, 16, 3, 3, generator=gen)
    cases = [(x, basic.channels_last(w), 0), (x.contiguous(), basic.channels_last(w), 1),
             (x, w, 1), (basic.nhwc_view(torch.randn(1, 16, 1, 1)), basic.channels_last(w), 0)]
    for xin, win, misses in cases:
        basic.conv2d.layout_misses = 0
        out = basic.conv2d(xin, win, padding=1)
        assert basic.conv2d.layout_misses == misses
        torch.testing.assert_close(out, torch.nn.functional.conv2d(xin.contiguous(), w.contiguous(),
                                                                   padding=1))


@pytest.mark.parametrize("dtype,silu,grad", [(torch.float32, False, False),
                                             (torch.float32, True, True),
                                             (torch.float64, True, False),
                                             (torch.bfloat16, True, False)])
def test_group_norm_on_the_cpu_is_the_plain_composition(dtype, silu, grad):
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(2, 6, 5, 64, generator=gen).to(dtype).permute(0, 3, 1, 2).requires_grad_(grad)
    weight = torch.randn(64, generator=gen, requires_grad=grad)
    bias = torch.randn(64, generator=gen, requires_grad=grad)
    kernel, plain = basic.group_norm.kernel_calls, basic.group_norm.plain_calls
    out = (basic.group_norm_silu if silu else basic.group_norm)(x, weight, bias)
    want = basic.group_norm_plain(x, weight, bias)
    want = basic.silu(want) if silu else want
    assert torch.equal(out, want)
    assert (basic.group_norm.kernel_calls, basic.group_norm.plain_calls) == (kernel, plain + 1)
    assert out.dtype == dtype and out.is_contiguous(memory_format=torch.channels_last)
    if grad:
        out.sum().backward()
        assert x.grad is not None and weight.grad is not None and bias.grad is not None
