"""Primitive NN ops: conv / dense / norms / activations, plain functions on tensors.

Shapes are PyTorch's: images (B, C, H, W), conv weights (O, I, kh, kw), dense
weights ``(out, in)``. In memory the models keep images and conv weights
channels-last (NHWC and OHWI, ``torch.channels_last``), the layout cuDNN's Hopper
convolutions take, so no convolution transposes its input or its weight;
:func:`conv2d` counts the calls that would (``conv2d.layout_misses``). Matmuls and
convs run in the dtype of the activations (bf16 in production, fp32 in parity
tests) with fp32 accumulation; the weight and bias are cast to that dtype.
Normalization statistics are fp32 or wider. :func:`group_norm` and
:func:`group_norm_silu` run the hand-written NHWC kernel
(:mod:`minsdtf_tpu_torch.ops.group_norm`) on the calls it takes and the plain
composition on the rest, and count each (``group_norm.kernel_calls``,
``group_norm.plain_calls``).

:func:`int8_conv2d` and :func:`int8_dense` run a W8A8 site
(:class:`minsdtf_tpu_torch.models.common.Int8Site`, made by
:mod:`minsdtf_tpu_torch.weights.quantize`) as the JAX package's ``conv2d`` and
``dense`` run a ``kernel_q`` module: the activation quantized to int8 per image
(conv) or per token (dense), dynamically or with a calibrated ``act_scale``, an
int8 x int8 -> int32 product (:func:`int8_matmul`, ``torch._int_mm``; the conv as
im2col), then ``acc * (act_scale * weight_scale)`` in fp32, the downcast, and the
bias in the activations' dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from minsdtf_tpu_torch.ops import group_norm as gn_kernel

Padding = Union[int, Tuple[Tuple[int, int], Tuple[int, int]]]


def stats_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of statistics and sums for activations of ``dtype``: fp32, or
    fp64 for fp64 (the reference runs that bound fp32's rounding)."""
    return torch.promote_types(dtype, torch.float32)


def _cast(t: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


def _pads(padding: Padding) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    if isinstance(padding, int):
        return (padding, padding), (padding, padding)
    return tuple((int(a), int(b)) for a, b in padding)


def nhwc_strides(shape) -> Tuple[int, int, int, int]:
    """The strides of a 4-D tensor of ``shape`` laid out channels-last, written
    out as ``torch.empty(..., memory_format=torch.channels_last)`` gives them."""
    _, c, h, w = shape
    return (h * w * c, 1, w * c, c)


def nhwc_view(t: torch.Tensor) -> torch.Tensor:
    """The 4-D ``t`` with :func:`nhwc_strides` written out where its memory is
    dense NHWC already (a view of the same memory), else ``t``. A 1x1 conv weight
    or an image of one pixel is dense in both layouts, and PyTorch picks the layout
    of a convolution or an upsample from the strides, so they are set, not left to
    chance."""
    if t.stride() != nhwc_strides(t.shape) and t.is_contiguous(memory_format=torch.channels_last):
        return t.as_strided(t.shape, nhwc_strides(t.shape))
    return t


def channels_last(t: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``t`` (4-D) in ``dtype`` laid out channels-last, with :func:`nhwc_strides`:
    a copy unless its memory is so already."""
    return nhwc_view(t.to(dtype or t.dtype, memory_format=torch.channels_last))


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
           stride: int = 1, padding: Padding = 0) -> torch.Tensor:
    """2-D convolution, (B, C, H, W) x (O, I, kh, kw). ``padding`` is an int
    (symmetric) or explicit ``((top, bottom), (left, right))``, as the VAE
    encoder's stride-2 ``((0, 1), (0, 1))`` needs. A call whose input is not dense
    NHWC in memory, or whose weight does not have :func:`nhwc_strides`, counts in
    ``conv2d.layout_misses``: the convolution then transposes one of them."""
    if not isinstance(padding, int):
        (top, bottom), (left, right) = padding
        x = F.pad(x, (left, right, top, bottom))
        padding = 0
    if not (x.is_contiguous(memory_format=torch.channels_last)
            and weight.stride() == nhwc_strides(weight.shape)):
        conv2d.layout_misses += 1
    return F.conv2d(x, weight.to(x.dtype), _cast(bias, x.dtype), stride=stride, padding=padding)


conv2d.layout_misses = 0


def dense(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Affine map over the last axis; ``weight`` is ``(out, in)``."""
    return F.linear(x, weight.to(x.dtype), _cast(bias, x.dtype))


def group_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over the channel axis, fp32 statistics and affine (fp64 in fp64),
    by PyTorch's GroupNorm between two casts."""
    wide = stats_dtype(x.dtype)
    out = F.group_norm(x.to(wide), num_groups, weight.to(wide), bias.to(wide), eps)
    return out.to(x.dtype)


def _group_norm(x, weight, bias, num_groups: int, eps: float, act: bool) -> torch.Tensor:
    if gn_kernel.takes(x, weight, bias, num_groups):
        out = gn_kernel.group_norm_nhwc(x, weight, bias, eps, silu=act)
        group_norm.kernel_calls += 1
        return out
    group_norm.plain_calls += 1
    out = group_norm_plain(x, weight, bias, num_groups, eps)
    return silu(out) if act else out


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over the channel axis: the NHWC kernel (fp64 statistics, fp32
    affine) where :func:`ops.group_norm.takes` says so, else
    :func:`group_norm_plain`."""
    return _group_norm(x, weight, bias, num_groups, eps, act=False)


def group_norm_silu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm + SiLU, the prologue of every ResBlock conv: fused in the kernel,
    SiLU after :func:`group_norm_plain` on the plain path."""
    return _group_norm(x, weight, bias, num_groups, eps, act=True)


group_norm.kernel_calls = 0
group_norm.plain_calls = 0


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, fp32 statistics and affine."""
    wide = stats_dtype(x.dtype)
    out = F.layer_norm(x.to(wide), (x.shape[-1],), weight.to(wide), bias.to(wide), eps)
    return out.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's quick_gelu: ``x * sigmoid(1.702 x)``."""
    return x * torch.sigmoid(1.702 * x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximated GELU with the reference GEGLU's constant:
    ``0.5 x (1 + tanh(0.7978845608 x (1 + 0.044715 x²)))``."""
    return 0.5 * x * (1.0 + torch.tanh(x * 0.7978845608 * (1.0 + 0.044715 * torch.square(x))))


def geglu(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """GEGLU feed-forward gate: project to 2*dim_out, ``value * gelu_tanh(gate)``."""
    return gelu_gate(dense(x, weight, bias))


def gelu_gate(h: torch.Tensor) -> torch.Tensor:
    """GEGLU's gate on the projection ``h`` to 2*dim_out: ``value * gelu_tanh(gate)``."""
    value, gate = h.chunk(2, dim=-1)
    return value * gelu_tanh(gate)


def upsample2x_conv3x3(x: torch.Tensor, weight: torch.Tensor,
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``conv2d(nearest_2x(x), padding=1)``: the UNet and VAE upsamplers. With a
    channels-last weight (a model after :func:`models.common.cast_weights_`), and on
    the card, whose GroupNorm kernel takes NHWC memory only, ``x``'s strides are
    written out first (:func:`nhwc_view`): the upsample picks its output's layout
    from them, and a one-pixel level is dense in both layouts. A model with OIHW
    weights on the CPU keeps PyTorch's choice there, whose convolutions round as the
    golden latents were recorded (``test_torch_samplers.py``'s DPM golden differs
    in the last bits otherwise)."""
    if x.device.type == "cuda" or weight.stride() == nhwc_strides(weight.shape):
        x = nhwc_view(x)
    return conv2d(F.interpolate(x, scale_factor=2, mode="nearest"), weight, bias, padding=1)


# ---- W8A8 int8 sites ------------------------------------------------------------

# Calibration tape (weights/calibrate.py): while it is a list, every int8 site
# appends a dict of its name and its input's statistics (``amax``, and per input
# channel ``ch_amax``, ``ch_mean``, ``ch_msq``), then ``out_msq`` of its rescaled
# output before the bias, as fp32 tensors on the site's device, in call order.
_CALIB_TAPE: Optional[list] = None
# torch._int_mm on CUDA takes more than 16 rows; fewer are padded with zero rows
INT8_MIN_ROWS = 17


def set_calibration_tape(tape: Optional[list]) -> None:
    global _CALIB_TAPE
    _CALIB_TAPE = tape


def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a`` (M, K) int8 times ``w`` (N, K) int8 transposed -> (M, N) int32, exact,
    by ``torch._int_mm`` (its second operand is ``w.t()``, column-major). Fewer
    than ``INT8_MIN_ROWS`` rows are padded with zero rows, which add nothing, and
    sliced off. Counts its products in ``.calls``."""
    m = a.shape[0]
    if m < INT8_MIN_ROWS:
        a = F.pad(a, (0, 0, 0, INT8_MIN_ROWS - m))
    out = torch._int_mm(a, w.t())
    int8_matmul.calls += 1
    return out[:m]


int8_matmul.calls = 0


def _quantize_acts(x: torch.Tensor, site, dims, channel_dim: int):
    """Symmetric int8 activations of ``x`` for ``site``, in the JAX package's
    order of operations (its ``_quantize_acts``), and the fp32 activation scale.

    - ``act_qmul`` (per input channel, equalized sites): ``round(x * act_qmul)``
      clipped to +-127, with the scalar ``act_scale``;
    - ``act_scale`` (calibrated): ``round(x * (1 / act_scale))`` clipped;
    - neither (dynamic): ``asc = max(amax, 1e-12) * (1/127)`` with the amax over
      ``dims``, then ``round(x / asc)``, no clip.

    ``channel_dim`` is the input-channel axis: 1 for NCHW, -1 for dense."""
    xf = x.float()
    if _CALIB_TAPE is not None:
        ch_dims = tuple(d for d in range(xf.dim()) if d != channel_dim % xf.dim())
        absx = xf.abs()
        _CALIB_TAPE.append({"name": site.name, "amax": absx.amax(),
                            "ch_amax": absx.amax(dim=ch_dims),
                            "ch_mean": xf.mean(dim=ch_dims),
                            "ch_msq": xf.square().mean(dim=ch_dims)})
    if site.act_qmul is not None:
        qmul = site.act_qmul.float()
        if channel_dim == 1:
            qmul = qmul.view(-1, *([1] * (xf.dim() - 2)))
        xq = torch.round(xf * qmul).clamp(-127, 127)
        return xq.to(torch.int8), site.act_scale.float()
    if site.act_scale is not None:
        asc = site.act_scale.float()
        return torch.round(xf * (1.0 / asc)).clamp(-127, 127).to(torch.int8), asc
    amax = xf.abs().amax(dim=dims, keepdim=True)
    asc = amax.clamp(min=1e-12) * (1.0 / 127.0)
    return torch.round(xf / asc).to(torch.int8), asc


def _rescale(acc: torch.Tensor, asc: torch.Tensor, site, dtype) -> torch.Tensor:
    """``(acc * (asc * weight_scale)).to(dtype)`` with the output channel last,
    recording ``out_msq`` on the tape."""
    out = (acc.float() * (asc * site.weight_scale)).to(dtype)
    if _CALIB_TAPE is not None:
        _CALIB_TAPE[-1]["out_msq"] = out.float().square().mean()
    return out


def int8_conv_acc(xq: torch.Tensor, weight_q: torch.Tensor, stride: int = 1,
                  padding: Padding = 0) -> torch.Tensor:
    """The int32 convolution of the int8 NCHW ``xq`` with the int8 OIHW
    ``weight_q``, as (B, Ho, Wo, O): ``xq`` zero-padded and unfolded into
    (B*Ho*Wo, C*kh*kw) columns in the weight's (I, kh, kw) order, then one
    :func:`int8_matmul`."""
    (top, bottom), (left, right) = _pads(padding)
    if top or bottom or left or right:
        xq = F.pad(xq, (left, right, top, bottom))
    o, c, kh, kw = weight_q.shape
    patches = xq.unfold(2, kh, stride).unfold(3, kw, stride)  # (B, C, Ho, Wo, kh, kw)
    b, _, ho, wo = patches.shape[:4]
    cols = patches.permute(0, 2, 3, 1, 4, 5).reshape(b * ho * wo, c * kh * kw)
    return int8_matmul(cols, weight_q.reshape(o, c * kh * kw)).view(b, ho, wo, o)


def int8_conv2d(x: torch.Tensor, site, stride: int = 1, padding: Padding = 0) -> torch.Tensor:
    """W8A8 convolution, NCHW x ``site.weight_q`` (OIHW int8): per-image activation
    scales over (C, H, W), the int32 product (:func:`int8_conv_acc`), the rescale
    in NHWC and the bias. The output is NCHW in channels-last memory."""
    xq, asc = _quantize_acts(x, site, dims=(1, 2, 3), channel_dim=1)
    acc = int8_conv_acc(xq, site.weight_q, stride, padding)
    out = _rescale(acc, asc, site, x.dtype).permute(0, 3, 1, 2)
    if site.bias is not None:
        out = out + site.bias.to(x.dtype).view(-1, 1, 1)
    return out


def int8_dense(x: torch.Tensor, site) -> torch.Tensor:
    """W8A8 affine map over the last axis, ``site.weight_q`` (out, in) int8:
    per-token activation scales, one :func:`int8_matmul`, the rescale, the bias."""
    xq, asc = _quantize_acts(x, site, dims=-1, channel_dim=-1)
    acc = int8_matmul(xq.reshape(-1, x.shape[-1]), site.weight_q)
    out = _rescale(acc.view(*x.shape[:-1], -1), asc, site, x.dtype)
    if site.bias is not None:
        out = out + site.bias.to(x.dtype)
    return out
