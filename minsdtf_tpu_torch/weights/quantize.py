"""Post-training int8 weight quantization (W8A8) of conv and dense sites.

The port's copy of the JAX package's ``weights/quantize.py``, on ``nn.Module``
models instead of flat param dicts. A quantized site is an
:class:`minsdtf_tpu_torch.models.common.Int8Site` in place of the ``nn.Conv2d`` /
``nn.Linear`` it was made from, under the same dotted name; the model's forward
runs it through :func:`minsdtf_tpu_torch.ops.basic.int8_conv2d` /
:func:`~minsdtf_tpu_torch.ops.basic.int8_dense`.

Scheme (as in the JAX package):
  - symmetric, per output channel: ``scale_o = max(max|W[o]|, 1e-12) / 127``,
    ``Wq = clip(round(W / scale), -127, 127)`` (int8);
  - sites whose contraction depth K (the product of every weight axis but the
    output channel: I*kh*kw, or ``in``) is below ``min_k``, and the skip-listed
    ``conv_in``, ``conv_out``, time embedding and upsampler convs, stay float;
  - ``weight_dtype="int8_hybrid"`` (:func:`hybridize_params`) quantizes only the
    conv sites whose calibrated activation amax is stable across the denoising
    trajectory, with a static activation scale, SmoothQuant per-input-channel
    equalization and bias correction (:func:`_equalized_module`).

Layouts are the port's: conv weights OIHW, dense ``(out, in)``, so the output
channel is axis 0 and the input channel axis 1. Every function quantizes on the
weight's device and gives the JAX package's int8 values and fp32 scales bit for
bit: each step is one correctly rounded operation in the same precision, and
every division is by a tensor (on CUDA, dividing by a Python number multiplies by
its reciprocal, which can differ in the last bit).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from minsdtf_tpu_torch.models.common import Int8Site

# Never quantized: the 4->320 entry conv (K=36), the 320->4 exit conv (the
# latent epsilon itself), the time embedding MLP, and the upsampler convs (the
# JAX package's fused subpixel upsample sums their taps and needs the float
# kernel; the two packages quantize the same sites).
DEFAULT_SKIP_SUFFIXES = (
    "conv_in",
    "conv_out",
    "time_embedding.linear_1",
    "time_embedding.linear_2",
    "upsamplers.0.conv",
)
# Below this contraction depth the products are too small to gain from int8.
DEFAULT_MIN_K = 256


def _div(a: torch.Tensor, value: float) -> torch.Tensor:
    """``a / value``, correctly rounded on every device."""
    return a / torch.tensor(value, dtype=a.dtype, device=a.device)


def _per_out(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-output-channel vector shaped to broadcast over a weight of ``ndim``."""
    return t.view(-1, *([1] * (ndim - 1)))


def _per_in(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-input-channel vector shaped to broadcast over a weight of ``ndim``."""
    return t.view(1, -1, *([1] * (ndim - 2)))


def quantize_kernel(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, fp32 per-output-channel scales) of a conv (OIHW) or dense
    ``(out, in)`` weight, on its device. The values are dense in that order also
    where the weight is channels-last (a cast model's)."""
    w = weight.detach().float()
    amax = w.abs().amax(dim=tuple(range(1, w.dim())))
    scale = _div(amax.clamp(min=1e-12), 127.0)
    q = torch.round(w / _per_out(scale, w.dim())).clamp(-127, 127).to(torch.int8)
    return q.contiguous(), scale


def _bias(m: nn.Module) -> Optional[torch.Tensor]:
    return None if m.bias is None else m.bias.detach()


def _quantize_module(name: str, m: nn.Module) -> Int8Site:
    """An :class:`Int8Site` from the conv or dense ``m``: its weight quantized, its
    bias kept."""
    q, scale = quantize_kernel(m.weight)
    return Int8Site(name, q, scale, bias=_bias(m))


def should_quantize(name: str, m: nn.Module, skip_suffixes: Iterable[str], min_k: int) -> bool:
    if not isinstance(m, (nn.Conv2d, nn.Linear)):
        return False
    if any(name.endswith(suf) for suf in skip_suffixes):
        return False
    return m.weight[0].numel() >= min_k


def quantize_params(
    model: nn.Module,
    skip_suffixes: Iterable[str] = DEFAULT_SKIP_SUFFIXES,
    min_k: int = DEFAULT_MIN_K,
    conv_only: bool = False,
) -> nn.Module:
    """Quantize every eligible conv / dense site of ``model``, in place; returns
    ``model``. ``conv_only`` leaves the dense sites float (the calibration pass of
    the "int8_hybrid" mode only needs conv-site statistics)."""
    for name, m in list(model.named_modules()):
        if conv_only and isinstance(m, nn.Linear):
            continue
        if should_quantize(name, m, skip_suffixes, min_k):
            model.set_submodule(name, _quantize_module(name, m))
    return model


def int8_sites(model: nn.Module) -> Dict[str, Int8Site]:
    """``{name: site}`` of every :class:`Int8Site` in ``model``, in module order."""
    return {name: m for name, m in model.named_modules() if isinstance(m, Int8Site)}


def dequantize_kernel(site: Int8Site) -> torch.Tensor:
    """The effective fp32 weight of ``site`` (tests and debugging): the
    per-output-channel scales undone and, at equalized sites, the per-input-channel
    factors, ``1 / (act_qmul * act_scale)``."""
    nd = site.weight_q.dim()
    w = site.weight_q.float() * _per_out(site.weight_scale.float(), nd)
    if site.act_qmul is not None:
        d = 1.0 / (site.act_qmul.float() * float(site.act_scale))
        w = w / _per_in(d, nd)
    return w


def _equalized_module(
    name: str,
    m: nn.Conv2d,
    stats: dict,
    margin: float,
    alpha: float,
    clip_sigmas: Optional[float],
    bias_correct: bool,
) -> tuple:
    """SmoothQuant-style per-input-channel equalized W8A8 conv site.

    With per-channel factors ``d_j`` the conv output ``sum_j x_j W_j`` equals
    ``sum_j (x_j / d_j)(d_j W_j)``; only the quantization grids move.
    ``d_j = a_j^alpha / w_j^(1-alpha)`` (activation per-channel amax against the
    weight's per-input-channel amax, arXiv:2211.10438). The activation quantize
    multiplies by the vector ``act_qmul = 1 / (d * act_scale)``; the epilogue is
    still ``act_scale * weight_scale``. ``clip_sigmas`` clips the grid to that many
    rms of the equalized activation; ``bias_correct`` folds the systematic weight
    rounding error ``sum_hwj E[x_j] (W_dequant - W)`` out of the bias.

    Returns ``(site, estimate)``: the estimate is the analytic per-site relative
    output MSE (uniform rounding noise over the calibration moments) that the
    ``max_site_rel_mse`` gate reads. The factors come from the host's float64 numpy
    as in the JAX package; the weight's products run in float64 on its device."""
    w = m.weight.detach().double()  # (O, I, kh, kw)
    dev = w.device
    a = np.asarray(stats["ch_amax"], np.float64)
    mean = np.asarray(stats["ch_mean"], np.float64)
    msq = np.asarray(stats["ch_msq"], np.float64)
    out_msq = float(stats.get("out_msq", 0.0))

    w_in_amax = w.abs().amax(dim=(0, 2, 3)).cpu().numpy()  # per input channel
    d = np.power(np.maximum(a, 1e-12), alpha) / np.power(
        np.maximum(w_in_amax, 1e-12), 1.0 - alpha)
    d = np.where(a <= 1e-12, 1.0, d)
    d /= np.exp(np.mean(np.log(np.maximum(d, 1e-12))))  # geo-mean 1 (cosmetic)

    a_eq = a / d
    amax_eq = float(np.max(a_eq))
    asc = amax_eq * margin / 127.0
    if clip_sigmas is not None:
        rms_eq = float(np.sqrt(np.mean(msq / (d * d))))
        asc = min(asc, clip_sigmas * rms_eq / 127.0)
    asc = max(asc, 1e-12)

    dt = _per_in(torch.from_numpy(d).to(dev), 4)
    w_eq = w * dt
    wsc = _div(w_eq.abs().amax(dim=(1, 2, 3)), 127.0).clamp(min=1e-12)  # per out channel
    kq = torch.round(w_eq / _per_out(wsc, 4)).clamp(-127, 127).to(torch.int8)
    w_eff = (kq.double() * _per_out(wsc, 4)) / dt

    bias = _bias(m)
    dw = w_eff - w
    if bias_correct and bias is not None:
        delta = torch.einsum("j,ojhw->o", torch.from_numpy(mean).to(dev), dw)
        bias = (bias.double() - delta).float()
    site = Int8Site(
        name, kq, wsc.float(), bias=bias,
        act_scale=torch.tensor(np.float32(asc), device=dev),
        act_qmul=torch.from_numpy((1.0 / (d * asc)).astype(np.float32)).to(dev))

    # activation rounding noise (uniform, variance step^2/12 with the per-channel
    # step d_j*asc) through the dequantized weights, plus the weight rounding
    # error driven by the activation second moment
    var_act = torch.from_numpy((d * asc) ** 2 / 12.0).to(dev)
    o = w.shape[0]
    act_mse = float(torch.einsum("j,ojhw->", var_act, w_eff ** 2)) / o
    w_mse = float(torch.einsum("j,ojhw->", torch.from_numpy(msq).to(dev), dw ** 2)) / o
    denom = max(out_msq, 1e-12) if out_msq > 0 else np.inf
    return site, {"rel_mse": (act_mse + w_mse) / denom,
                  "act_rel": act_mse / denom, "w_rel": w_mse / denom}


def _amax_ratio(stats) -> Tuple[float, float]:
    """(amax, ratio) of a site's calibration entry: a dict, or a plain amax."""
    if isinstance(stats, dict):
        return stats["amax"], stats.get("ratio", 1.0)
    return float(stats), 1.0


def hybridize_params(
    model: nn.Module,
    scales: dict,
    margin: float = 1.05,
    stability_threshold: float = 1.5,
    skip_suffixes: Iterable[str] = DEFAULT_SKIP_SUFFIXES,
    min_k: int = DEFAULT_MIN_K,
    dense_dynamic: bool = False,
    equalize_alpha: Optional[float] = 0.5,
    clip_sigmas: Optional[float] = None,
    bias_correct: bool = True,
    max_site_rel_mse: Optional[float] = None,
    report: Optional[dict] = None,
) -> nn.Module:
    """Stable-site-only W8A8 ("int8_hybrid"), in place; returns ``model``. Only the
    eligible conv sites whose calibrated activation amax is stable across the
    trajectory (``ratio <= stability_threshold``) become int8, with a static
    activation scale; every other site stays float.

    ``scales`` is the ``{site: {"amax", "ratio", ...}}`` dict of
    :func:`minsdtf_tpu_torch.weights.calibrate.collect_unet_amax` (or
    ``load_scales``). Sites with per-channel statistics are equalized
    (:func:`_equalized_module`, strength ``equalize_alpha``; None disables) and
    dropped when their estimate exceeds ``max_site_rel_mse``; ``report``, if
    given, gets ``{site: {"rel_mse", "act_rel", "w_rel", "quantized"}}`` for each.
    Sites with a scalar amax get the plain per-tensor grid.
    ``dense_dynamic=True`` also quantizes the eligible dense sites, with dynamic
    per-token scales."""
    for name, m in list(model.named_modules()):
        if dense_dynamic and isinstance(m, nn.Linear) and should_quantize(
                name, m, skip_suffixes, min_k):
            model.set_submodule(name, _quantize_module(name, m))
            continue
        stats = scales.get(name)
        if (stats is None or not isinstance(m, nn.Conv2d)
                or not should_quantize(name, m, skip_suffixes, min_k)):
            continue
        amax, ratio = _amax_ratio(stats)
        if ratio > stability_threshold:
            continue
        if equalize_alpha is not None and isinstance(stats, dict) and "ch_amax" in stats:
            site, est = _equalized_module(
                name, m, stats, margin=margin, alpha=equalize_alpha,
                clip_sigmas=clip_sigmas, bias_correct=bias_correct)
            keep = max_site_rel_mse is None or est["rel_mse"] <= max_site_rel_mse
            if report is not None:
                report[name] = dict(est, quantized=keep)
            if keep:
                model.set_submodule(name, site)
            continue
        site = _quantize_module(name, m)
        site.act_scale = torch.tensor(np.float32(max(amax, 1e-12) * margin / 127.0),
                                      device=site.weight_q.device)
        model.set_submodule(name, site)
    return model
