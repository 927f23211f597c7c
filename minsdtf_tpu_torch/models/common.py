"""Parameter holders and random init shared by the models.

The models keep their parameters in ``nn.Conv2d`` / ``nn.Linear`` / ``nn.GroupNorm``
/ ``nn.LayerNorm`` / ``nn.Embedding`` so that ``state_dict`` keys are the
diffusers-style dotted names (``down_blocks.0.resnets.0.conv1.weight``); the
forwards call :mod:`minsdtf_tpu_torch.ops.basic` on those parameters. A conv or
dense site that :mod:`minsdtf_tpu_torch.weights.quantize` made W8A8 is an
:class:`Int8Site` in its place, and :func:`apply_conv` / :func:`apply_dense` run it
through the int8 ops. Under spatial sequence parallelism a model passes each
block whether its activations are H-sharded (:mod:`minsdtf_tpu_torch.parallel.spatial`),
and :func:`conv3`, :func:`norm_act`, :func:`downsample` and :func:`upsample` pick
the sharded operation or the whole one.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from minsdtf_tpu_torch.ops.basic import (
    Padding, channels_last, conv2d, dense, group_norm, group_norm_silu, int8_conv2d, int8_dense,
    upsample2x_conv3x3,
)
from minsdtf_tpu_torch.parallel import spatial
from minsdtf_tpu_torch.parallel.sharding import ParallelLinear

_WEIGHT_MODULES = (nn.Conv2d, nn.Linear, nn.Embedding)
_NORM_MODULES = (nn.GroupNorm, nn.LayerNorm)


def build(factory: Callable[[], nn.Module], device, seed: int, scale: float = 0.02) -> nn.Module:
    """``factory()`` built without allocating, then materialized on ``device`` and
    filled from a ``torch.Generator`` seeded with ``seed``: conv / dense kernels and
    embeddings N(0, scale), biases 0, norm scales N(1, 0.3) and biases N(0.1, 0.3).
    The norms are perturbed because with scale 1 and bias 0 the CLIP output has a
    per-token mean of ~1e-10, and the LPW mean-preserving rescale would divide two
    near-zeros."""
    with torch.device("meta"):
        module = factory()
    module = module.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, _WEIGHT_MODULES):
                m.weight.normal_(0.0, scale, generator=gen)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, _NORM_MODULES):
                m.weight.normal_(1.0, 0.3, generator=gen)
                m.bias.normal_(0.1, 0.3, generator=gen)
    return module


def cast_weights_(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Conv / dense kernels and embeddings to ``dtype`` (the compute dtype), in
    place; conv kernels also channels-last (:func:`ops.basic.channels_last`), once,
    with no OIHW copy kept, so that no convolution transposes its weight. Biases,
    norm parameters and :class:`Int8Site` buffers stay as they are. LoRA deltas
    and int8 sites are made from the fp32 weights before this."""
    for m in module.modules():
        if isinstance(m, _WEIGHT_MODULES):
            w = m.weight.data
            m.weight.data = channels_last(w, dtype) if w.dim() == 4 else w.to(dtype)
    return module


def param_shapes(factory: Callable[[], nn.Module]) -> Dict[str, Tuple[int, ...]]:
    """``{state_dict key: shape}`` of ``factory()``, built without allocating."""
    with torch.device("meta"):
        module = factory()
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def norm(c: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, c)


class Int8Site(nn.Module):
    """A W8A8 conv or dense site, in the place of the ``nn.Conv2d`` / ``nn.Linear``
    it was made from: ``weight_q`` int8 (OIHW or ``(out, in)``), ``weight_scale``
    fp32 per output channel, optionally a calibrated fp32 ``act_scale`` (a scalar)
    and, at equalized sites, ``act_qmul`` (fp32 per input channel), and the fp32
    ``bias``. ``name`` is the site's dotted name in its model, under which
    calibration records it. The JAX package's module dict holds the same as
    ``kernel_q``, ``kernel_scale``, ``act_scale``, ``act_qmul`` and ``bias``."""

    def __init__(self, name: str, weight_q: torch.Tensor, weight_scale: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, act_scale: Optional[torch.Tensor] = None,
                 act_qmul: Optional[torch.Tensor] = None):
        super().__init__()
        self.name = name
        self.register_buffer("weight_q", weight_q)
        self.register_buffer("weight_scale", weight_scale)
        self.register_buffer("bias", bias)
        self.register_buffer("act_scale", act_scale)
        self.register_buffer("act_qmul", act_qmul)

    @property
    def is_conv(self) -> bool:
        return self.weight_q.dim() == 4


def apply_conv(m: nn.Module, x: torch.Tensor, **kw) -> torch.Tensor:
    """:func:`ops.basic.conv2d` with ``m``'s weight and bias, or
    :func:`ops.basic.int8_conv2d` where ``m`` is an :class:`Int8Site`."""
    if isinstance(m, Int8Site):
        return int8_conv2d(x, m, **kw)
    return conv2d(x, m.weight, m.bias, **kw)


def apply_dense(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """:func:`ops.basic.dense` with ``m``'s weight and bias,
    :func:`ops.basic.int8_dense` where ``m`` is an :class:`Int8Site`, or ``m``'s
    own forward where it is a TP shard
    (:class:`minsdtf_tpu_torch.parallel.sharding.ParallelLinear`)."""
    if isinstance(m, Int8Site):
        return int8_dense(x, m)
    if isinstance(m, ParallelLinear):
        return m(x)
    return dense(x, m.weight, m.bias)


def conv3(m: nn.Module, x: torch.Tensor, sharded: bool, whole_input: bool = False) -> torch.Tensor:
    """A 3x3 stride-1 conv of ``m``: where its level is H-sharded, this rank's
    output rows through :func:`parallel.spatial.halo_conv2d` (``whole_input``:
    read from a whole ``x`` with no transfer), else :func:`apply_conv`."""
    if sharded:
        return spatial.halo_conv2d(m, x, whole_input=whole_input)
    return apply_conv(m, x, padding=1)


def norm_act(m: nn.Module, x: torch.Tensor, sharded: bool, silu: bool = True) -> torch.Tensor:
    """GroupNorm (+ SiLU) with ``m``'s scale and bias, over the whole image's
    statistics when ``x`` is H-sharded."""
    if sharded:
        return spatial.group_norm(x, m.weight, m.bias, silu=silu)
    return (group_norm_silu if silu else group_norm)(x, m.weight, m.bias)


def downsample(m: nn.Module, x: torch.Tensor, sharded_in: bool, sharded_out: bool,
               padding: Padding = 1) -> torch.Tensor:
    """The stride-2 conv of ``m``. From an H-sharded level each rank computes its
    output rows; they are gathered where the level below is not sharded, which
    moves a quarter of the bytes of gathering the input. Local rows of an odd
    count do not split at stride 2: the input is gathered first."""
    if not sharded_in:
        return apply_conv(m, x, stride=2, padding=padding)
    if x.shape[2] % 2:  # only where the level below is whole: its h/n would be fractional
        return apply_conv(m, spatial.gather_rows(x), stride=2, padding=padding)
    y = spatial.halo_conv2d(m, x, 2, padding)
    return y if sharded_out else spatial.gather_rows(y)


def upsample(m: nn.Module, x: torch.Tensor, sharded_in: bool, sharded_out: bool) -> torch.Tensor:
    """Nearest-2x and the 3x3 conv of ``m``; into an H-sharded level, this rank's
    output rows only (a sharded level's double is sharded too)."""
    if sharded_out:
        return spatial.upsample2x_conv3x3(m, x, whole_input=not sharded_in)
    return upsample2x_conv3x3(x, m.weight, m.bias)
