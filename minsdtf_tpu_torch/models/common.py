"""Parameter holders and random init shared by the models.

The models keep their parameters in ``nn.Conv2d`` / ``nn.Linear`` / ``nn.GroupNorm``
/ ``nn.LayerNorm`` / ``nn.Embedding`` so that ``state_dict`` keys are the
diffusers-style dotted names (``down_blocks.0.resnets.0.conv1.weight``); the
forwards call :mod:`minsdtf_tpu_torch.ops.basic` on those parameters.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch import nn

from minsdtf_tpu_torch.ops.basic import conv2d, dense

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
    """Conv / dense kernels and embeddings to ``dtype`` (the compute dtype);
    biases and norm parameters stay fp32."""
    for m in module.modules():
        if isinstance(m, _WEIGHT_MODULES):
            m.weight.data = m.weight.data.to(dtype)
    return module


def param_shapes(factory: Callable[[], nn.Module]) -> Dict[str, Tuple[int, ...]]:
    """``{state_dict key: shape}`` of ``factory()``, built without allocating."""
    with torch.device("meta"):
        module = factory()
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def norm(c: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, c)


def apply_conv(m: nn.Conv2d, x: torch.Tensor, **kw) -> torch.Tensor:
    """:func:`ops.basic.conv2d` with ``m``'s weight and bias."""
    return conv2d(x, m.weight, m.bias, **kw)


def apply_dense(m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """:func:`ops.basic.dense` with ``m``'s weight and bias."""
    return dense(x, m.weight, m.bias)
