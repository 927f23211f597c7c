"""Primitive NN ops: conv / dense / norms / activations, plain functions on tensors.

Layouts are PyTorch's: images are NCHW, conv weights OIHW, dense weights
``(out, in)``. Matmuls and convs run in the dtype of the activations (bf16 in
production, fp32 in parity tests) with fp32 accumulation; the weight and bias are
cast to that dtype. Normalization statistics are always fp32.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

Padding = Union[int, Tuple[Tuple[int, int], Tuple[int, int]]]


def _cast(t: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
           stride: int = 1, padding: Padding = 0) -> torch.Tensor:
    """2-D convolution, NCHW x OIHW. ``padding`` is an int (symmetric) or explicit
    ``((top, bottom), (left, right))``, as the VAE encoder's stride-2
    ``((0, 1), (0, 1))`` needs."""
    if not isinstance(padding, int):
        (top, bottom), (left, right) = padding
        x = F.pad(x, (left, right, top, bottom))
        padding = 0
    return F.conv2d(x, weight.to(x.dtype), _cast(bias, x.dtype), stride=stride, padding=padding)


def dense(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Affine map over the last axis; ``weight`` is ``(out, in)``."""
    return F.linear(x, weight.to(x.dtype), _cast(bias, x.dtype))


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over the channel axis of NCHW, fp32 statistics and affine."""
    out = F.group_norm(x.float(), num_groups, weight.float(), bias.float(), eps)
    return out.to(x.dtype)


def group_norm_silu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm + SiLU, the prologue of every ResBlock conv."""
    return silu(group_norm(x, weight, bias, num_groups, eps))


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, fp32 statistics and affine."""
    out = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(), eps)
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
    value, gate = dense(x, weight, bias).chunk(2, dim=-1)
    return value * gelu_tanh(gate)


def upsample2x_conv3x3(x: torch.Tensor, weight: torch.Tensor,
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``conv2d(nearest_2x(x), padding=1)``: the UNet and VAE upsamplers."""
    return conv2d(F.interpolate(x, scale_factor=2, mode="nearest"), weight, bias, padding=1)
