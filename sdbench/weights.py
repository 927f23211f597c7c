"""Random weights from the seed, in the published (diffusers / transformers)
parameter names, made on the device in one draw.

The names and shapes come from the reference's models of the configuration's
family (``sdbench/families/``), built on the meta device.
One standard-normal draw of every parameter's elements from a ``torch.Generator``
on the device, then each tensor is scaled in place: conv and dense kernels and
embeddings by 1/sqrt(fan-in) (so activations keep their scale through the depth),
biases by 0.02, norm scales to N(1, 0.1) and norm shifts to N(0.1, 0.1) (the
weighted prompt's mean-preserving rescale divides by the text context's mean,
which a zero-mean shift would put near zero).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from sdbench import families


def _init(module: nn.Module, name: str, t: torch.Tensor) -> tuple:
    """(scale, shift) of the parameter ``name`` of ``module``."""
    if isinstance(module, (nn.GroupNorm, nn.LayerNorm)):
        return (0.1, 1.0) if name == "weight" else (0.1, 0.1)
    if name == "bias":
        return 0.02, 0.0
    fan_in = t[0].numel() if t.dim() > 1 and not isinstance(module, nn.Embedding) else 1
    return 1.0 / math.sqrt(fan_in), 0.0


def make(cfg: dict, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{kind: {name: fp32 tensor}}`` for the models of ``cfg``'s family
    (its ``kinds``), every tensor a view into one buffer on ``device``; the same
    seed gives the same weights."""
    family = families.load(cfg)
    kinds = family.kinds(cfg)
    plan = []
    for kind in kinds:
        model = family.build(kind, cfg)
        for mod_name, module in model.named_modules():
            for p_name, p in module.named_parameters(recurse=False):
                full = f"{mod_name}.{p_name}" if mod_name else p_name
                plan.append((kind, full, tuple(p.shape), _init(module, p_name, p)))
    total = sum(math.prod(shape) for _, _, shape, _ in plan)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out: Dict[str, Dict[str, torch.Tensor]] = {k: {} for k in kinds}
    offset = 0
    with torch.no_grad():
        for kind, name, shape, (scale, shift) in plan:
            n = math.prod(shape)
            t = flat[offset:offset + n].view(shape)
            t.mul_(scale).add_(shift)
            out[kind][name] = t
            offset += n
    return out
