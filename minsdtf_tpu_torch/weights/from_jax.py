"""JAX flat param dict -> the port's ``state_dict``.

The JAX package keeps ``params[module_name] = {leaf: array}`` with conv kernels
HWIO, dense kernels ``(in, out)``, norm ``scale`` and embedding tables
``embedding``. The port's keys are ``f"{module_name}.weight"`` / ``".bias"`` with
conv weights OIHW and dense weights ``(out, in)``. A quantized module's
``kernel_q`` / ``kernel_scale`` / ``act_scale`` / ``act_qmul`` become an
:class:`~minsdtf_tpu_torch.models.common.Int8Site`'s ``weight_q`` (laid out as a
weight) / ``weight_scale`` / ``act_scale`` / ``act_qmul``;
:func:`install_int8_sites` puts empty sites where the params have them.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch
from torch import nn

from minsdtf_tpu_torch.models.common import Int8Site

_FUSED = {"to_qkv": ("to_q", "to_k", "to_v"), "to_kv": ("to_k", "to_v")}
_LEAVES = {"kernel": "weight", "kernel_q": "weight_q", "scale": "weight",
           "embedding": "weight", "bias": "bias", "kernel_scale": "weight_scale",
           "act_scale": "act_scale", "act_qmul": "act_qmul"}
_PER_OUT = ("weight", "weight_q", "weight_scale")  # split / joined along the outputs
_SHARED = ("act_scale", "act_qmul")  # one value for every part of a fused site


def _convert_leaf(leaf: str, value: np.ndarray):
    if leaf not in _LEAVES:
        raise ValueError(f"unknown leaf {leaf!r}")
    a = np.asarray(value)
    if leaf in ("kernel", "kernel_q"):
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif a.ndim == 2:
            a = a.T
        else:
            raise ValueError(f"{leaf} of rank {a.ndim}")
    return _LEAVES[leaf], torch.from_numpy(np.ascontiguousarray(a))


def _join(leaf: str, parts: List[torch.Tensor]) -> torch.Tensor:
    """One fused leaf from its unfused parts: concatenated along the outputs, or
    a shared activation scale, which the parts must agree on."""
    if leaf in _PER_OUT:
        return torch.cat(parts, dim=0)
    if leaf in _SHARED and all(torch.equal(parts[0], p) for p in parts[1:]):
        return parts[0]
    raise ValueError(f"from_jax: cannot fuse {leaf} of differing parts")


def _split(leaf: str, value: torch.Tensor, n: int) -> List[torch.Tensor]:
    if leaf in _PER_OUT:
        return [c.contiguous() for c in value.chunk(n, dim=0)]
    if leaf in _SHARED:
        return [value] * n
    raise ValueError(f"from_jax: cannot split {leaf}")


def from_jax(params: Mapping[str, Mapping[str, np.ndarray]],
             module: nn.Module) -> Dict[str, torch.Tensor]:
    """Convert ``params`` to a ``state_dict`` for ``module``.

    Fused (``to_qkv`` / ``to_kv``) and unfused attention projections are accepted
    on either side: they are concatenated or split to match ``module``. Raises
    ``ValueError`` if a key is left over on either side or a shape differs."""
    state: Dict[str, torch.Tensor] = {}
    for name, leaves in params.items():
        for leaf, value in leaves.items():
            suffix, tensor = _convert_leaf(leaf, value)
            state[f"{name}.{suffix}"] = tensor

    expected = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    for key in list(expected):
        site, _, leaf = key.rpartition(".")
        base, _, proj = site.rpartition(".")
        if key in state:
            continue
        if proj in _FUSED:  # module fused, params not: join the parts
            parts = [f"{base}.{p}.{leaf}" for p in _FUSED[proj]]
            if all(p in state for p in parts):
                state[key] = _join(leaf, [state.pop(p) for p in parts])
        else:  # module unfused, params fused: split the fused leaf
            for fused, names in _FUSED.items():
                src = f"{base}.{fused}.{leaf}"
                if proj in names and src in state:
                    for n, part in zip(names, _split(leaf, state.pop(src), len(names))):
                        state[f"{base}.{n}.{leaf}"] = part
                    break
    missing = sorted(set(expected) - set(state))
    extra = sorted(set(state) - set(expected))
    if missing or extra:
        raise ValueError(f"from_jax: missing {missing[:8]} ({len(missing)}), "
                         f"left over {extra[:8]} ({len(extra)})")
    bad = [k for k in expected if tuple(state[k].shape) != expected[k]]
    if bad:
        raise ValueError("from_jax: shape mismatch " + ", ".join(
            f"{k} {tuple(state[k].shape)} != {expected[k]}" for k in bad[:8]))
    return state


def install_int8_sites(params: Mapping[str, Mapping[str, np.ndarray]],
                       module: nn.Module) -> nn.Module:
    """Put an empty :class:`Int8Site` in ``module``, in place, at each conv or dense
    whose JAX module in ``params`` is quantized (has ``kernel_q``), with buffers for
    the activation scales that module holds; :func:`from_jax` then fills it. A
    fused JAX projection becomes a site at each of the port's unfused ones, and
    unfused JAX projections a site at the port's fused one. Returns ``module``."""
    modules = dict(module.named_modules())
    for name, leaves in params.items():
        if "kernel_q" not in leaves:
            continue
        base, _, proj = name.rpartition(".")
        prefix = f"{base}." if base else ""
        if name in modules:
            targets = [name]
        elif proj in _FUSED:
            targets = [prefix + p for p in _FUSED[proj]]
        else:
            targets = [prefix + f for f, parts in _FUSED.items()
                       if proj in parts and prefix + f in modules]
        for target in targets:
            m = module.get_submodule(target)
            if isinstance(m, Int8Site):
                continue
            w = m.weight
            site = Int8Site(
                target, torch.zeros(w.shape, dtype=torch.int8), torch.zeros(w.shape[0]),
                bias=None if m.bias is None else torch.zeros(w.shape[0]),
                act_scale=torch.zeros(()) if "act_scale" in leaves else None,
                act_qmul=torch.zeros(w.shape[1]) if "act_qmul" in leaves else None)
            module.set_submodule(target, site)
    return module


def split_vae(params: Mapping[str, Mapping[str, np.ndarray]]):
    """The JAX package's VAE dict (encoder and decoder in one) -> ``(encoder
    params, decoder params)``: ``encoder.*`` and ``quant_conv`` for
    :class:`models.vae.VAEEncoder`, the rest for :class:`models.vae.VAEDecoder`."""
    encoder = {k: v for k, v in params.items() if k.startswith("encoder.") or k == "quant_conv"}
    decoder = {k: v for k, v in params.items() if k not in encoder}
    return encoder, decoder
