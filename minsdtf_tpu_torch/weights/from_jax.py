"""JAX flat param dict -> the port's ``state_dict``.

The JAX package keeps ``params[module_name] = {leaf: array}`` with conv kernels
HWIO, dense kernels ``(in, out)``, norm ``scale`` and embedding tables
``embedding``. The port's keys are ``f"{module_name}.weight"`` / ``".bias"`` with
conv weights OIHW and dense weights ``(out, in)``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

_FUSED = {"to_qkv": ("to_q", "to_k", "to_v"), "to_kv": ("to_k", "to_v")}


def _convert_leaf(leaf: str, value: np.ndarray):
    a = np.asarray(value)
    if leaf == "kernel":
        if a.ndim == 4:
            return "weight", torch.from_numpy(np.ascontiguousarray(a.transpose(3, 2, 0, 1)))
        if a.ndim == 2:
            return "weight", torch.from_numpy(np.ascontiguousarray(a.T))
        raise ValueError(f"kernel of rank {a.ndim}")
    if leaf in ("scale", "embedding"):
        return "weight", torch.from_numpy(np.ascontiguousarray(a))
    if leaf == "bias":
        return "bias", torch.from_numpy(np.ascontiguousarray(a))
    raise ValueError(f"unknown leaf {leaf!r}")


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
        base, _, proj = key.rpartition(".")[0].rpartition(".")
        if key in state:
            continue
        if proj in _FUSED:  # module fused, params not: concatenate along out
            parts = [f"{base}.{p}.weight" for p in _FUSED[proj]]
            if all(p in state for p in parts):
                state[key] = torch.cat([state.pop(p) for p in parts], dim=0)
        else:  # module unfused, params fused: split along out
            for fused, names in _FUSED.items():
                src = f"{base}.{fused}.weight"
                if proj in names and src in state:
                    chunks = state[src].chunk(len(names), dim=0)
                    for n, c in zip(names, chunks):
                        state[f"{base}.{n}.weight"] = c.contiguous()
                    del state[src]
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


def split_vae(params: Mapping[str, Mapping[str, np.ndarray]]):
    """The JAX package's VAE dict (encoder and decoder in one) -> ``(encoder
    params, decoder params)``: ``encoder.*`` and ``quant_conv`` for
    :class:`models.vae.VAEEncoder`, the rest for :class:`models.vae.VAEDecoder`."""
    encoder = {k: v for k, v in params.items() if k.startswith("encoder.") or k == "quant_conv"}
    decoder = {k: v for k, v in params.items() if k not in encoder}
    return encoder, decoder
