"""Textual-inversion embedding files -> (n_tokens, 768) fp32 numpy matrices.

A1111-style ``.pt`` files: the first fp32 or fp16 tensor under
``state_dict["string_to_param"]``. ``.safetensors`` files: ``emb_params`` or
``string_to_param``, else the file's only tensor.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from minsdtf_tpu_torch.weights.convert import read_safetensors, torch_load

EMBED_DIM = 768


def load_embedding(path: str) -> Optional[np.ndarray]:
    """The embedding matrix in ``path``, or None when the file is missing or holds
    none."""
    if not os.path.exists(str(path)):
        return None
    if str(path).endswith(".safetensors"):
        sd = read_safetensors(str(path))
        for key in ("emb_params", "string_to_param"):
            if key in sd:
                return np.asarray(sd[key], dtype=np.float32)
        for val in sd.values():  # single-tensor files
            return np.asarray(val, dtype=np.float32)
        return None
    state = torch_load(path)
    table = state.get("string_to_param") if isinstance(state, dict) else None
    if table is None:
        return None
    for value in table.values():
        if hasattr(value, "dtype") and value.dtype in (torch.float32, torch.float16):
            return value.detach().to(torch.float32).numpy()
    return None


def embedding_matrix(embedding_data) -> Optional[np.ndarray]:
    """``embedding_data`` (None, a path, an array, or a list of them) as one
    (n, 768) fp32 matrix, the items concatenated along the token axis."""
    if embedding_data is None:
        return None
    items = embedding_data if isinstance(embedding_data, (list, tuple)) else [embedding_data]
    mats = []
    for item in items:
        if isinstance(item, (str, os.PathLike)):
            mat = load_embedding(str(item))
            if mat is None:
                raise ValueError(f"failed to load embedding file: {item}.")
        else:
            mat = np.asarray(item, dtype=np.float32)
        mats.append(mat)
    embedding = np.concatenate(mats, axis=0)
    if embedding.ndim != 2 or embedding.shape[1] != EMBED_DIM or embedding.shape[0] == 0:
        raise ValueError(f"a textual-inversion embedding is (n, {EMBED_DIM}), "
                         f"not {embedding.shape}")
    return embedding
