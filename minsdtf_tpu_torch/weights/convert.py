"""Checkpoint files -> ``{key: float32 numpy}`` state dicts.

``.safetensors`` is read here in plain Python (an 8-byte little-endian header
length, a JSON header of ``{key: {dtype, shape, data_offsets}}``, then one raw
buffer), so the port needs neither the ``safetensors`` package nor a native
reader. F32, F16, BF16 and F64 tensors become fp32; integer and bool tensors keep
their type. Other files go through ``torch.load(weights_only=True)``; a file that
needs full unpickling (which can run code) loads only with
``MINSDTF_UNSAFE_PICKLE=1``.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict

import numpy as np
import torch

StateDict = Dict[str, np.ndarray]

_SAFETENSORS_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}
# a header this long is not a safetensors file (the format caps it at 100 MB)
_MAX_HEADER_BYTES = 100 * 1024 * 1024


def read_safetensors(path: str) -> StateDict:
    """Every tensor of a ``.safetensors`` file, floats as fp32."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: too short for a safetensors header")
        (n,) = struct.unpack("<Q", raw)
        if n > _MAX_HEADER_BYTES:
            raise ValueError(f"{path}: header of {n} bytes; not a safetensors file")
        header = json.loads(f.read(n))
        buffer = f.read()
    out: StateDict = {}
    for key, info in header.items():
        if key == "__metadata__":
            continue
        start, end = info["data_offsets"]
        if not 0 <= start <= end <= len(buffer):
            raise ValueError(f"{path}: {key} lies outside the data buffer")
        chunk = buffer[start:end]
        shape = tuple(info["shape"])
        dtype = info["dtype"]
        if dtype == "BF16":
            # bf16 is the top half of an fp32
            bits = np.frombuffer(chunk, dtype="<u2").astype(np.uint32) << 16
            arr = bits.view(np.float32)
        elif dtype in _SAFETENSORS_DTYPES:
            arr = np.frombuffer(chunk, dtype=np.dtype(_SAFETENSORS_DTYPES[dtype]).newbyteorder("<"))
        else:
            raise ValueError(f"{path}: {key} has dtype {dtype}, which is not read")
        if arr.size != int(np.prod(shape)):
            raise ValueError(f"{path}: {key} holds {arr.size} values for shape {shape}")
        arr = arr.reshape(shape)
        if arr.dtype.kind == "f":
            arr = arr.astype(np.float32)
        out[key] = arr
    return out


def torch_load(path: str):
    """``torch.load`` on the CPU with the safe unpickler; full unpickling only
    with ``MINSDTF_UNSAFE_PICKLE=1``."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        if os.environ.get("MINSDTF_UNSAFE_PICKLE") != "1":
            raise IOError(
                f"{path}: not loadable with torch weights_only=True; if you trust "
                "this file, set MINSDTF_UNSAFE_PICKLE=1 to allow full unpickling"
            )
        return torch.load(path, map_location="cpu", weights_only=False)


def read_state_dict(path: str) -> StateDict:
    """Read a checkpoint file into a ``{key: numpy}`` dict, floats as fp32."""
    if str(path).endswith(".safetensors"):
        return read_safetensors(path)
    state = torch_load(path)
    if isinstance(state, dict) and isinstance(state.get("state_dict"), dict):
        state = state["state_dict"]
    return {k: _to_numpy(v) for k, v in state.items() if isinstance(v, torch.Tensor)}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.to(torch.float32) if t.is_floating_point() else t).numpy()
