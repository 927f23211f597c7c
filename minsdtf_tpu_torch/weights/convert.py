"""Checkpoint files -> the port's ``state_dict`` s.

Reading: ``.safetensors`` is read here in plain Python (an 8-byte little-endian
header length, a JSON header of ``{key: {dtype, shape, data_offsets}}``, then one
raw buffer), so the port needs neither the ``safetensors`` package nor a native
reader. The file is mapped, not read: an F32 tensor is a view of the mapping
(copy-on-write), and F16, BF16 and F64 tensors become fp32 copies; integer and
bool tensors keep their type. Other files go through
``torch.load(weights_only=True)``, mapped too where the file is in torch's zip
format; a file that needs full unpickling (which can run code) loads only with
``MINSDTF_UNSAFE_PICKLE=1``.

Converting: ``convert_unet`` / ``convert_vae`` / ``convert_text_encoder`` /
``convert_controlnet`` take a checkpoint path or a ``{key: array}`` dict in the
LDM single-file layout or the diffusers one (told apart by the LDM prefixes, as
the JAX package's ``weights/convert.py`` does) and return fp32 ``state_dict`` s
for the port's unfused modules. :func:`build_state_dict` follows the JAX
package's ``_build_params``: a missing key raises ``KeyError``, a wrong shape
``ValueError``, extra keys are ignored, the old-diffusers VAE attention names are
tried, and LoRA deltas are added to conv and dense weights in fp32.
:func:`convert_cached` keeps the converted fp32 ``state_dict`` beside the
checkpoint as ``<ckpt>.minsdtf-torch-<kind>.pt``.
"""

from __future__ import annotations

import json
import os
import pickle
import struct
import zipfile
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from minsdtf_tpu_torch.weights import mapping

StateDict = Dict[str, np.ndarray]

_SAFETENSORS_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}
# a header this long is not a safetensors file (the format caps it at 100 MB)
_MAX_HEADER_BYTES = 100 * 1024 * 1024


def read_safetensors(path: str) -> StateDict:
    """Every tensor of a ``.safetensors`` file, floats as fp32. The file is mapped
    copy-on-write; F32 tensors are views of the mapping, not copies."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: too short for a safetensors header")
        (n,) = struct.unpack("<Q", raw)
        if n > _MAX_HEADER_BYTES:
            raise ValueError(f"{path}: header of {n} bytes; not a safetensors file")
        header = json.loads(f.read(n))
    size = os.path.getsize(path) - 8 - n
    buffer = (np.memmap(path, dtype=np.uint8, mode="c", offset=8 + n) if size > 0
              else np.zeros(0, np.uint8))
    out: StateDict = {}
    for key, info in header.items():
        if key == "__metadata__":
            continue
        start, end = info["data_offsets"]
        if not 0 <= start <= end <= size:
            raise ValueError(f"{path}: {key} lies outside the data buffer")
        chunk = buffer[start:end]
        shape = tuple(info["shape"])
        dtype = info["dtype"]
        if dtype == "BF16":
            item = np.dtype("<u2")
        elif dtype in _SAFETENSORS_DTYPES:
            item = np.dtype(_SAFETENSORS_DTYPES[dtype]).newbyteorder("<")
        else:
            raise ValueError(f"{path}: {key} has dtype {dtype}, which is not read")
        if chunk.size % item.itemsize:
            raise ValueError(f"{path}: {key} holds {chunk.size} bytes for shape {shape}")
        arr = chunk.view(item)
        if dtype == "BF16":  # bf16 is the top half of an fp32
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        if arr.size != int(np.prod(shape)):
            raise ValueError(f"{path}: {key} holds {arr.size} values for shape {shape}")
        arr = arr.reshape(shape)
        if arr.dtype.kind == "f":
            arr = arr.astype(np.float32, copy=False)
        out[key] = arr
    return out


def torch_load(path: str):
    """``torch.load`` on the CPU with the safe unpickler, mapping the file where it
    is in torch's zip format; full unpickling only with ``MINSDTF_UNSAFE_PICKLE=1``."""
    mmap = zipfile.is_zipfile(path)
    try:
        return torch.load(path, map_location="cpu", weights_only=True, mmap=mmap)
    except pickle.UnpicklingError:
        if os.environ.get("MINSDTF_UNSAFE_PICKLE") != "1":
            raise IOError(
                f"{path}: not loadable with torch weights_only=True; if you trust "
                "this file, set MINSDTF_UNSAFE_PICKLE=1 to allow full unpickling"
            )
        return torch.load(path, map_location="cpu", weights_only=False, mmap=mmap)


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


# ---- assembling the state dict ----------------------------------------------------


def _renamed(sd: Mapping, module_map: Dict[str, str]) -> dict:
    """Translate module-level names; keys not covered by the map pass through
    (covers layouts that are already diffusers-named)."""
    out = {}
    for key, val in sd.items():
        module, _, leaf = key.rpartition(".")
        out[f"{module_map.get(module, module)}.{leaf}"] = val
    return out


def _stripped(sd: Mapping, prefix: str) -> dict:
    """The entries of ``sd`` under ``prefix``, with the prefix removed."""
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def build_state_dict(sd: Mapping, module: nn.Module, lora: Optional[Mapping] = None,
                     alternates: Optional[Dict[str, str]] = None) -> Dict[str, torch.Tensor]:
    """A fp32 ``state_dict`` for ``module`` (its keys and shapes; a module on the
    meta device will do) from ``sd``, a diffusers-named ``{key: numpy or tensor}``
    dict in torch layout. Each conv and dense weight gets ``lora[key]`` added in
    fp32 where there is one; a 4-D ``(out, in, 1, 1)`` tensor goes into an
    ``nn.Linear`` as ``(out, in)`` (the LDM VAE's attention). ``alternates`` maps a
    module-name suffix to another to try (VAE ``to_q`` -> ``query``). Raises
    ``KeyError`` for missing keys and ``ValueError`` for a wrong rank or shape;
    keys of ``sd`` that ``module`` lacks are ignored."""
    lora = lora or {}
    kernels = {f"{name}.weight" for name, m in module.named_modules()
               if isinstance(m, (nn.Conv2d, nn.Linear))}
    out: Dict[str, torch.Tensor] = {}
    missing = []
    applied_lora = 0
    for key, like in module.state_dict().items():
        name, _, suffix = key.rpartition(".")
        w = sd.get(key)
        if w is None and alternates:
            for want, alt in alternates.items():
                if name.endswith(want):
                    w = sd.get(f"{name[: -len(want)]}{alt}.{suffix}")
                    if w is not None:
                        break
        if w is None:
            missing.append(key)
            continue
        w = torch.as_tensor(w)
        if key in kernels:
            delta = lora.get(key)
            if delta is not None:
                w = w + torch.as_tensor(delta).reshape(w.shape)
                applied_lora += 1
            if w.dim() == 4 and like.dim() == 2:
                w = w[:, :, 0, 0]
            elif w.dim() != like.dim():
                raise ValueError(f"{key}: rank {w.dim()} vs expected {tuple(like.shape)}")
        w = w.to(torch.float32).contiguous()
        if tuple(w.shape) != tuple(like.shape):
            raise ValueError(f"{key}: shape {tuple(w.shape)} != expected {tuple(like.shape)}")
        out[key] = w
    if missing:
        raise KeyError(f"{len(missing)} missing checkpoint keys, first: {missing[:8]}")
    if lora:
        n_lora = sum(1 for k in lora if k.endswith(".weight"))
        if applied_lora != n_lora:
            print(f"Applied {applied_lora}/{n_lora} LoRA deltas")
    return out


def _skeleton(factory: Callable[[], nn.Module]) -> nn.Module:
    with torch.device("meta"):
        return factory()


def _source(source) -> Mapping:
    return read_state_dict(source) if isinstance(source, (str, os.PathLike)) else source


# ---- per-model converters ------------------------------------------------------------


def convert_unet(source, lora: Optional[Mapping] = None, widths=None,
                 temb_dim: int = 1280) -> Dict[str, torch.Tensor]:
    """``source``: a path or a state dict, LDM or diffusers layout, auto-detected.
    Returns the unfused :class:`models.unet.UNet`'s ``state_dict``; ``widths``
    default to SD1.5's."""
    from minsdtf_tpu_torch.models import unet as unet_lib

    sd = _source(source)
    if any(k.startswith(mapping.UNET_LDM_PREFIX) for k in sd):
        sd = _renamed(sd, mapping.unet_ldm_to_diffusers())
    widths = widths or unet_lib.BLOCK_WIDTHS
    return build_state_dict(sd, _skeleton(lambda: unet_lib.UNet(widths, temb_dim)), lora=lora)


def convert_vae(source, enc_widths=None, dec_widths=None):
    """-> (:class:`models.vae.VAEEncoder` ``state_dict``, :class:`models.vae.VAEDecoder`
    ``state_dict``) from one VAE (or single-file) checkpoint."""
    from minsdtf_tpu_torch.models import vae as vae_lib

    sd = _source(source)
    if any(k.startswith(mapping.VAE_LDM_PREFIX) for k in sd):
        sd = _renamed(_stripped(sd, mapping.VAE_LDM_PREFIX), mapping.vae_ldm_to_diffusers())
    enc = _skeleton(lambda: vae_lib.VAEEncoder(enc_widths or vae_lib.ENC_WIDTHS))
    dec = _skeleton(lambda: vae_lib.VAEDecoder(dec_widths or vae_lib.DEC_WIDTHS))
    alternates = mapping.VAE_ATTN_ALTERNATES
    return (build_state_dict(sd, enc, alternates=alternates),
            build_state_dict(sd, dec, alternates=alternates))


def convert_text_encoder(source, lora: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    """-> the :class:`models.clip.CLIPTextModel` ``state_dict``; a single-file
    checkpoint's ``cond_stage_model.transformer.`` prefix is stripped."""
    from minsdtf_tpu_torch.models import clip as clip_lib

    sd = _source(source)
    if any(k.startswith(mapping.TEXT_ENCODER_LDM_PREFIX) for k in sd):
        sd = _stripped(sd, mapping.TEXT_ENCODER_LDM_PREFIX)
    return build_state_dict(sd, _skeleton(clip_lib.CLIPTextModel), lora=lora)


def convert_controlnet(source, widths=None, temb_dim: int = 1280) -> Dict[str, torch.Tensor]:
    """-> the unfused :class:`models.controlnet.ControlNet` ``state_dict`` from
    lllyasviel's ``control_model.*`` layout or a diffusers one."""
    from minsdtf_tpu_torch.models import controlnet as controlnet_lib

    sd = _source(source)
    if any(k.startswith("control_model.") for k in sd):
        sd = _renamed(sd, mapping.controlnet_ldm_to_diffusers())
    widths = widths or controlnet_lib.BLOCK_WIDTHS
    return build_state_dict(
        sd, _skeleton(lambda: controlnet_lib.ControlNet(widths, temb_dim)))


CONVERTERS = {
    "unet": convert_unet,
    "vae": convert_vae,
    "text_encoder": convert_text_encoder,
    "controlnet": convert_controlnet,
}


# ---- the converted-weights cache -----------------------------------------------------


def cache_path(path: str, kind: str) -> str:
    return f"{path}.minsdtf-torch-{kind}.pt"


def convert_cached(kind: str, path: str, lora: Optional[Mapping] = None,
                   use_cache: Optional[bool] = None, **widths):
    """``CONVERTERS[kind]`` on ``path``, through an on-disk cache of the converted
    fp32 ``state_dict`` (:func:`cache_path`): written with ``torch.save`` after a
    conversion, read back mapped (``torch.load(weights_only=True, mmap=True)``) when
    it is newer than the checkpoint. With ``lora`` the deltas are merged into the
    cached base when there is one (else into a fresh conversion), and nothing is
    written: a merged load is never cached. ``MINSDTF_NO_CACHE=1`` or
    ``use_cache=False`` bypasses the cache. ``widths`` go to the converter."""
    if use_cache is None:
        use_cache = os.environ.get("MINSDTF_NO_CACHE") != "1"
    fn = CONVERTERS[kind]
    extra = dict(widths, **({} if lora is None else {"lora": lora}))
    if not use_cache:
        return fn(path, **extra)
    cached = cache_path(path, kind)
    base = None
    if os.path.exists(cached) and os.path.getmtime(cached) >= os.path.getmtime(path):
        try:
            base = torch.load(cached, map_location="cpu", weights_only=True, mmap=True)
        except (RuntimeError, pickle.UnpicklingError, EOFError) as e:
            print(f"converted-weights cache read failed ({e}); reconverting")
    if base is not None:
        return base if lora is None else fn(base, **extra)
    if lora is not None:
        return fn(path, **extra)
    state = fn(path, **widths)
    tmp = f"{cached}.{os.getpid()}.tmp"
    try:
        torch.save(state, tmp)
        os.replace(tmp, cached)
    except OSError as e:
        print(f"converted-weights cache write failed ({e})")
    return state
