"""The port's checkpoint converters (``minsdtf_tpu_torch.weights.convert``) against the
JAX package's: crafted checkpoints in the LDM, diffusers, old-diffusers VAE and
``control_model.*`` layouts, saved as F16, BF16 and F32 ``.safetensors`` and as
``.pt`` / ``.ckpt`` pickles with a ``state_dict`` wrapper, must convert to exactly
``from_jax(_build_params(...))`` of the JAX package's reader. Also the errors of
``build_state_dict``, the converted-weights cache and the mapped safetensors reader."""

import functools
import json
import mmap
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as save_numpy
from safetensors.torch import save_file as save_torch

import oracle_utils
from minsdtf_tpu.models import controlnet as jcontrolnet
from minsdtf_tpu.models import unet as junet
from minsdtf_tpu.models import vae as jvae
from minsdtf_tpu.weights import convert as jconvert
from minsdtf_tpu.weights import mapping as jmapping
from minsdtf_tpu_torch.models import clip as tclip
from minsdtf_tpu_torch.models import controlnet as tcontrolnet
from minsdtf_tpu_torch.models import unet as tunet
from minsdtf_tpu_torch.models import vae as tvae
from minsdtf_tpu_torch.weights import convert as tconvert
from minsdtf_tpu_torch.weights.from_jax import from_jax, split_vae
from torch_port_utils import one_torch_thread, tmp_path  # noqa: F401 (fixtures)

SMALL = dict(widths=(32, 64, 128, 128), temb_dim=128)
VAE_SMALL = dict(enc_widths=(32, 32, 64, 64), dec_widths=(64, 64, 32, 32))
# BF16 last: the others read back the same values and share one JAX build
FORMATS = ["F16.safetensors", "F32.safetensors", "wrapped.pt", "legacy.ckpt",
           "BF16.safetensors"]


def _inverse(module_map):
    inverse = {v: k for k, v in module_map.items()}
    return lambda name: inverse.get(name, name)


def _vae_ldm(specs, rng):
    """The LDM single-file VAE: ``first_stage_model.`` names, the attention
    projections as (c, c, 1, 1) convs."""
    sd = oracle_utils.synth_state_dict(specs, rng, names=_inverse(jmapping.vae_ldm_to_diffusers()))
    return {jmapping.VAE_LDM_PREFIX + k: (v[:, :, None, None] if v.ndim == 2 else v)
            for k, v in sd.items()}


def _clip_ldm(specs, rng):
    sd = oracle_utils.synth_state_dict(specs, rng)
    sd["text_model.embeddings.position_ids"] = np.arange(77, dtype=np.int64)[None]
    return {jmapping.TEXT_ENCODER_LDM_PREFIX + k: v for k, v in sd.items()}


def _unet_skeleton():
    return tconvert._skeleton(lambda: tunet.UNet(**SMALL))


def _jax_unet(sd):
    if any(k.startswith(jmapping.UNET_LDM_PREFIX) for k in sd):
        sd = jconvert._renamed(sd, jmapping.unet_ldm_to_diffusers())
    return from_jax(jconvert._build_params(sd, junet.param_specs(**SMALL)), _unet_skeleton())


def _jax_vae(sd):
    if any(k.startswith(jmapping.VAE_LDM_PREFIX) for k in sd):
        sd = {k[len(jmapping.VAE_LDM_PREFIX):]: v for k, v in sd.items()}
        sd = jconvert._renamed(sd, jmapping.vae_ldm_to_diffusers())
    params = jconvert._build_params(sd, jvae.param_specs(**VAE_SMALL),
                                    alternates=jmapping.VAE_ATTN_ALTERNATES)
    enc, dec = split_vae(params)
    return (from_jax(enc, tconvert._skeleton(lambda: tvae.VAEEncoder(VAE_SMALL["enc_widths"]))),
            from_jax(dec, tconvert._skeleton(lambda: tvae.VAEDecoder(VAE_SMALL["dec_widths"]))))


def _jax_controlnet(sd):
    sd = jconvert._renamed(sd, jmapping.controlnet_ldm_to_diffusers())
    return from_jax(jconvert._build_params(sd, jcontrolnet.param_specs(**SMALL)),
                    tconvert._skeleton(lambda: tcontrolnet.ControlNet(**SMALL)))


def _jax_clip(sd):
    return from_jax(jconvert.convert_text_encoder(sd), tconvert._skeleton(tclip.CLIPTextModel))


FORMS = {  # form: (JAX specs, synthesize, the JAX reference, the port's converter)
    "unet_ldm": (lambda: junet.param_specs(**SMALL),
                 lambda specs, rng: oracle_utils.synth_state_dict(
                     specs, rng, names=_inverse(jmapping.unet_ldm_to_diffusers())),
                 _jax_unet, lambda src: tconvert.convert_unet(src, **SMALL)),
    "unet_diffusers": (lambda: junet.param_specs(**SMALL), oracle_utils.synth_state_dict,
                       _jax_unet, lambda src: tconvert.convert_unet(src, **SMALL)),
    "vae_ldm": (lambda: jvae.param_specs(**VAE_SMALL), _vae_ldm, _jax_vae,
                lambda src: tconvert.convert_vae(src, **VAE_SMALL)),
    "vae_old_diffusers": (lambda: jvae.param_specs(**VAE_SMALL),
                          lambda specs, rng: oracle_utils.synth_state_dict(specs, rng,
                                                                           names="vae_old"),
                          _jax_vae, lambda src: tconvert.convert_vae(src, **VAE_SMALL)),
    "controlnet_pth": (lambda: jcontrolnet.param_specs(**SMALL),
                       lambda specs, rng: oracle_utils.synth_state_dict(
                           specs, rng, names=_inverse(jmapping.controlnet_ldm_to_diffusers())),
                       _jax_controlnet, lambda src: tconvert.convert_controlnet(src, **SMALL)),
    "clip_ldm": (jconvert._text_encoder_specs, _clip_ldm, _jax_clip,
                 tconvert.convert_text_encoder),
}


def save(sd, path: str) -> str:
    """``sd`` (fp16 numpy floats) in the format that ``path``'s name gives."""
    name = os.path.basename(path)
    if name.startswith("BF16"):
        save_torch({k: torch.from_numpy(np.ascontiguousarray(v)).to(torch.bfloat16)
                    if v.dtype.kind == "f" else torch.from_numpy(v) for k, v in sd.items()}, path)
    elif name.endswith(".safetensors"):
        cast = np.float32 if name.startswith("F32") else np.float16
        save_numpy({k: np.ascontiguousarray(v.astype(cast) if v.dtype.kind == "f" else v)
                    for k, v in sd.items()}, path)
    else:
        tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
        torch.save({"state_dict": tensors, "global_step": 1}, path,
                   _use_new_zipfile_serialization=name.endswith(".pt"))
    return path


def assert_same_state(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_same_state(g, w)
        return
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == torch.float32 and torch.equal(got[key], value), key


@functools.lru_cache(maxsize=1)
def synthesized(form: str):
    """The form's checkpoint as fp16 numpy arrays (one form at a time is kept: the
    tests of a form run in a row)."""
    specs, synth, _, _ = FORMS[form]
    sd = synth(specs(), np.random.RandomState(0))
    if form == "controlnet_pth":  # the full SD model rides along in a real .pth
        sd["model.diffusion_model.input_blocks.0.0.weight"] = np.ones((4, 4, 3, 3), np.float16)
    return sd


_REFERENCES = {}


def jax_reference(form: str, path: str):
    """The JAX package's reader and ``_build_params`` on ``path``. Files that read
    back the same values (all but BF16 hold the fp16 values exactly) share one
    build."""
    sd = jconvert.read_state_dict(path)
    key = (form, tuple(zlib.crc32(np.ascontiguousarray(sd[k]).tobytes()) for k in sorted(sd)))
    if key not in _REFERENCES:
        _REFERENCES.clear()
        _REFERENCES[key] = FORMS[form][2](sd)
    return _REFERENCES[key]


@pytest.mark.parametrize("form,fmt", [(form, fmt) for form in FORMS for fmt in FORMATS])
def test_converter_equals_jax_build_params(tmp_path, form, fmt):
    path = save(synthesized(form), str(tmp_path / fmt))
    try:
        assert_same_state(FORMS[form][3](path), jax_reference(form, path))
    finally:
        os.remove(path)  # the full-width CLIP files are 250-500 MB


def test_missing_key_and_wrong_shape_raise():
    specs = junet.param_specs(**SMALL)
    sd = oracle_utils.synth_state_dict(specs, np.random.RandomState(1), dtype=np.float32)
    missing = dict(sd)
    del missing["conv_in.weight"], missing["conv_out.bias"]
    with pytest.raises(KeyError, match="2 missing checkpoint keys"):
        tconvert.convert_unet(missing, **SMALL)
    wrong = dict(sd)
    wrong["conv_in.bias"] = np.zeros(33, np.float32)
    with pytest.raises(ValueError, match="conv_in.bias: shape"):
        tconvert.convert_unet(wrong, **SMALL)
    wrong = dict(sd)
    wrong["conv_in.weight"] = sd["conv_in.weight"][0]
    with pytest.raises(ValueError, match="conv_in.weight: rank"):
        tconvert.convert_unet(wrong, **SMALL)


@pytest.fixture
def unet_file(tmp_path):
    specs = junet.param_specs(**SMALL)
    sd = oracle_utils.synth_state_dict(specs, np.random.RandomState(2), dtype=np.float32)
    return save(sd, str(tmp_path / "F32.safetensors"))


def _lora_deltas():
    rng = np.random.RandomState(3)
    name = "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight"
    return {name: rng.normal(0, 0.1, (32, 32)).astype(np.float32)}


def test_the_cache_is_read_back_and_bypassed(unet_file, monkeypatch):
    monkeypatch.delenv("MINSDTF_NO_CACHE", raising=False)
    cache = f"{unet_file}.minsdtf-torch-unet.pt"
    first = tconvert.convert_cached("unet", unet_file, **SMALL)
    assert os.path.exists(cache)
    reads = []
    real_read = tconvert.read_state_dict
    monkeypatch.setattr(tconvert, "read_state_dict", lambda p: reads.append(p) or real_read(p))
    second = tconvert.convert_cached("unet", unet_file, **SMALL)
    assert reads == []  # from the cache, not the checkpoint
    assert_same_state(second, first)

    # a LoRA merges into the cached base and writes nothing
    stamp = os.path.getmtime(cache)
    merged = tconvert.convert_cached("unet", unet_file, lora=_lora_deltas(), **SMALL)
    assert reads == [] and os.path.getmtime(cache) == stamp
    assert_same_state(merged, tconvert.convert_unet(unet_file, lora=_lora_deltas(), **SMALL))
    reads.clear()
    os.remove(cache)
    tconvert.convert_cached("unet", unet_file, lora=_lora_deltas(), **SMALL)
    assert not os.path.exists(cache) and reads == [unet_file]

    # MINSDTF_NO_CACHE=1 converts from the checkpoint and writes nothing
    monkeypatch.setenv("MINSDTF_NO_CACHE", "1")
    assert_same_state(tconvert.convert_cached("unet", unet_file, **SMALL), first)
    assert not os.path.exists(cache) and reads == [unet_file] * 2
    monkeypatch.delenv("MINSDTF_NO_CACHE")

    # a checkpoint newer than its cache is converted again
    tconvert.convert_cached("unet", unet_file, **SMALL)
    os.utime(unet_file, (os.path.getmtime(cache) + 10,) * 2)
    tconvert.convert_cached("unet", unet_file, **SMALL)
    assert reads == [unet_file] * 4


def test_lora_merge_equals_jax_build_params(unet_file):
    deltas = _lora_deltas()
    want = from_jax(jconvert._build_params(jconvert.read_state_dict(unet_file),
                                           junet.param_specs(**SMALL), lora=deltas),
                    _unet_skeleton())
    assert_same_state(tconvert.convert_unet(unet_file, lora=deltas, **SMALL), want)


def _old_read_safetensors(path):
    """The reader before it mapped the file: the whole buffer read, every float
    array copied to fp32."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        buffer = f.read()
    out = {}
    for key, info in header.items():
        if key == "__metadata__":
            continue
        start, end = info["data_offsets"]
        chunk = buffer[start:end]
        if info["dtype"] == "BF16":
            arr = (np.frombuffer(chunk, dtype="<u2").astype(np.uint32) << 16).view(np.float32)
        else:
            arr = np.frombuffer(chunk, dtype=tconvert._SAFETENSORS_DTYPES[info["dtype"]])
        arr = arr.reshape(info["shape"])
        out[key] = arr.astype(np.float32) if arr.dtype.kind == "f" else arr
    return out


@pytest.mark.parametrize("fmt", [f for f in FORMATS if f.endswith(".safetensors")])
def test_mapped_reader_gives_the_old_readers_arrays(tmp_path, fmt):
    rng = np.random.RandomState(4)
    sd = {"a": rng.normal(0, 1, (3, 5)).astype(np.float16), "odd": np.ones(3, np.float16),
          "b": rng.normal(0, 1, (7,)).astype(np.float16), "i": np.arange(4, dtype=np.int64)}
    path = save(sd, str(tmp_path / fmt))
    got, want = tconvert.read_safetensors(path), _old_read_safetensors(path)
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape
        np.testing.assert_array_equal(got[key], want[key])
    # fp32 tensors are views of the mapped file, not copies
    assert _mapped(got["a"]) == fmt.startswith("F32")


def _mapped(a) -> bool:
    """Whether ``a`` is a view of a mapped file."""
    while isinstance(a, np.ndarray):
        a = a.base
    return isinstance(a, mmap.mmap)
