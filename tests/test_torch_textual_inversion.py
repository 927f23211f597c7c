"""Textual inversion in the port against the JAX package, fp32 on the CPU: the
splice in ``fused_lpw_encode``, ``encode_text(embedding_data=...)`` for a path,
an array and a list, ``negative_embedding`` through the pipeline; and the port's
own file readers: the pure-Python safetensors reader on crafted files and the
``.pt`` loader."""

import json
import pickle
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minsdtf_tpu.models import clip as jclip
from minsdtf_tpu.text import prompt_weighting as jlpw
from minsdtf_tpu.text.tokenizer import ClipTokenizer as JaxTokenizer
from minsdtf_tpu.weights import textual_inversion as jti
from minsdtf_tpu_torch.models import clip as tclip
from minsdtf_tpu_torch.text import prompt_weighting as tlpw
from minsdtf_tpu_torch.text.tokenizer import ClipTokenizer
from minsdtf_tpu_torch.weights import convert as tconvert
from minsdtf_tpu_torch.weights import textual_inversion as tti
from torch_port_utils import (  # noqa: F401 (one_torch_thread)
    assert_same_image, load, make_pipelines, one_torch_thread, perturb_norms, write_merges,
)

MODULE_TOL = 1e-4  # as test_torch_clip.py
LONG_PROMPT = " ".join(["the (cat:1.3) dog [star]"] * 25)  # 2 LPW chunks


@pytest.fixture(scope="module")
def bpe_path(tmp_path_factory):
    return write_merges(tmp_path_factory.mktemp("bpe") / "merges.txt.gz")


@pytest.fixture(scope="module")
def pipelines(bpe_path):
    return make_pipelines(bpe_path)


def _embedding(n, seed=0):
    return np.random.RandomState(seed).normal(0, 0.02, (n, 768)).astype(np.float32)


def write_safetensors(path, tensors, metadata=None):
    """A .safetensors file of ``{key: (dtype name, raw bytes, shape)}``, written
    with struct and JSON."""
    header, blobs, offset = {}, [], 0
    if metadata is not None:
        header["__metadata__"] = metadata
    for key, (dtype, raw, shape) in tensors.items():
        header[key] = {"dtype": dtype, "shape": list(shape),
                       "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head + b"".join(blobs))
    return str(path)


def _bf16(a):
    """(raw bf16 bytes, the fp32 values they hold) of fp32 ``a``, truncated."""
    bits = (a.astype("<f4").view("<u4") >> 16).astype("<u2")
    return bits.tobytes(), (bits.astype(np.uint32) << 16).view(np.float32)


@pytest.mark.parametrize("dtype", ["F32", "F16", "BF16", "F64"])
def test_safetensors_reader_matches_written_arrays(tmp_path, dtype):
    a = np.random.RandomState(1).normal(0, 1, (3, 5, 7)).astype(np.float32)
    if dtype == "BF16":
        raw, want = _bf16(a)
    else:
        np_type = {"F32": "<f4", "F16": "<f2", "F64": "<f8"}[dtype]
        raw, want = a.astype(np_type).tobytes(), a.astype(np_type).astype(np.float32)
    ints = np.arange(6, dtype="<i8").reshape(2, 3)
    path = write_safetensors(tmp_path / "t.safetensors", {
        "a.weight": (dtype, raw, a.shape),
        "steps": ("I64", ints.tobytes(), ints.shape),
        "scalar": (dtype, raw[:len(raw) // a.size], ()),
    }, metadata={"format": "pt"})
    got = tconvert.read_state_dict(path)
    assert set(got) == {"a.weight", "steps", "scalar"}
    assert got["a.weight"].dtype == np.float32 and got["a.weight"].shape == a.shape
    np.testing.assert_array_equal(got["a.weight"], want.reshape(a.shape))
    np.testing.assert_array_equal(got["steps"], ints)
    assert got["scalar"].shape == () and got["scalar"] == want.reshape(-1)[0]


def test_safetensors_reader_rejects_broken_files(tmp_path):
    raw = np.zeros(4, "<f4").tobytes()
    path = write_safetensors(tmp_path / "bad.safetensors", {"x": ("F32", raw, (5,))})
    with pytest.raises(ValueError, match="shape"):
        tconvert.read_safetensors(path)
    path = write_safetensors(tmp_path / "odd.safetensors", {"x": ("F8_E4M3", raw, (16,))})
    with pytest.raises(ValueError, match="dtype"):
        tconvert.read_safetensors(path)
    (tmp_path / "short.safetensors").write_bytes(b"\x01\x02")
    with pytest.raises(ValueError, match="short"):
        tconvert.read_safetensors(str(tmp_path / "short.safetensors"))


def test_pt_embedding_loads_as_the_jax_loader_does(tmp_path):
    """An A1111-style .pt through ``torch.save``: the first fp32 or fp16 tensor of
    ``string_to_param``, as fp32; a state dict nested under ``state_dict``."""
    emb = torch.from_numpy(_embedding(2)).half()
    path = str(tmp_path / "ti.pt")
    torch.save({"string_to_token": {"*": 265}, "string_to_param": {"*": emb}, "step": 500}, path)
    got = tti.load_embedding(path)
    assert got.dtype == np.float32 and got.shape == (2, 768)
    np.testing.assert_array_equal(got, emb.float().numpy())
    np.testing.assert_array_equal(got, jti.load_embedding(path))
    torch.save({"state_dict": {"w": emb, "n": torch.tensor(3)}}, tmp_path / "sd.pt")
    sd = tconvert.read_state_dict(str(tmp_path / "sd.pt"))
    np.testing.assert_array_equal(sd["w"], emb.float().numpy())
    assert sd["n"] == 3 and sd["n"].dtype == np.int64
    assert tti.load_embedding(str(tmp_path / "missing.pt")) is None


class _Pickled:
    """Not on the safe unpickler's list: loads only with full unpickling."""


def test_pt_needs_the_unsafe_pickle_opt_in(tmp_path, monkeypatch):
    path = str(tmp_path / "unsafe.pt")
    torch.save({"string_to_param": {"*": torch.ones(1, 768)}, "extra": _Pickled()}, path,
               pickle_module=pickle)
    monkeypatch.delenv("MINSDTF_UNSAFE_PICKLE", raising=False)
    with pytest.raises(IOError, match="MINSDTF_UNSAFE_PICKLE"):
        tti.load_embedding(path)
    monkeypatch.setenv("MINSDTF_UNSAFE_PICKLE", "1")
    np.testing.assert_array_equal(tti.load_embedding(path), np.ones((1, 768), np.float32))


@pytest.mark.parametrize("key", ["emb_params", "string_to_param", "only_tensor"])
def test_safetensors_embedding_matches_jax_loader(tmp_path, key):
    emb = _embedding(3)
    path = write_safetensors(tmp_path / "ti.safetensors", {key: ("F32", emb.tobytes(), emb.shape)})
    np.testing.assert_array_equal(tti.load_embedding(path), emb)
    np.testing.assert_array_equal(tti.load_embedding(path), jti.load_embedding(path))


@pytest.mark.parametrize("prompt,splice_n", [("hello world", 1), (LONG_PROMPT, 3)])
def test_fused_lpw_encode_splice_matches_jax(bpe_path, prompt, splice_n):
    """Batch 2 (two prompts), the splice over positions 1..n of chunk 0 of each
    prompt row; the unconditional row is left as it is."""
    params = perturb_norms(jclip.init_params(jax.random.PRNGKey(1)), 3)
    model = load(tclip.CLIPTextModel(), params)
    emb = _embedding(splice_n, seed=splice_n)
    prompts = [prompt, "the cat"]

    def jfused(tokens, weights, embedding, n, no_boseos_middle):
        return jclip.fused_lpw_encode(
            params, jnp.asarray(tokens, jnp.int32), jnp.asarray(weights), jnp.asarray(embedding),
            m=(tokens.shape[1] - 2) // 75, splice_n=int(n), with_uncond=True,
            no_boseos_middle=no_boseos_middle, weighted=True, clip_skip=-1,
            bos=49406, eot=49407)

    def tfused(tokens, weights, embedding, n, no_boseos_middle):
        with torch.inference_mode():
            return tclip.fused_lpw_encode(
                model, torch.from_numpy(tokens), torch.from_numpy(weights),
                torch.from_numpy(embedding), m=(tokens.shape[1] - 2) // 75, splice_n=int(n),
                with_uncond=True, no_boseos_middle=no_boseos_middle, clip_skip=-1,
                bos=49406, eot=49407)

    kw = dict(embedding=emb[None], embedding_tokens_count=splice_n)
    j_ctx, j_unc = jlpw.get_weighted_text_embeddings(
        JaxTokenizer(bpe_path), None, None, prompts, fused_fn=jfused, **kw)
    t_ctx, t_unc = tlpw.get_weighted_text_embeddings(ClipTokenizer(bpe_path), tfused, prompts, **kw)
    assert t_ctx.shape == j_ctx.shape == (2, 77 if prompt == "hello world" else 154, 768)
    np.testing.assert_allclose(t_ctx.numpy(), np.asarray(j_ctx), rtol=MODULE_TOL, atol=MODULE_TOL)
    np.testing.assert_allclose(t_unc.numpy(), np.asarray(j_unc), rtol=MODULE_TOL, atol=MODULE_TOL)
    with torch.inference_mode():
        plain = tclip.encode_tokens(model, torch.from_numpy(tclip.uncond_tokens()))
    np.testing.assert_allclose(t_unc.numpy(), plain.numpy(), rtol=MODULE_TOL, atol=MODULE_TOL)


@pytest.mark.parametrize("form", ["pt_path", "safetensors_path", "array", "list"])
def test_encode_text_embedding_data_matches_jax(pipelines, tmp_path, form):
    jpipe, pipe = pipelines
    emb = _embedding(2, seed=5)
    if form == "pt_path":
        data = str(tmp_path / "ti.pt")
        torch.save({"string_to_param": {"*": torch.from_numpy(emb)}}, data)
    elif form == "safetensors_path":
        data = write_safetensors(tmp_path / "ti.safetensors",
                                 {"emb_params": ("F32", emb.tobytes(), emb.shape)})
    elif form == "array":
        data = emb
    else:
        data = [emb[:1], write_safetensors(tmp_path / "one.safetensors",
                                           {"emb_params": ("F32", emb[1:].tobytes(), (1, 768))})]
    want = jpipe.encode_text("hello world", embedding_data=data)
    got = pipe.encode_text("hello world", embedding_data=data)
    assert got.shape == want.shape == (1, 77, 768)
    np.testing.assert_allclose(got, want, rtol=MODULE_TOL, atol=MODULE_TOL)
    assert np.abs(got - pipe.encode_text("hello world")).max() > 1e-3
    with pytest.raises(ValueError, match="failed to load"):
        pipe.encode_text("hello world", embedding_data=str(tmp_path / "missing.pt"))


@pytest.mark.parametrize("negative_prompt", [None, "the dog"])
def test_negative_embedding_matches_jax_pipeline(pipelines, tmp_path, negative_prompt):
    """A .pt negative embedding, encoded with ``negative_prompt or ""``, and a TI
    embedding on the prompt, through ``generate_image``."""
    jpipe, pipe = pipelines
    neg = str(tmp_path / "neg.pt")
    torch.save({"string_to_param": {"*": torch.from_numpy(_embedding(3, seed=7))}}, neg)
    emb = _embedding(2, seed=8)
    kw = dict(num_steps=3, seed=7, negative_prompt=negative_prompt, negative_embedding=neg,
              return_latent=True)
    want = jpipe.generate_image(jpipe.encode_text("hello world", embedding_data=emb), **kw)
    with torch.backends.mkldnn.flags(enabled=False):
        got = pipe.generate_image(pipe.encode_text("hello world", embedding_data=emb), **kw)
    assert_same_image(got, want)
    kw.pop("negative_embedding")
    with torch.backends.mkldnn.flags(enabled=False):
        plain = pipe.generate_image(pipe.encode_text("hello world", embedding_data=emb), **kw)
    assert np.abs(plain[1] - got[1]).max() > 1e-3  # the negative embedding counts
