"""Checkpoint and LoRA loading through the port's pipeline against the JAX pipeline:
a full-width CLIP checkpoint (fp16 ``.safetensors``) loaded by both packages in
fp32 on the CPU, the contexts after each ``set_lora``, the reference-compatible
text handles, fetching through ``weights.fetch``, and what raises."""

import shutil
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle_utils
from minsdtf_tpu.pipeline import StableDiffusion as JaxStableDiffusion
from minsdtf_tpu.weights import convert as jconvert
from minsdtf_tpu_torch import StableDiffusion
from torch_port_utils import (  # noqa: F401 (fixtures)
    one_torch_thread, tmp_path, write_clip_lora, write_merges,
)

TOL = 1e-5
Q_PROJ = "text_model.encoder.layers.0.self_attn.q_proj"
PROMPT = "hello world"


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(CLIP checkpoint, merges file) in a directory of their own."""
    directory = tmp_path_factory.mktemp("ckpt")
    sd = oracle_utils.synth_state_dict(jconvert._text_encoder_specs(), np.random.RandomState(0))
    te = oracle_utils.save_safetensors(sd, str(directory / "te.safetensors"))
    yield te, write_merges(directory / "merges.txt.gz")
    shutil.rmtree(directory)  # the checkpoint and its converted caches


@pytest.fixture(scope="module")
def pipelines(files):
    te, bpe = files
    jpipe = JaxStableDiffusion(64, 64, text_encoder_ckpt=te, compute_dtype=jnp.float32,
                               bpe_path=bpe)
    pipe = StableDiffusion(64, 64, text_encoder_ckpt=te, compute_dtype=torch.float32,
                           device="cpu", bpe_path=bpe)
    return jpipe, pipe


def _context_pair(pipelines, prompt=PROMPT):
    jpipe, pipe = pipelines
    return pipe.encode_text(prompt), jpipe.encode_text(prompt)


def test_encode_text_matches_jax(pipelines):
    got, want = _context_pair(pipelines)
    assert got.shape == want.shape == (1, 77, 768)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(pipelines[1]._unconditional_context().numpy(),
                               pipelines[0]._unconditional_context(), rtol=TOL, atol=TOL)


def test_text_handles_match_jax(pipelines):
    jpipe, pipe = pipelines
    tokens = np.array([[49406, 320, 1125] + [49407] * 74], np.int32)
    positions = np.arange(77, dtype=np.int32)[None]
    emb = pipe.text_clip_embedding.predict_on_batch([tokens, positions])
    want_emb = jpipe.text_clip_embedding.predict_on_batch([tokens, positions])
    assert emb.shape == (1, 77, 768) and emb.dtype == np.float32
    np.testing.assert_allclose(emb, want_emb, rtol=TOL, atol=TOL)
    ctx = pipe.text_encoder(emb)
    np.testing.assert_allclose(ctx, jpipe.text_encoder.predict_on_batch(want_emb),
                               rtol=TOL, atol=TOL)
    uncond = pipe.text_encoder.predict_on_batch(pipe.text_clip_embedding(
        [np.array([[49406] + [49407] * 76]), np.arange(77)]))
    np.testing.assert_allclose(uncond, pipe._unconditional_context().numpy(), rtol=TOL, atol=TOL)


def test_runtime_lora_switch(pipelines, tmp_path):
    """set_lora merges, rescales and removes the deltas against the cached base
    checkpoint; the contexts follow the JAX pipeline's."""
    jpipe, pipe = pipelines
    lora_path, delta = write_clip_lora(tmp_path / "lora.pt")
    base = pipe.text_model.get_submodule(Q_PROJ).weight.detach().clone()
    for scale in (1.0, 0.5, None):
        for p in (jpipe, pipe):
            p.set_lora(None if scale is None else lora_path, **({} if scale is None
                                                                else {"scale": scale}))
        # the JAX pipeline keeps a prompt's context across set_lora (its prompt cache
        # is keyed on the prompt alone), so its cache is emptied here
        jpipe._prompt_dev_cache.clear()
        weight = pipe.text_model.get_submodule(Q_PROJ).weight.detach()
        want_delta = 0 if scale is None else scale * delta
        np.testing.assert_allclose((weight - base).numpy(), want_delta, rtol=1e-4, atol=1e-6)
        got, want = _context_pair(pipelines)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(pipe._unconditional_context().numpy(),
                                   jpipe._unconditional_context(), rtol=TOL, atol=TOL)
    assert torch.equal(pipe.text_model.get_submodule(Q_PROJ).weight, base)


def test_lora_path_at_construction_merges(files, pipelines, tmp_path):
    te, bpe = files
    lora_path, _ = write_clip_lora(tmp_path / "lora.pt")
    pipe = StableDiffusion(64, 64, text_encoder_ckpt=te, lora_path=lora_path,
                           compute_dtype=torch.float32, device="cpu", bpe_path=bpe)
    jpipe = JaxStableDiffusion(64, 64, text_encoder_ckpt=te, lora_path=lora_path,
                               compute_dtype=jnp.float32, bpe_path=bpe)
    np.testing.assert_allclose(pipe.encode_text(PROMPT), jpipe.encode_text(PROMPT),
                               rtol=TOL, atol=TOL)
    assert np.abs(pipe.encode_text(PROMPT) - pipelines[1].encode_text(PROMPT)).max() > 1e-3


def test_file_url_resolves_through_the_fetch_cache(files, pipelines, tmp_path, monkeypatch):
    te, bpe = files
    monkeypatch.setenv("MINSDTF_CACHE", str(tmp_path / "cache"))
    pipe = StableDiffusion(64, 64, text_encoder_ckpt=f"file://{te}", compute_dtype=torch.float32,
                           device="cpu", bpe_path=bpe)
    assert not (tmp_path / "cache").exists()  # fetched at first use
    got = pipe.text_model.state_dict()
    for key, value in pipelines[1].text_model.state_dict().items():
        assert torch.equal(got[key], value), key
    assert (tmp_path / "cache" / "te.safetensors.sha256").exists()


def test_default_without_a_network_raises(tmp_path, monkeypatch):
    def no_network(*args, **kwargs):
        raise OSError("no network")

    monkeypatch.setattr(urllib.request, "urlretrieve", no_network)
    monkeypatch.setenv("MINSDTF_CACHE", str(tmp_path / "cache"))
    pipe = StableDiffusion(64, 64, unet_ckpt="default", device="cpu")
    with pytest.raises(FileNotFoundError, match="unet: cannot fetch default"):
        pipe.unet
    missing = StableDiffusion(64, 64, vae_ckpt=str(tmp_path / "missing.safetensors"), device="cpu")
    with pytest.raises(FileNotFoundError, match="vae"):
        missing.decoder


def test_missing_lora_and_lora_without_a_checkpoint_raise(files, tmp_path):
    te, _ = files
    with pytest.raises(FileNotFoundError, match="lora"):
        StableDiffusion(64, 64, text_encoder_ckpt=te, lora_path=str(tmp_path / "none.pt"),
                        device="cpu")
    lora_path, _ = write_clip_lora(tmp_path / "lora.pt")
    with pytest.raises(ValueError, match="text_encoder checkpoint"):
        StableDiffusion(64, 64, lora_path=lora_path, device="cpu")
    pipe = StableDiffusion(64, 64, device="cpu")
    with pytest.raises(ValueError, match="text_encoder checkpoint"):
        pipe.set_lora(lora_path)
    with pytest.raises(FileNotFoundError, match="lora"):
        pipe.set_lora(str(tmp_path / "none.pt"))
