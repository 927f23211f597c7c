"""The port's pipeline API around single images: ``generate_images`` (queued dispatch
with ``_defer_fetch``) against the JAX pipeline's on the same small params, fp32
on the CPU; ``warm_text``; the prompt cache (hits, eviction, textual inversion
left out, copies returned, emptied by ``set_lora``) and the schedule cache."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle_utils
from minsdtf_tpu.pipeline import StableDiffusion as JaxStableDiffusion
from minsdtf_tpu.weights import convert as jconvert
from minsdtf_tpu_torch import StableDiffusion
from minsdtf_tpu_torch import pipeline as tpipe
from torch_port_utils import (  # noqa: F401 (one_torch_thread)
    LATENT_TOL, make_pipelines, one_torch_thread, write_clip_lora, write_merges,
)

PROMPTS = ["hello world", "the cat", "a dog"]
SEEDS = [3, 4, 5]
SERVE_KW = dict(num_steps=3, unconditional_guidance_scale=7.5, guidance_rescale=0.7)


@pytest.fixture(scope="module")
def bpe_path(tmp_path_factory):
    return write_merges(tmp_path_factory.mktemp("bpe") / "merges.txt.gz")


@pytest.fixture(scope="module")
def pipelines(bpe_path):
    return make_pipelines(bpe_path)


def text_pipeline(pipe):
    """A port pipeline of its own (empty caches, no unconditional context) holding
    ``pipe``'s CLIP."""
    fresh = StableDiffusion(64, 64, bpe_path=pipe.bpe_path, compute_dtype=torch.float32,
                            device="cpu")
    fresh._text_model = pipe._text_model
    return fresh


def test_generate_images_matches_jax(pipelines):
    jpipe, pipe = pipelines
    want = jpipe.generate_images([jpipe.encode_text(p) for p in PROMPTS], seeds=SEEDS,
                                 **SERVE_KW)
    contexts = [pipe.encode_text(p) for p in PROMPTS]
    got = pipe.generate_images(contexts, seeds=SEEDS, **SERVE_KW)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape == (1, 64, 64, 3) and g.dtype == np.uint8
        assert np.abs(g.astype(int) - w.astype(int)).max() <= 1
    # the deferred handles: tensors that fetch to the same image, and a latent
    # within the tolerance of JAX's
    image, latent = pipe.generate_image(contexts[0], seed=SEEDS[0], return_latent=True,
                                        _defer_fetch=True, **SERVE_KW)
    assert isinstance(image, torch.Tensor) and isinstance(latent, torch.Tensor)
    assert np.array_equal(tpipe.fetch(image), got[0])
    _, want_latent = jpipe.generate_image(jpipe.encode_text(PROMPTS[0]), seed=SEEDS[0],
                                          return_latent=True, **SERVE_KW)
    np.testing.assert_allclose(tpipe.fetch(latent), want_latent, rtol=LATENT_TOL,
                               atol=LATENT_TOL)


def test_generate_images_dispatches_every_request_before_fetching(pipelines, monkeypatch):
    pipe = pipelines[1]
    events = []

    class Handle:
        def __init__(self, seed):
            self.seed = seed

        def __array__(self, dtype=None, copy=None):
            events.append(("fetch", self.seed))
            return np.full((1, 4, 4, 3), self.seed, np.uint8)

    def fake_generate(encoded_text, seed=None, _defer_fetch=False, **kw):
        assert _defer_fetch is True
        events.append(("dispatch", seed))
        return Handle(seed)

    monkeypatch.setattr(pipe, "generate_image", fake_generate)
    out = pipe.generate_images([0, 1, 2], seeds=[5, 6, 7], num_steps=2)
    assert events == [("dispatch", 5), ("dispatch", 6), ("dispatch", 7),
                      ("fetch", 5), ("fetch", 6), ("fetch", 7)]
    assert [int(o[0, 0, 0, 0]) for o in out] == [5, 6, 7]
    with pytest.raises(ValueError, match="callback"):
        pipe.generate_images([0], callback=lambda i: None)
    with pytest.raises(ValueError, match="images only"):
        pipe.generate_images([0], return_latent=True)


def test_warm_text_leaves_the_cache_empty_and_the_uncond_set(pipelines):
    pipe = text_pipeline(pipelines[1])
    assert pipe._uncond is None
    pipe.warm_text()
    assert pipe._prompt_cache == {}
    assert pipe._uncond is not None and tuple(pipe._uncond.shape) == (1, 77, 768)
    torch.testing.assert_close(pipe._uncond, pipelines[1]._unconditional_context(),
                               rtol=1e-5, atol=1e-5)


def test_prompt_cache(pipelines, monkeypatch):
    pipe = text_pipeline(pipelines[1])
    pipe._unconditional_context()
    calls = []
    encode = pipe._fused_text_call
    monkeypatch.setattr(pipe, "_fused_text_call", lambda *a: (calls.append(a), encode(*a))[1])
    first = pipe._encode_text_dev("hello world")
    assert pipe._encode_text_dev("hello world") is first and len(calls) == 1
    # the 9th prompt evicts the first
    prompts = ["hello world"] + [f"the cat {i}" for i in range(8)]
    for p in prompts[1:]:
        pipe._encode_text_dev(p)
    assert len(calls) == 9 and len(pipe._prompt_cache) == tpipe.PROMPT_CACHE_SIZE == 8
    pipe._encode_text_dev(prompts[-1])
    assert len(calls) == 9
    again = pipe._encode_text_dev("hello world")
    assert len(calls) == 10 and again is not first and torch.equal(again, first)
    # a textual-inversion call is not cached
    vectors = np.random.RandomState(0).normal(0, 0.02, (2, 768)).astype(np.float32)
    cached = dict(pipe._prompt_cache)
    pipe._encode_text_dev("hello world", embedding_data=vectors)
    pipe._encode_text_dev("hello world", embedding_data=vectors)
    assert len(calls) == 12 and pipe._prompt_cache == cached
    # encode_text returns a copy: writing into it leaves the cache as it was
    out = pipe.encode_text("hello world")
    want = out.copy()
    out[:] = 0.0
    assert np.array_equal(pipe.encode_text("hello world"), want) and len(calls) == 12


def test_schedule_cache(pipelines, monkeypatch):
    pipe = pipelines[1]
    pipe._schedule_cache.clear()
    builds = []
    build = tpipe.sched_lib.build_denoise_schedule
    monkeypatch.setattr(tpipe.sched_lib, "build_denoise_schedule",
                        lambda *a, **k: (builds.append(a[1:]), build(*a, **k))[1])
    context = pipe.encode_text("hello world")
    first = pipe.generate_image(context, seed=1, num_steps=2)
    assert np.array_equal(pipe.generate_image(context, seed=1, num_steps=2), first)
    assert len(builds) == 1
    pipe.generate_image(context, seed=1, num_steps=2, eta=0.5)
    assert len(builds) == 2 and len(pipe._schedule_cache) == 2
    schedule, t_embs = pipe._schedule_cache[(2, None, 0.3)]
    assert schedule.num_steps == 2 and tuple(t_embs.shape) == (2, 320)


@pytest.fixture(scope="module")
def clip_pipelines(tmp_path_factory, bpe_path):
    """The JAX and port pipelines on one full-width CLIP checkpoint file."""
    directory = tmp_path_factory.mktemp("ckpt")
    sd = oracle_utils.synth_state_dict(jconvert._text_encoder_specs(), np.random.RandomState(0))
    te = oracle_utils.save_safetensors(sd, str(directory / "te.safetensors"))
    jpipe = JaxStableDiffusion(64, 64, text_encoder_ckpt=te, compute_dtype=jnp.float32,
                               bpe_path=bpe_path)
    pipe = StableDiffusion(64, 64, text_encoder_ckpt=te, compute_dtype=torch.float32,
                           device="cpu", bpe_path=bpe_path)
    yield jpipe, pipe
    shutil.rmtree(directory)  # the checkpoint and its converted caches, 1.2 GB


def test_set_lora_empties_the_prompt_cache(clip_pipelines, tmp_path):
    """A prompt encoded before ``set_lora`` is encoded anew after it, with the new
    weights: the context follows the JAX pipeline's, whose cache (keyed on the
    prompt alone) is emptied by hand."""
    jpipe, pipe = clip_pipelines
    lora_path, _ = write_clip_lora(tmp_path / "lora.pt")
    for _ in range(2):  # the second encode is the one cached with the row set
        before = pipe.encode_text("hello world")
        jpipe.encode_text("hello world")
    assert len(pipe._prompt_cache) == 2
    for p in (jpipe, pipe):
        p.set_lora(lora_path)
    jpipe._prompt_dev_cache.clear()
    assert pipe._prompt_cache == {}
    for _ in range(2):
        got, want = pipe.encode_text("hello world"), jpipe.encode_text("hello world")
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.abs(got - before).max() > 1e-3
