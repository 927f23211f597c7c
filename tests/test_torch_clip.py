"""The port's CLIP text stack against the JAX package at full width, fp32 on the
CPU. Norm params are perturbed away from (scale=1, bias=0): with the degenerate
init the encoder output mean is ~1e-10 and the LPW mean-preserving rescale divides
two near-zero numbers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minsdtf_tpu.models import clip as jclip
from minsdtf_tpu.text import prompt_weighting as jlpw
from minsdtf_tpu.text.tokenizer import ClipTokenizer as JaxTokenizer
from minsdtf_tpu_torch.models import clip as tclip
from minsdtf_tpu_torch.text import prompt_weighting as tlpw
from minsdtf_tpu_torch.text.tokenizer import ClipTokenizer
from torch_port_utils import load, one_torch_thread, perturb_norms, write_merges  # noqa: F401

MODULE_TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    params = perturb_norms(jclip.init_params(jax.random.PRNGKey(1)), 3)
    return params, load(tclip.CLIPTextModel(), params)


@pytest.fixture(scope="module")
def bpe_path(tmp_path_factory):
    return write_merges(tmp_path_factory.mktemp("bpe") / "merges.txt.gz")


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=MODULE_TOL, atol=MODULE_TOL)


def _tokens(seed, b=2):
    rs = np.random.RandomState(seed)
    t = rs.randint(0, 49406, (b, 77))
    t[:, 0], t[:, -1] = 49406, 49407
    return t


def test_clip_embedding(models):
    params, model = models
    tokens = _tokens(0)
    pos = np.broadcast_to(np.arange(77), tokens.shape)
    want = jclip.clip_embedding(params, jnp.asarray(tokens), jnp.asarray(pos))
    with torch.inference_mode():
        got = tclip.clip_embedding(model, torch.from_numpy(tokens), torch.from_numpy(pos.copy()))
    _close(got, want)


@pytest.mark.parametrize("clip_skip", [-1, -2])
def test_text_encoder(models, clip_skip):
    params, model = models
    tokens = _tokens(1)
    want = jclip.encode_tokens(params, jnp.asarray(tokens), clip_skip=clip_skip)
    with torch.inference_mode():
        got = tclip.encode_tokens(model, torch.from_numpy(tokens), clip_skip=clip_skip)
    _close(got, want)


@pytest.mark.parametrize("prompt,clip_skip", [
    ("hello world", -1),
    ("(cat:1.3) the [dog] star", -1),
    ("(cat:1.3) the [dog] star", -2),
    (" ".join(["the cat dog star"] * 25), -1),   # 2 LPW chunks
])
def test_fused_lpw_encode_with_uncond(models, bpe_path, prompt, clip_skip):
    params, model = models
    jtok, ttok = JaxTokenizer(bpe_path), ClipTokenizer(bpe_path)

    def jfused(tokens, weights, embedding, splice_n, no_boseos_middle):
        return jclip.fused_lpw_encode(
            params, jnp.asarray(tokens, jnp.int32),
            None if weights is None else jnp.asarray(weights), None,
            m=(tokens.shape[1] - 2) // 75, splice_n=0, with_uncond=True,
            no_boseos_middle=no_boseos_middle, weighted=weights is not None,
            clip_skip=clip_skip, bos=49406, eot=49407)

    def tfused(tokens, weights, embedding, splice_n, no_boseos_middle):
        with torch.inference_mode():
            return tclip.fused_lpw_encode(
                model, torch.from_numpy(tokens),
                None if weights is None else torch.from_numpy(weights),
                m=(tokens.shape[1] - 2) // 75, with_uncond=True,
                no_boseos_middle=no_boseos_middle, clip_skip=clip_skip, bos=49406, eot=49407)

    j_ctx, j_unc = jlpw.get_weighted_text_embeddings(jtok, None, None, prompt, fused_fn=jfused)
    t_ctx, t_unc = tlpw.get_weighted_text_embeddings(ttok, tfused, prompt)
    assert t_ctx.shape == j_ctx.shape
    _close(t_ctx, j_ctx)
    _close(t_unc, j_unc)
    # the uncond row equals a plain encode of [BOS] + [EOT]*76
    with torch.inference_mode():
        plain = tclip.encode_tokens(model, torch.from_numpy(tclip.uncond_tokens()), clip_skip)
    _close(t_unc, plain.numpy())
