"""The port's host modules (tokenizer, prompt weighting, schedule, Philox noise)
and the JAX -> torch weight conversion, against the JAX package."""

import dataclasses

import jax
import numpy as np
import pytest

from minsdtf_tpu import rng as jrng
from minsdtf_tpu import scheduler as jsched
from minsdtf_tpu.models import unet as junet
from minsdtf_tpu.models import vae as jvae
from minsdtf_tpu.text import prompt_weighting as jlpw
from minsdtf_tpu.text import tokenizer as jtok
from minsdtf_tpu_torch import rng as trng
from minsdtf_tpu_torch import scheduler as tsched
from minsdtf_tpu_torch.models import unet as tunet
from minsdtf_tpu_torch.models import vae as tvae
from minsdtf_tpu_torch.text import prompt_weighting as tlpw
from minsdtf_tpu_torch.text import tokenizer as ttok
from minsdtf_tpu_torch.weights.from_jax import from_jax
from torch_port_utils import JAX_SCHEDULERS, one_torch_thread, write_merges  # noqa: F401

SMALL = dict(widths=(32, 64, 128, 128), temb_dim=128)


@pytest.fixture(scope="module")
def bpe_path(tmp_path_factory):
    return write_merges(tmp_path_factory.mktemp("bpe") / "merges.txt.gz")


PROMPTS = [
    "hello world",
    "a photo of an astronaut riding a horse",
    "Café naïve façade, Ελληνικά and 日本語",
    "h2o 12345 4.5kg 1/2 ½ ²",
    "hello,world!!! it's the cat's (dog:1.3) [star] <|endoftext|> x",
    "  tabs\tand\nnewlines &amp; &lt;html&gt;  ",
    "don't WE'RE they've I'm you'll he'd",
    "",
]


@pytest.mark.parametrize("prompt", PROMPTS)
def test_tokenizer_ids_match(bpe_path, prompt):
    want = jtok.ClipTokenizer(bpe_path).encode(prompt)
    tok = ttok.ClipTokenizer(bpe_path)
    assert tok.encode(prompt) == want
    assert tok.decode(want) == jtok.ClipTokenizer(bpe_path).decode(want)


def test_tokenizer_added_tokens_match(bpe_path):
    j, t = jtok.ClipTokenizer(bpe_path), ttok.ClipTokenizer(bpe_path)
    assert j.add_tokens(["<Cat-Toy>", "hello"]) == t.add_tokens(["<Cat-Toy>", "hello"])
    prompt = "a <cat-toy> on hello<cat-toy>!"
    assert t.encode(prompt) == j.encode(prompt)


@pytest.mark.parametrize("prompt", ["(cat:1.3) [world] the ((dog))", "\\(x\\) (a [b] c:0.5"])
def test_prompt_weighting_matches(bpe_path, prompt):
    assert tlpw.parse_prompt_attention(prompt) == jlpw.parse_prompt_attention(prompt)
    j, t = jtok.ClipTokenizer(bpe_path), ttok.ClipTokenizer(bpe_path)
    assert tlpw.tokenize_weighted(t, [prompt], 75) == jlpw.tokenize_weighted(j, [prompt], 75)
    for middle in (True, False):
        args = lambda: (*jlpw.tokenize_weighted(j, [prompt] * 2, 150), 152, 49406, 49407, 49407)
        assert (tlpw.pad_tokens_and_weights(*args(), no_boseos_middle=middle)
                == jlpw.pad_tokens_and_weights(*args(), no_boseos_middle=middle))


@pytest.mark.parametrize("num_steps,strength,eta", [(25, None, 0.3), (3, None, 0.3),
                                                    (10, 0.6, 0.0)])
@pytest.mark.parametrize("mode", [pytest.param("ddim", id="False"),
                                  pytest.param("tcd", id="True"),
                                  "lcm", "dpm", "dpm_karras", "euler_a"])
def test_schedule_rows_equal(num_steps, strength, eta, mode):
    """Every row of every mode, bit for bit; the ids False and True are DDIM and
    TCD, from when the test took ``active_tcd``."""
    j = jsched.build_denoise_schedule(JAX_SCHEDULERS[mode](), num_steps,
                                      strength=strength, eta=eta)
    t = tsched.build_denoise_schedule(tsched.make_scheduler(mode), num_steps,
                                      strength=strength, eta=eta)
    np.testing.assert_array_equal(t.timesteps, j.timesteps)
    assert set(tsched.ROW_KEYS) == {f.name for f in dataclasses.fields(j)} - {
        "timesteps", "active_tcd", "eta", "mode", "init_timestep"}
    for key in tsched.ROW_KEYS:
        np.testing.assert_array_equal(getattr(t, key), getattr(j, key), err_msg=key)
    assert t.init_timestep == j.init_timestep
    assert t.mode == (j.mode or mode)
    np.testing.assert_array_equal(tsched.timestep_embedding(t.timesteps),
                                  jsched.timestep_embedding(j.timesteps))
    np.testing.assert_array_equal(tsched.timestep_embedding(t.timesteps, dim=32),
                                  jsched.timestep_embedding(j.timesteps, dim=32))


def test_scheduler_step_matches():
    rs = np.random.RandomState(0)
    j, t = jsched.Scheduler(active_tcd=False), tsched.Scheduler(active_tcd=False)
    j.set_timesteps(5)
    t.set_timesteps(5)
    x = rs.normal(0, 1, (1, 4, 4, 4))
    for ts in t.timesteps:
        eps = rs.normal(0, 1, x.shape)
        want, x = j.step(eps, int(ts), x), t.step(eps, int(ts), x)
        np.testing.assert_array_equal(x, want)


@pytest.mark.parametrize("shape,seed", [((1, 64, 64, 4), 123456), ((2, 8, 8, 4), 7),
                                        ((3, 5), -5), ((1, 8, 8, 4), 2**40 + 3)])
def test_stateless_normal_bit_equal(shape, seed):
    np.testing.assert_array_equal(trng.stateless_normal(shape, seed),
                                  jrng.stateless_normal(shape, seed))


# ---- from_jax --------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_unet_params():
    return junet.init_params(jax.random.PRNGKey(0), scale=0.04, **SMALL)


@pytest.mark.parametrize("params_fused", [False, True])
@pytest.mark.parametrize("module_fused", [False, True])
def test_from_jax_unet_every_key(jax_unet_params, params_fused, module_fused):
    params = jax_unet_params
    if params_fused:
        params = junet.fuse_attention_projections(params)
    module = tunet.UNet(**SMALL)
    if module_fused:
        tunet.fuse_attention_projections(module)
    state = from_jax(params, module)
    module.load_state_dict(state)
    assert set(state) == set(module.state_dict())
    # every JAX leaf lands in the right place, in the right direction
    base = jax_unet_params
    conv = base["down_blocks.1.resnets.0.conv1"]["kernel"]  # HWIO
    np.testing.assert_array_equal(
        module.down_blocks[1].resnets[0].conv1.weight.detach().numpy(), conv.transpose(3, 2, 0, 1))
    lin = base["time_embedding.linear_1"]["kernel"]  # (in, out)
    np.testing.assert_array_equal(module.time_embedding.linear_1.weight.detach().numpy(), lin.T)
    attn = module.down_blocks[0].attentions[0].transformer_blocks[0].attn1
    q = base["down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q"]["kernel"]
    got_q = attn.to_qkv.weight[: q.shape[1]] if module_fused else attn.to_q.weight
    np.testing.assert_array_equal(got_q.detach().numpy(), q.T)
    n = sum(int(np.prod(v.shape)) for leaves in params.values() for v in leaves.values())
    assert n == sum(p.numel() for p in module.parameters())


def test_from_jax_norm_and_shapes_match_specs():
    jspecs = jvae.param_specs(dec_widths=(64, 64, 32, 32))
    dec = {k: v for k, v in jspecs.items() if not k.startswith("encoder.") and k != "quant_conv"}
    tspecs = tvae.decoder_param_specs(dec_widths=(64, 64, 32, 32))
    assert len(tspecs) == sum(len(v) for v in dec.values())
    shape = tspecs["decoder.up_blocks.1.upsamplers.0.conv.weight"]
    h, w, i, o = dec["decoder.up_blocks.1.upsamplers.0.conv"]["kernel"]
    assert shape == (o, i, h, w)
    assert tspecs["decoder.mid_block.attentions.0.group_norm.weight"] == (64,)
    j = junet.param_specs(**SMALL)
    assert len(tunet.param_specs(**SMALL)) == sum(len(v) for v in j.values())


def test_from_jax_rejects_leftover_and_missing_keys(jax_unet_params):
    module = tunet.UNet(**SMALL)
    extra = dict(jax_unet_params)
    extra["not_a_module"] = {"bias": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="left over"):
        from_jax(extra, module)
    missing = dict(jax_unet_params)
    del missing["conv_out"]
    with pytest.raises(ValueError, match="missing"):
        from_jax(missing, module)
    wrong = dict(jax_unet_params)
    wrong["conv_in"] = {"kernel": np.zeros((3, 3, 4, 7), np.float32),
                        "bias": np.zeros(7, np.float32)}
    with pytest.raises(ValueError, match="shape"):
        from_jax(wrong, module)
