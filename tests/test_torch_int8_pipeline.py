"""The port's int8 pipelines against the JAX package's, fp32 on the CPU at 64 px:
``weight_dtype="int8"`` txt2img, the ControlNet's int8 sites, what raises, and a
LoRA switch on an int8 pipeline (``"int8_hybrid"`` after ``calibrate_int8`` is in
``test_torch_int8_hybrid.py``). Both pipelines build their UNet through their own
``unet`` property from the same small fp32 params
(``torch_port_utils.int8_pipelines``), and the port's int8 roundings are held to
the JAX package's (``Int8Replay``)."""

import functools

import jax
import numpy as np
import pytest
import torch

import oracle_utils
from minsdtf_tpu.models import controlnet as jcontrolnet
from minsdtf_tpu.models import unet as junet
from minsdtf_tpu.weights import quantize as jquantize
from minsdtf_tpu_torch import StableDiffusion
from minsdtf_tpu_torch.models import clip as tclip
from minsdtf_tpu_torch.models import controlnet as tcontrolnet
from minsdtf_tpu_torch.models import unet as tunet
from minsdtf_tpu_torch.weights import calibrate as tcalibrate
from minsdtf_tpu_torch.weights import convert as tconvert
from minsdtf_tpu_torch.weights import quantize as tquantize
from minsdtf_tpu_torch.weights.from_jax import from_jax, install_int8_sites
from torch_port_utils import (  # noqa: F401
    UNET, assert_int8_image, assert_same_int8_sites, int8_pipelines, int8_txt2img_pair, load,
    make_pipelines, one_torch_thread, tmp_path, write_merges,
)



@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return make_pipelines(write_merges(tmp_path_factory.mktemp("bpe") / "merges.txt.gz"))


def test_int8_txt2img_matches_jax(base, monkeypatch):
    j, t = int8_pipelines(base, monkeypatch, "int8")
    assert_same_int8_sites(t.unet, j.unet_params)
    got, want, replay = int8_txt2img_pair(j, t)
    assert len(replay.tape) == 3 * len(tquantize.int8_sites(t.unet))
    assert_int8_image(got, want)


def test_int8_latent_turns_on_rounding_ties(base, monkeypatch):
    """Why the int8 comparisons replay the reference's roundings: a 1e-6 relative
    change of the context, far below the two packages' fp32 differences, moves
    the int8 latent by orders of magnitude more than the fp32 latent (a tie
    decided the other way shifts every later int8 site's inputs by about a step,
    and those flip more ties). Prints the two changes."""
    _, t8 = int8_pipelines(base, monkeypatch, "int8")
    _, t32 = int8_pipelines(base, monkeypatch, None)
    moved = {}
    for name, pipe in (("int8", t8), ("fp32", t32)):
        context = pipe.encode_text("hello world")
        kw = dict(num_steps=3, seed=7, unconditional_guidance_scale=7.5, guidance_rescale=0.7,
                  return_latent=True)
        _, latent = pipe.generate_image(context, **kw)
        _, nudged = pipe.generate_image(context * np.float32(1 + 1e-6), **kw)
        moved[name] = float(np.abs(latent - nudged).max())
    print(f"latent moved by a 1e-6 change of the context: {moved}")
    assert moved["fp32"] < 1e-3 < 1e-2 < moved["int8"]


def test_controlnet_is_quantized_under_int8(monkeypatch):
    """A ControlNet from ``controlnet_path`` under "int8": the JAX pipeline
    quantizes its unfused projections, the port its fused ones; per-output-channel
    weight scales make the fused sites the JAX package's sites concatenated."""
    params = jcontrolnet.init_params(jax.random.PRNGKey(3), scale=0.04, **UNET)
    jq = jquantize.quantize_params(params)
    want = tunet.fuse_attention_projections(tcontrolnet.ControlNet(**UNET))
    want = load(install_int8_sites(jq, want), jq).state_dict()
    state = from_jax(params, tcontrolnet.ControlNet(**UNET))
    monkeypatch.setattr(tcontrolnet, "ControlNet", functools.partial(tcontrolnet.ControlNet,
                                                                      **UNET))
    for weight_dtype in ("int8", "int8_hybrid", None):
        pipe = StableDiffusion(64, 64, controlnet_path="controlnet.safetensors", device="cpu",
                               compute_dtype=torch.float32, weight_dtype=weight_dtype)
        monkeypatch.setattr(pipe, "_checkpoint", lambda path, kind, lora=None: state)
        sites = tquantize.int8_sites(pipe.controlnet)
        if weight_dtype == "int8":
            assert "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_qkv" in sites
            got = pipe.controlnet.state_dict()
            assert sorted(got) == sorted(want)
            for key in want:
                assert torch.equal(got[key], want[key]), key
        else:  # the JAX pipeline quantizes its ControlNet under "int8" only
            assert not sites


def test_weight_dtype_and_calibration_are_checked():
    with pytest.raises(ValueError, match="weight_dtype"):
        StableDiffusion(weight_dtype="fp4", device="cpu")
    with pytest.raises(ValueError, match="calibrate_int8 requires"):
        StableDiffusion(64, 64, device="cpu").calibrate_int8()


LORA = {  # kohya name: (out, in, kernel or None for a linear layer), all int8 sites
    "lora_unet_down_blocks_1_resnets_0_conv1": (64, 320, (3, 3)),
    "lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_attn1_to_q": (320, 320, None),
    "lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_ff_net_2": (320, 1280, None),
}


def write_unet_lora(path) -> str:
    rng = np.random.RandomState(0)
    sd = {}
    for name, (out_c, in_c, kernel) in LORA.items():
        down_shape = (4, in_c) + (kernel or ())
        up_shape = (out_c, 4) + ((1, 1) if kernel else ())
        sd[f"{name}.lora_down.weight"] = torch.from_numpy(
            rng.normal(0, 0.1, down_shape).astype(np.float32))
        sd[f"{name}.lora_up.weight"] = torch.from_numpy(
            rng.normal(0, 0.1, up_shape).astype(np.float32))
        sd[f"{name}.alpha"] = torch.tensor(2.0)
    torch.save(sd, path)
    return str(path)


class SmallUNet(tunet.UNet):
    """The pipelines' small UNet as the default of the UNet class, for the
    checkpoint converter and the pipeline's ``unet`` property."""

    def __init__(self, widths=UNET["widths"], temb_dim=UNET["temb_dim"], **kw):
        super().__init__(widths, temb_dim, **kw)


def test_lora_switch_on_an_int8_pipeline(tmp_path, monkeypatch):
    """``set_lora`` rebuilds the int8 UNet from the fp32 checkpoint with the deltas
    merged: it equals an int8 pipeline made with that LoRA, and, as in the JAX
    pipeline, the scales of an earlier ``calibrate_int8`` are gone."""
    sd = oracle_utils.synth_state_dict(junet.param_specs(**UNET), np.random.RandomState(2),
                                       dtype=np.float32)
    ckpt = oracle_utils.save_safetensors(sd, str(tmp_path / "unet.safetensors"))
    lora = write_unet_lora(tmp_path / "lora.pt")
    monkeypatch.setitem(tconvert.CONVERTERS, "unet",
                        functools.partial(tconvert.convert_unet, **UNET))
    monkeypatch.setattr(tunet, "UNet", SmallUNet)
    monkeypatch.setenv("MINSDTF_NO_CACHE", "1")
    text_model = tclip.init("cpu", seed=1)
    kw = dict(unet_ckpt=ckpt, device="cpu", compute_dtype=torch.float32, weight_dtype="int8")
    switched = StableDiffusion(64, 64, **kw)
    switched._text_model = text_model
    stats = switched.calibrate_int8(num_steps=2, seeds=(0,))
    assert any(s.act_scale is not None for s in tquantize.int8_sites(switched.unet).values())
    switched.set_lora(lora)
    built = StableDiffusion(64, 64, lora_path=lora, **kw)
    got, want = switched.unet.state_dict(), built.unet.state_dict()
    assert sorted(got) == sorted(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    sites = tquantize.int8_sites(switched.unet)
    assert all(s.act_scale is None for s in sites.values())
    plain = StableDiffusion(64, 64, **kw).unet.state_dict()
    changed = {k.rpartition(".")[0] for k in want if not torch.equal(want[k], plain[k])}
    assert changed == {"down_blocks.1.resnets.0.conv1",
                       "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_qkv",
                       "down_blocks.0.attentions.0.transformer_blocks.0.ff.net.2"}
    # scales passed at construction survive the switch
    baked = StableDiffusion(64, 64, int8_act_scales=stats, **kw)
    baked.set_lora(lora)
    want_baked = tcalibrate.bake_act_scales(built.unet, stats)
    for name, site in tquantize.int8_sites(baked.unet).items():
        assert torch.equal(site.weight_q, want_baked.get_submodule(name).weight_q)
        if site.act_scale is not None or want_baked.get_submodule(name).act_scale is not None:
            assert torch.equal(site.act_scale, want_baked.get_submodule(name).act_scale), name
