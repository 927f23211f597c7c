"""The port's LoRA loader (``minsdtf_tpu_torch.weights.lora``) against the JAX
package's: a kohya file made from known factors (linear, 1x1 and 3x3 cases under
both ``lora_te_*`` and ``lora_unet_*``), the deltas, their scaling, and a small
UNet with them merged, fused q/k/v included."""

import numpy as np
import pytest
import torch
from safetensors.torch import save_file

import oracle_utils
from minsdtf_tpu.models import unet as junet
from minsdtf_tpu.weights import convert as jconvert
from minsdtf_tpu.weights import lora as jlora
from minsdtf_tpu_torch.models import unet as tunet
from minsdtf_tpu_torch.weights import convert as tconvert
from minsdtf_tpu_torch.weights import lora as tlora
from minsdtf_tpu_torch.weights.from_jax import from_jax
from torch_port_utils import one_torch_thread  # noqa: F401

SMALL = dict(widths=(32, 64, 128, 128), temb_dim=128)
RANK = 4
ATTN = "lora_unet_down_blocks_0_attentions_0"
MODULES = {  # kohya name: (out, in, kernel or None for a linear layer)
    "lora_te_text_model_encoder_layers_0_self_attn_q_proj": (768, 768, None),
    "lora_te_text_model_encoder_layers_3_mlp_fc1": (3072, 768, None),
    # a linear layer stored as 1x1 convs, as some trainers write them
    "lora_te_text_model_encoder_layers_11_self_attn_out_proj": (768, 768, (1, 1)),
    f"{ATTN}_transformer_blocks_0_attn1_to_q": (32, 32, None),
    f"{ATTN}_transformer_blocks_0_attn1_to_v": (32, 32, None),
    f"{ATTN}_transformer_blocks_0_attn2_to_k": (32, 768, None),
    f"{ATTN}_transformer_blocks_0_ff_net_0_proj": (256, 32, None),
    f"{ATTN}_proj_in": (32, 32, (1, 1)),
    "lora_unet_down_blocks_1_resnets_0_conv1": (64, 32, (3, 3)),
    "lora_unet_down_blocks_1_resnets_0_conv_shortcut": (64, 32, (1, 1)),
    "lora_unet_up_blocks_1_resnets_2_time_emb_proj": (128, 128, None),
    "lora_unet_up_blocks_0_upsamplers_0_conv": (128, 128, (3, 3)),
}


def kohya_state_dict(seed: int = 0):
    rng = np.random.RandomState(seed)

    def t(*shape):
        return torch.from_numpy(rng.normal(0, 0.1, shape).astype(np.float32))

    sd = {}
    for name, (out_c, in_c, kernel) in MODULES.items():
        if kernel is None:
            down, up = t(RANK, in_c), t(out_c, RANK)
        else:
            down, up = t(RANK, in_c, *kernel), t(out_c, RANK, 1, 1)
        sd[f"{name}.lora_down.weight"] = down
        sd[f"{name}.lora_up.weight"] = up
        sd[f"{name}.alpha"] = torch.tensor(float(RANK) / 2.0)
    return sd


@pytest.fixture(scope="module", params=["safetensors", "pt"])
def lora_path(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lora") / f"lora.{request.param}")
    if request.param == "safetensors":
        save_file(kohya_state_dict(), path)
    else:
        torch.save(kohya_state_dict(), path)
    return path


def test_deltas_equal_the_jax_loaders(lora_path):
    te, unet = tlora.load_lora(lora_path)
    jte, junet_deltas = jlora.load_lora(lora_path)
    assert len(te) == 3 and len(unet) == len(MODULES) - 3
    for got, want in ((te, jte), (unet, junet_deltas)):
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == np.float32 and got[key].shape == want[key].shape
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6)
    assert unet["down_blocks.1.resnets.0.conv1.weight"].shape == (64, 32, 3, 3)
    assert te["text_model.encoder.layers.11.self_attn.out_proj.weight"].shape == (768, 768, 1, 1)


def test_compose_and_scale_equal_the_jax_functions():
    rng = np.random.RandomState(1)
    for down, up in (((RANK, 20), (12, RANK)), ((RANK, 20, 1, 1), (12, RANK, 1, 1)),
                     ((RANK, 20, 3, 3), (12, RANK, 1, 1))):
        d, u = rng.normal(0, 0.1, down).astype(np.float32), rng.normal(0, 0.1, up).astype(np.float32)
        np.testing.assert_allclose(tlora.compose_delta(u, d, 3.0), jlora.compose_delta(u, d, 3.0),
                                   rtol=0, atol=1e-6)
    deltas = {"a.weight": rng.normal(0, 1, (3, 4)).astype(np.float32)}
    assert tlora.scale_lora(deltas, 1.0) is deltas
    for scale in (0.5, -1.25):
        got, want = tlora.scale_lora(deltas, scale), jlora.scale_lora(deltas, scale)
        np.testing.assert_array_equal(got["a.weight"], want["a.weight"])
        assert got["a.weight"].dtype == np.float32


def test_merged_unet_equals_jax_build_params(lora_path):
    sd = oracle_utils.synth_state_dict(junet.param_specs(**SMALL), np.random.RandomState(2),
                                       dtype=np.float32)
    _, unet_deltas = tlora.load_lora(lora_path)
    _, jax_deltas = jlora.load_lora(lora_path)
    with torch.device("meta"):
        skeleton = tunet.UNet(**SMALL)
    want = from_jax(jconvert._build_params(sd, junet.param_specs(**SMALL), lora=jax_deltas),
                    skeleton)
    got = tconvert.convert_unet(sd, lora=unet_deltas, **SMALL)
    base = tconvert.convert_unet(sd, **SMALL)
    assert sorted(got) == sorted(want)
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=1e-6)
    changed = {k for k in got if not torch.equal(got[k], base[k])}
    assert changed == set(unet_deltas)

    # the fused self-attention projection holds the merged q, k and v
    unet = tunet.UNet(**SMALL)
    unet.load_state_dict(got)
    tunet.fuse_attention_projections(unet)
    attn = "down_blocks.0.attentions.0.transformer_blocks.0.attn1"
    fused = unet.get_submodule(attn).to_qkv.weight
    torch.testing.assert_close(fused, torch.cat([want[f"{attn}.to_{n}.weight"] for n in "qkv"]),
                               rtol=0, atol=1e-6)
