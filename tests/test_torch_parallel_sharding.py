"""The port's TP rules (``minsdtf_tpu_torch/parallel/sharding.py``) against the JAX
package's (``minsdtf_tpu/parallel/sharding.py``), in one process: ``param_spec``
name for name over every UNet, CLIP, VAE and ControlNet param, and each rank's
slice of each matched weight against the JAX package's shard of it on a (4, 2)
mesh of the conftest's virtual devices (GEGLU's projection excepted, whose
slice takes row r of both halves: the port's deliberate layout, checked against
the whole weight). The multi-rank runs are in the other
``test_torch_parallel_*.py`` files."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from minsdtf_tpu.models import clip as jclip
from minsdtf_tpu.models import controlnet as jcontrolnet
from minsdtf_tpu.models import unet as junet
from minsdtf_tpu.models import vae as jvae
from minsdtf_tpu.parallel import mesh as jmesh
from minsdtf_tpu.parallel import sharding as jsharding
from minsdtf_tpu_torch.models import clip as tclip
from minsdtf_tpu_torch.models import controlnet as tcontrolnet
from minsdtf_tpu_torch.models import unet as tunet
from minsdtf_tpu_torch.models import vae as tvae
from minsdtf_tpu_torch.parallel import sharding as tsharding
from minsdtf_tpu_torch.weights.from_jax import from_jax, split_vae
from torch_port_utils import one_torch_thread  # noqa: F401

SMALL = dict(widths=(32, 64, 128, 128), temb_dim=128)
VAE = dict(enc_widths=(32, 32, 64, 64), dec_widths=(64, 64, 32, 32))


@pytest.fixture(scope="module")
def jax_params():
    key = jax.random.PRNGKey(0)
    return {
        "unet": junet.init_params(key, jnp.float32, scale=0.04, **SMALL),
        "clip": jclip.init_params(key),
        "vae": jvae.init_params(key, **VAE),
        "controlnet": jcontrolnet.init_params(key, scale=0.04, **SMALL),
    }


def test_the_rule_tables_are_the_jax_packages():
    assert tsharding._COLUMN_SUFFIXES == jsharding._COLUMN_SUFFIXES
    assert tsharding._ROW_SUFFIXES == jsharding._ROW_SUFFIXES


@pytest.mark.parametrize("model", ["unet", "clip", "vae", "controlnet"])
def test_param_spec_equals_jax_for_every_param(jax_params, model):
    specs = {}
    for module, leaves in jax_params[model].items():
        for leaf, value in leaves.items():
            want = tuple(jsharding.param_spec(module, leaf, np.ndim(value)))
            assert tsharding.param_spec(module, leaf, np.ndim(value)) == want, (module, leaf)
            specs[want] = specs.get(want, 0) + 1
    if model != "vae":
        assert set(specs) == {(), (None, "model"), ("model", None), ("model",)}, specs


def port_module(model: str, params):
    """The port's unfused module for ``model`` holding ``params``."""
    if model == "vae":
        module, params = tvae.VAEDecoder(VAE["dec_widths"]), split_vae(params)[1]
    else:
        module = {"unet": lambda: tunet.UNet(**SMALL), "clip": tclip.CLIPTextModel,
                  "controlnet": lambda: tcontrolnet.ControlNet(**SMALL)}[model]()
    module.load_state_dict(from_jax(params, module))
    return module


def jax_shard(array, model_rank: int) -> np.ndarray:
    """The shard of ``array`` (placed on the (4, 2) mesh) that devices of model
    rank ``model_rank`` hold."""
    devices = np.asarray(jax.devices()).reshape(4, 2)[:, model_rank]
    shard = next(s for s in array.addressable_shards if s.device in devices)
    return np.asarray(shard.data)


@pytest.mark.parametrize("model", ["unet", "clip", "controlnet"])
def test_each_rank_holds_the_jax_shard_of_each_matched_weight(jax_params, model):
    params = jax_params[model]
    placed = jsharding.shard_params(params, jmesh.make_mesh(data=4, model=2))
    whole = port_module(model, params).state_dict()
    checked = {"column": 0, "row": 0, "geglu": 0}
    for rank in range(2):
        local = tsharding.tp_shard(port_module(model, params), rank, 2, group=None)
        for name, m in local.named_modules():
            if not isinstance(m, tsharding.ParallelLinear):
                continue
            for leaf, jleaf in (("weight", "kernel"), ("bias", "bias")):
                got = getattr(m, leaf)
                if got is None:
                    continue
                key = f"{name}.{leaf}"
                want = jax_shard(placed[name][jleaf], rank)
                want = want.T if jleaf == "kernel" else want
                if name.endswith(".ff.net.0.proj"):
                    # GEGLU: row r of the value half and of the gate half
                    full = whole[key].numpy()
                    f = full.shape[0] // 2
                    interleaved = np.concatenate([full[rank * f // 2:(rank + 1) * f // 2],
                                                  full[f + rank * f // 2:f + (rank + 1) * f // 2]])
                    np.testing.assert_array_equal(got.detach().numpy(), interleaved, key)
                    if leaf == "weight":  # JAX's device holds a contiguous slice
                        assert not np.array_equal(got.detach().numpy(), want), key
                    checked["geglu"] += 1
                elif isinstance(m, tsharding.RowParallelLinear) and leaf == "bias":
                    np.testing.assert_array_equal(got.detach().numpy(), whole[key].numpy(), key)
                else:
                    np.testing.assert_array_equal(got.detach().numpy(), want, key)
                    checked["column" if isinstance(m, tsharding.ColumnParallelLinear)
                            else "row"] += 1
        for name, m in local.named_modules():
            if hasattr(m, "num_heads"):
                assert m.num_heads == (12 if model == "clip" else 8) // 2, name
    assert checked["column"] and checked["row"], checked
    assert bool(checked["geglu"]) == (model != "clip"), checked  # CLIP has no GEGLU


def test_single_head_vae_attention_stays_whole(jax_params):
    module = port_module("vae", jax_params["vae"])
    whole = {k: v.clone() for k, v in module.state_dict().items()}
    local = tsharding.tp_shard(module, 1, 2, group=None)
    assert getattr(local, "tp_size", 1) == 1
    assert not any(isinstance(m, tsharding.ParallelLinear) for m in local.modules())
    assert all(torch.equal(v, whole[k]) for k, v in local.state_dict().items())
    # the JAX rule would shard it: the port keeps it whole on purpose
    assert tsharding.param_spec("decoder.mid_block.attentions.0.to_q", "kernel", 2) == (
        None, "model")


@pytest.mark.parametrize("model,size", [("clip", 5), ("unet", 3), ("controlnet", 3)])
def test_a_head_count_the_model_axis_does_not_divide_raises(jax_params, model, size):
    # the attentions would stay whole, but the feed-forward widths (CLIP's 3072,
    # GEGLU's 128 here) do not split either: that raises, before anything changes
    module = port_module(model, jax_params[model])
    with pytest.raises(ValueError, match=f"cannot be split over model={size}"):
        tsharding.tp_shard(module, 0, size, group=None)
    assert not any(isinstance(m, tsharding.ParallelLinear) for m in module.modules())
    assert {m.num_heads for m in module.modules() if hasattr(m, "num_heads")} == {
        12 if model == "clip" else 8}


def test_clip_attention_whose_heads_model_8_does_not_divide_stays_whole(jax_params):
    module = port_module("clip", jax_params["clip"])
    whole = {k: v.clone() for k, v in module.state_dict().items()}
    local = tsharding.tp_shard(module, 3, 8, group=None)
    assert local.tp_size == 8
    for name, m in local.named_modules():
        if hasattr(m, "num_heads"):  # 12 heads on every rank, q/k/v/out whole
            assert m.num_heads == 12, name
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                assert type(getattr(m, proj)) is nn.Linear, (name, proj)
                assert torch.equal(getattr(m, proj).weight, whole[f"{name}.{proj}.weight"])
    fc1 = local.text_model.encoder.layers[0].mlp.fc1
    assert isinstance(fc1, tsharding.ColumnParallelLinear)  # the MLP is sharded as in JAX
    np.testing.assert_array_equal(
        fc1.weight.detach().numpy(),
        whole["text_model.encoder.layers.0.mlp.fc1.weight"].numpy()[3 * 384:4 * 384])


def test_fused_projections_and_a_second_shard_raise(jax_params):
    fused = tunet.fuse_attention_projections(port_module("unet", jax_params["unet"]))
    with pytest.raises(ValueError, match="fused"):
        tsharding.tp_shard(fused, 0, 2, group=None)
    once = tsharding.tp_shard(port_module("unet", jax_params["unet"]), 0, 2, group=None)
    with pytest.raises(ValueError, match="already sharded"):
        tsharding.tp_shard(once, 0, 2, group=None)


@pytest.mark.parametrize("key,shape,dim", [
    ("a.attn1.to_q.weight", (320, 320), 0),
    ("a.attn1.to_out.0.weight", (320, 320), 1),
    ("a.attn1.to_out.0.bias", (320,), None),
    ("a.ff.net.0.proj.bias", (2560,), 0),
    ("text_model.encoder.layers.0.mlp.fc2.weight", (768, 3072), 1),
    ("a.proj_in.weight", (320, 320, 1, 1), None),
])
def test_shard_dim_in_the_torch_layout(key, shape, dim):
    assert tsharding.shard_dim(key, len(shape)) == dim
    t = torch.arange(float(np.prod(shape))).reshape(shape)
    parts = [tsharding.shard_tensor(key, t, r, 2) for r in range(2)]
    if dim is None:
        assert all(p is t for p in parts)
    elif key.endswith("proj.bias"):
        half = shape[0] // 2
        assert torch.equal(torch.cat([parts[0][:half // 2], parts[1][:half // 2]]), t[:half])
    else:
        assert torch.equal(torch.cat(parts, dim), t)


def test_shard_module_is_a_module_swap_only(jax_params):
    """The sharded module keeps its ``state_dict`` names, and every non-matched
    tensor as it was."""
    whole = port_module("unet", jax_params["unet"])
    names = set(whole.state_dict())
    local = tsharding.tp_shard(port_module("unet", jax_params["unet"]), 1, 2, group=None)
    assert set(local.state_dict()) == names
    for key, value in local.state_dict().items():
        if tsharding.shard_dim(key, value.dim()) is None:
            assert torch.equal(value, whole.state_dict()[key]), key
    assert sum(isinstance(m, nn.Linear) for m in local.modules()) < sum(
        isinstance(m, nn.Linear) for m in whole.modules())
