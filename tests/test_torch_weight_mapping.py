"""The port's copy of the checkpoint key maps (``minsdtf_tpu_torch.weights.mapping``)
against the JAX package's, and the maps inverted over the port's full-width
``state_dict`` keys: names only, no tensors."""

import pytest

from minsdtf_tpu.weights import mapping as jmapping
from minsdtf_tpu_torch.models import clip as tclip
from minsdtf_tpu_torch.models import controlnet as tcontrolnet
from minsdtf_tpu_torch.models import unet as tunet
from minsdtf_tpu_torch.models import vae as tvae
from minsdtf_tpu_torch.weights import convert as tconvert
from minsdtf_tpu_torch.weights import mapping as tmapping
from torch_port_utils import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name", ["unet_ldm_to_diffusers", "controlnet_ldm_to_diffusers",
                                  "vae_ldm_to_diffusers"])
def test_maps_equal_the_jax_packages(name):
    ours, want = getattr(tmapping, name)(), getattr(jmapping, name)()
    assert list(ours.items()) == list(want.items())


def test_alternates_and_prefixes_equal_the_jax_packages():
    assert tmapping.VAE_ATTN_ALTERNATES == jmapping.VAE_ATTN_ALTERNATES
    for name in ("TEXT_ENCODER_LDM_PREFIX", "UNET_LDM_PREFIX", "VAE_LDM_PREFIX"):
        assert getattr(tmapping, name) == getattr(jmapping, name)


def _ldm_keys(port_keys, module_map, prefix=""):
    """Each port key under its LDM name: the module inverted through ``module_map``
    (names the map does not cover keep theirs), then ``prefix``."""
    inverse = {v: k for k, v in module_map.items()}
    assert len(inverse) == len(module_map)  # the map is one to one
    out = []
    for key in port_keys:
        module, _, leaf = key.rpartition(".")
        out.append(f"{prefix}{inverse.get(module, module)}.{leaf}")
    return out


VAE_KEYS = list(tvae.encoder_param_specs()) + list(tvae.decoder_param_specs())
CASES = {  # port keys, map, LDM prefix added, the converter's way back, count
    "unet": (list(tunet.param_specs()), tmapping.unet_ldm_to_diffusers(), "",
             lambda sd: tconvert._renamed(sd, tmapping.unet_ldm_to_diffusers()), 686),
    "controlnet": (list(tcontrolnet.param_specs()), tmapping.controlnet_ldm_to_diffusers(), "",
                   lambda sd: tconvert._renamed(sd, tmapping.controlnet_ldm_to_diffusers()), 340),
    "vae": (VAE_KEYS, tmapping.vae_ldm_to_diffusers(), tmapping.VAE_LDM_PREFIX,
            lambda sd: tconvert._renamed(tconvert._stripped(sd, tmapping.VAE_LDM_PREFIX),
                                         tmapping.vae_ldm_to_diffusers()), 248),
    "text_encoder": (list(tclip.param_specs()), {}, tmapping.TEXT_ENCODER_LDM_PREFIX,
                     lambda sd: tconvert._stripped(sd, tmapping.TEXT_ENCODER_LDM_PREFIX), 196),
}


@pytest.mark.parametrize("kind", list(CASES))
def test_ldm_names_map_back_onto_the_port_keys(kind):
    port_keys, module_map, prefix, back, count = CASES[kind]
    assert len(port_keys) == len(set(port_keys)) == count
    ldm = _ldm_keys(port_keys, module_map, prefix)
    assert len(set(ldm)) == count
    if module_map:  # every LDM name is a mapped one: none passes through unmapped
        assert all(k[len(prefix):].rpartition(".")[0] in module_map for k in ldm)
    assert list(back(dict.fromkeys(ldm))) == port_keys
