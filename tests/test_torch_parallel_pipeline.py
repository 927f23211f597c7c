"""``StableDiffusion(mesh=...)`` of the port on 2 ``gloo`` ranks against the JAX
pipeline with a mesh of the conftest's virtual devices, on the same small params
(``torch_port_utils.make_pipelines``), 64 px, 3 steps, fp32: txt2img at batch 2
on mesh (2, 1), each rank sampling its row; ControlNet txt2img under TP on mesh
(1, 2). Latent 1e-3, uint8 +-1. Also the ``ValueError`` of ``weight_dtype``
with a mesh. The module files are removed when the module's tests end."""

import shutil
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from minsdtf_tpu.parallel import mesh as jmesh
from minsdtf_tpu.parallel import sharding as jsharding
from minsdtf_tpu.pipeline import StableDiffusion as JaxStableDiffusion
from minsdtf_tpu_torch.models import clip as tclip
from minsdtf_tpu_torch.models import controlnet as tcontrolnet
from minsdtf_tpu_torch.models import unet as tunet
from minsdtf_tpu_torch.models import vae as tvae
from minsdtf_tpu_torch.parallel.mesh import run_ranks
from minsdtf_tpu_torch.weights.from_jax import from_jax, split_vae
from torch_port_utils import edge_image, make_pipelines, one_torch_thread, write_merges  # noqa: F401

SIZE = 64
TOL = 1e-3
COMMON = dict(num_steps=3, seed=7, return_latent=True)


def jax_pipeline(jpipe, data: int, model: int):
    """The JAX pipeline on a (data, model) mesh holding ``jpipe``'s params, placed
    by the JAX package's own rules."""
    mesh = jmesh.make_mesh(data=data, model=model, devices=jax.devices()[:data * model])
    j = JaxStableDiffusion(SIZE, SIZE, compute_dtype=jax.numpy.float32,
                           bpe_path=jpipe.bpe_path, mesh=mesh)
    for name in ("_unet_params", "_vae_params", "_text_params", "_controlnet_params"):
        setattr(j, name, jsharding.shard_params(getattr(jpipe, name), mesh))
    return j


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    bpe = write_merges(tmp / "merges.txt.gz")
    jpipe, _ = make_pipelines(bpe, SIZE, controlnet=True)
    enc_p, dec_p = split_vae(jpipe._vae_params)
    modules = {"unet": (tunet.UNet(**ranks.PIPE_UNET), jpipe._unet_params),
               "encoder": (tvae.VAEEncoder(ranks.VAE_ENC), enc_p),
               "decoder": (tvae.VAEDecoder(ranks.VAE_DEC), dec_p),
               "text": (tclip.CLIPTextModel(), jpipe._text_params),
               "controlnet": (tcontrolnet.ControlNet(**ranks.PIPE_UNET),
                              jpipe._controlnet_params)}
    paths = {}
    for name, (module, params) in modules.items():
        paths[name] = str(tmp / f"{name}.pt")
        torch.save(from_jax(params, module), paths[name])
    edges = edge_image(SIZE, SIZE)
    with ThreadPoolExecutor(1) as pool:  # the ranks run while JAX compiles
        future = pool.submit(run_ranks, ranks.pipeline_runs, 2, (paths, bpe, SIZE, edges),
                             timeout_s=300)
        # the JAX text_to_image returns no latent: generate_image with its settings
        want = {}
        for path, (data, model), kw in (("dp", (2, 1), dict(batch_size=2)),
                                        ("tp_controlnet", (1, 2),
                                         dict(control_net_image=edges))):
            j = jax_pipeline(jpipe, data, model)
            want[path] = j.generate_image(j.encode_text("hello world"), guidance_rescale=0.7,
                                          **COMMON, **kw)
        result = future.result(), want
    yield result
    shutil.rmtree(tmp)  # the full-width CLIP alone is 492 MB


@pytest.mark.parametrize("path,batch", [("dp", 2), ("tp_controlnet", 1)])
def test_mesh_pipeline_matches_jax_with_a_mesh(runs, path, batch):
    got, want = runs
    want_img, want_lat = want[path]
    for rank in got:
        img, lat = rank[path]
        assert img.shape == want_img.shape == (batch, SIZE, SIZE, 3) and img.dtype == np.uint8
        np.testing.assert_allclose(lat, want_lat, rtol=TOL, atol=TOL)
        assert np.abs(img.astype(int) - want_img.astype(int)).max() <= 1


def test_tp_shards_the_heads_and_dp_gathers_every_row(runs):
    got, _ = runs
    assert [rank["tp_heads"] for rank in got] == [4, 4]
    np.testing.assert_array_equal(got[0]["dp"][0], got[1]["dp"][0])
    assert not np.array_equal(got[0]["dp"][0][0], got[0]["dp"][0][1])  # two noise rows


def test_value_errors(runs):
    got, _ = runs
    for rank in got:
        assert "single-device" in rank["errors"]["weight_dtype with a mesh"]
