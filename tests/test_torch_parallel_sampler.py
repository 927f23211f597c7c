"""The production sampler on 8 ``gloo`` ranks against the JAX package's
``sampler.generate`` under the same meshes of the conftest's virtual devices, at
``tests/test_sharding.py``'s settings: DP x TP on mesh (4, 2), CFG 7.5, rescale
0.7, 2 DDIM steps and the VAE decode at batch 4 (latent 5e-4, uint8 mean
difference < 0.05); and spatial sequence parallelism on mesh (2, 4) at a 32x32
latent with ``min_seq=1024``, weights whole: level 0 H-sharded over the model
axis, its self-attentions on the sharded ring (latent 5e-4)."""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from minsdtf_tpu import sampler as jsampler
from minsdtf_tpu import scheduler as jsched
from minsdtf_tpu.models import unet as junet
from minsdtf_tpu.models import vae as jvae
from minsdtf_tpu.ops import attention as jattn
from minsdtf_tpu.parallel import mesh as jmesh
from minsdtf_tpu.parallel import sharding as jsharding
from minsdtf_tpu_torch.models import unet as tunet
from minsdtf_tpu_torch.models import vae as tvae
from minsdtf_tpu_torch.parallel.mesh import run_ranks
from minsdtf_tpu_torch.weights.from_jax import from_jax, split_vae
from torch_port_utils import one_torch_thread  # noqa: F401

TOL = 5e-4
ROWS = ("sr_t", "nr_t", "sr_prev", "nr_prev", "sr_s", "nr_s", "c_denoised", "c_noise",
        "is_last")


def jax_generate(u_params, v_params, latent0, ctx, unc, guidance, rescale, decode, sp=None):
    schedule = jsched.build_denoise_schedule(jsched.Scheduler(active_tcd=False), 2)
    t_embs = jsched.timestep_embedding(schedule.timesteps, dim=32)
    rows = {k: getattr(schedule, k) for k in ROWS}
    return jsampler.generate(
        u_params, v_params, latent0, ctx, unc, jnp.asarray(t_embs), rows,
        jnp.float32(guidance), jnp.float32(rescale), use_cfg=unc is not None,
        active_tcd=False, stochastic=False, use_controls=False, use_inpaint=False,
        decode=decode, sp=sp)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    unet_p = junet.init_params(jax.random.PRNGKey(0), dtype=jnp.float32, scale=0.04,
                               **ranks.SMALL)
    vae_p = jvae.init_params(jax.random.PRNGKey(5), scale=0.04, enc_widths=ranks.VAE_ENC,
                             dec_widths=ranks.VAE_DEC)
    rng = np.random.RandomState(0)
    dp_inputs = [rng.normal(0, 1, shape).astype(np.float32)
                 for shape in ((4, 8, 8, 4), (4, 77, 768), (4, 77, 768))]
    rng = np.random.RandomState(1)
    sp_inputs = [rng.normal(0, 1, shape).astype(np.float32)
                 for shape in ((1, 32, 32, 4), (1, 77, 768))]
    tmp = tmp_path_factory.mktemp("sampler")
    unet_path, decoder_path = tmp / "unet.pt", tmp / "decoder.pt"
    torch.save(from_jax(unet_p, tunet.UNet(**ranks.SMALL)), unet_path)
    torch.save(from_jax(split_vae(vae_p)[1], tvae.VAEDecoder(ranks.VAE_DEC)), decoder_path)
    with ThreadPoolExecutor(1) as pool:  # the ranks run while JAX compiles
        future = pool.submit(run_ranks, ranks.sampler_runs, 8,
                             (str(unet_path), str(decoder_path), dp_inputs, sp_inputs),
                             timeout_s=300)
        mesh = jmesh.make_mesh(data=4, model=2)
        with mesh:
            image, latent = jax_generate(
                jsharding.shard_params(unet_p, mesh), jsharding.shard_params(vae_p, mesh),
                *(jsharding.shard_batch(jnp.asarray(a), mesh) for a in dp_inputs),
                7.5, 0.7, decode=True)
        want = dict(image=np.asarray(image), latent=np.asarray(latent))
        sp_mesh = jmesh.make_mesh(data=2, model=4)
        jattn.set_sequence_parallel(sp_mesh, "model", min_seq=1024)
        try:
            with sp_mesh:
                _, sp_latent = jax_generate(
                    jsharding.replicate_params(unet_p, sp_mesh), None,
                    *(jnp.asarray(a) for a in sp_inputs), None, 0.0, 0.0, decode=False,
                    sp=jattn.sequence_parallel_key())
        finally:
            jattn.set_sequence_parallel(None)
        want["sp_latent"] = np.asarray(sp_latent)
        return future.result(), want


def test_dp_tp_sampler_matches_jax_under_the_same_mesh(runs):
    got, want = runs
    for rank in got:
        assert rank["image"].shape == (4, 64, 64, 3) and rank["image"].dtype == np.uint8
        np.testing.assert_allclose(rank["latent"], want["latent"], rtol=TOL, atol=TOL)
        diff = np.abs(rank["image"].astype(int) - want["image"].astype(int))
        assert diff.mean() < 0.05, diff.mean()


def test_sequence_parallel_sampler_matches_jax_under_the_same_mesh(runs):
    got, want = runs
    for rank in got:
        np.testing.assert_allclose(rank["sp_latent"], want["sp_latent"], rtol=TOL, atol=TOL)
        # level 0's self-attention (1024 tokens) in both UNet blocks of each of
        # the 5 transformer levels at 32x32: down 2, up 3; 2 steps, no CFG
        assert rank["ring_calls"] == 2 * 5, rank["ring_calls"]


def test_sequence_parallel_sampler_keeps_level_0_sharded(runs):
    got, _ = runs
    for rank in got:
        assert rank["ring_whole"] == 0  # no ring call gathers its output
        calls = rank["spatial"]
        # a UNet call: the downsampler's and conv_out's output rows are gathered;
        # the 13 3x3 convs of level 0 (conv_in, 4 down, 6 up, conv_out and the
        # downsampler) run on rows
        assert calls["gather_rows"] == 2 * 2 and calls["halo_conv2d"] == 2 * 13, calls
        assert calls["upsample2x_conv3x3"] == 2 and calls["group_norm"] == 2 * 16, calls
