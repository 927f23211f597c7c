"""``StableDiffusion(mesh=make_mesh(1, 2), sequence_parallel=True)`` of the port on 2
``gloo`` ranks against the JAX pipeline on the same mesh of the conftest's
virtual devices, with ``MINSDTF_SP_MIN_SEQ=64`` for both packages, so that at
64 px the UNet's and the ControlNet's level 0 (8x8 latents) and every level of
the VAE encoder and decoder are H-sharded: ``text_to_image``, ``image_to_image``
(the encoder sharded) and ControlNet ``text_to_image`` (its residuals added to
the sharded skips). Same seeded modules on both sides (``seeded_modules``), 3 steps,
fp32; latent 1e-3, uint8 +-1."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import torch_parallel_ranks as ranks
from minsdtf_tpu.ops import attention as jattn
from minsdtf_tpu_torch.parallel.mesh import run_ranks
from torch_port_utils import (  # noqa: F401 (one_torch_thread)
    edge_image, jax_generate, jax_mesh_pipeline, one_torch_thread, reference_image,
    seeded_jax_params, write_merges,
)

SIZE = 64
TOL = 1e-3
CALLS = [("txt2img", "text_to_image", {}),
         ("img2img", "image_to_image", {"reference_image": reference_image(80, 72)}),
         ("controlnet", "text_to_image", {"control_net_image": edge_image(SIZE, SIZE)})]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    bpe = write_merges(tmp_path_factory.mktemp("bpe") / "merges.txt.gz")
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(1) as pool:
        mp.setenv("MINSDTF_SP_MIN_SEQ", "64")  # read by both pipelines at construction
        future = pool.submit(run_ranks, ranks.mesh_pipeline, 2,
                             (bpe, SIZE, (1, 2), CALLS, {"sequence_parallel": True}),
                             timeout_s=240)
        j = jax_mesh_pipeline(seeded_jax_params(), bpe, SIZE, 1, 2, sequence_parallel=True)
        try:
            want = {label: jax_generate(j, method, **kw) for label, method, kw in CALLS}
        finally:  # the JAX pipeline sets its SP mesh process-wide, for later tests too
            jattn.set_sequence_parallel(None)
        return future.result(), want


@pytest.mark.parametrize("label", [label for label, _, _ in CALLS])
def test_spatial_sp_pipeline_matches_jax_with_the_same_mesh(runs, label):
    got, want = runs
    want_img, want_lat = want[label]
    for outs, _ in got:
        img, lat = outs[label]
        assert img.shape == want_img.shape == (1, SIZE, SIZE, 3) and img.dtype == np.uint8
        np.testing.assert_allclose(lat, want_lat, rtol=TOL, atol=TOL)
        assert np.abs(img.astype(int) - want_img.astype(int)).max() <= 1


def test_the_pipeline_runs_spatially(runs):
    got, _ = runs
    for _, counts in got:
        # a step gathers the downsampler's output rows of the UNet (and of the
        # ControlNet) and the UNet's conv_out's; the decoder's output once; and
        # for img2img the encoder's output
        for label, steps, per_step in (("txt2img", 3, 2), ("img2img", 2, 2),
                                       ("controlnet", 3, 3)):
            c = counts[label]
            assert c["comm"]["halo"] > 0 and c["comm"]["ring_shift"] > 0, c
            gathers = steps * per_step + 1 + (label == "img2img")
            assert c["spatial"]["gather_rows"] == gathers, c
