"""The port's entry points on meshes that no other CPU test holds against the JAX
pipeline on the same mesh: ``image_to_image`` and ``inpaint`` under TP on mesh
(1, 2), and ``text_to_image`` at batch 2 on mesh (2, 2) (DP x TP), on ``gloo``
ranks against the JAX pipeline on the conftest's virtual devices. Same seeded
modules on both sides (``seeded_modules``), 64 px, 3 steps, fp32; latent
1e-3, uint8 +-1."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import torch_parallel_ranks as ranks
from minsdtf_tpu_torch.parallel.mesh import run_ranks
from torch_port_utils import (  # noqa: F401 (one_torch_thread)
    disc_mask, jax_generate, jax_mesh_pipeline, one_torch_thread, reference_image,
    seeded_jax_params, write_merges,
)

SIZE = 64
TOL = 1e-3
REFERENCE = reference_image(80, 72)
TP_CALLS = [("img2img", "image_to_image", {"reference_image": REFERENCE}),
            ("inpaint", "inpaint", {"reference_image": REFERENCE,
                                    "inpaint_mask": disc_mask(SIZE, SIZE),
                                    "mask_blur_strength": 5})]
DP_TP_CALLS = [("txt2img batch 2", "text_to_image", {"batch_size": 2})]
CASES = [("img2img", (1, 2), 1), ("inpaint", (1, 2), 1), ("txt2img batch 2", (2, 2), 2)]


def both(bpe: str):
    tp = run_ranks(ranks.mesh_pipeline, 2, (bpe, SIZE, (1, 2), TP_CALLS, {}), timeout_s=240)
    dp_tp = run_ranks(ranks.mesh_pipeline, 4, (bpe, SIZE, (2, 2), DP_TP_CALLS, {}),
                      timeout_s=240)
    return {(1, 2): tp, (2, 2): dp_tp}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    bpe = write_merges(tmp_path_factory.mktemp("bpe") / "merges.txt.gz")
    with ThreadPoolExecutor(1) as pool:  # the ranks run while JAX compiles
        future = pool.submit(both, bpe)
        params = seeded_jax_params()
        want = {}
        for mesh, calls in (((1, 2), TP_CALLS), ((2, 2), DP_TP_CALLS)):
            j = jax_mesh_pipeline(params, bpe, SIZE, *mesh)
            want.update({label: jax_generate(j, method, **kw) for label, method, kw in calls})
        return future.result(), want


@pytest.mark.parametrize("label,mesh,batch", CASES)
def test_entry_point_on_a_mesh_matches_jax_with_the_same_mesh(runs, label, mesh, batch):
    got, want = runs
    want_img, want_lat = want[label]
    for outs, counts in got[mesh]:
        img, lat = outs[label]
        assert img.shape == want_img.shape == (batch, SIZE, SIZE, 3) and img.dtype == np.uint8
        np.testing.assert_allclose(lat, want_lat, rtol=TOL, atol=TOL)
        assert np.abs(img.astype(int) - want_img.astype(int)).max() <= 1
        assert counts[label]["comm"]["all_reduce"] > 0  # TP's row-parallel sums
        assert counts[label]["comm"]["halo"] == 0  # no spatial SP without it


def test_dp_tp_ranks_return_both_rows(runs):
    got, _ = runs
    images = [outs["txt2img batch 2"][0] for outs, _ in got[(2, 2)]]
    for img in images[1:]:
        np.testing.assert_array_equal(img, images[0])
    assert not np.array_equal(images[0][0], images[0][1])  # two noise rows
