"""The two mesh faults, repaired: a data axis that does not divide the batch, and a
CLIP whose 12 heads the model axis does not divide.

- ``StableDiffusion(mesh=make_mesh(2, 1))`` at batch 1 and batch 3 on 2 ``gloo``
  ranks: every data rank runs the whole batch and gathers nothing, as the JAX
  pipeline's replicated batch does; against the JAX pipeline on the same mesh,
  same seeded modules, 64 px, 3 steps, fp32: latent 1e-3, uint8 +-1.
- CLIP on mesh (1, 8), 8 ranks: each attention stays whole on every rank (its
  12 heads do not split over 8), the MLP is sharded; ``encode_tokens`` against
  the JAX ``clip.encode_tokens`` with its params sharded on (1, 8) by the JAX
  rules (the 768 columns 96 to a device): rtol = atol = 2e-4. The layouts
  differ; the results do not."""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_ranks as ranks
from minsdtf_tpu.models import clip as jclip
from minsdtf_tpu.parallel import mesh as jmesh
from minsdtf_tpu.parallel import sharding as jsharding
from minsdtf_tpu_torch.models import clip as tclip
from minsdtf_tpu_torch.parallel.mesh import run_ranks
from torch_port_utils import (  # noqa: F401 (one_torch_thread)
    jax_generate, jax_mesh_pipeline, one_torch_thread, seeded_jax_params, to_jax_params,
    write_merges,
)

SIZE = 64
TOL = 1e-3
CALLS = [(f"batch {b}", "text_to_image", {"batch_size": b}) for b in (1, 3)]


def both(bpe: str, tokens: np.ndarray):
    dp = run_ranks(ranks.mesh_pipeline, 2, (bpe, SIZE, (2, 1), CALLS, {}), timeout_s=240)
    return dp, run_ranks(ranks.clip_tp, 8, (tokens,), timeout_s=240)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    bpe = write_merges(tmp_path_factory.mktemp("bpe") / "merges.txt.gz")
    tokens = np.random.RandomState(0).randint(0, tclip.VOCAB_SIZE, (2, 77)).astype(np.int64)
    with ThreadPoolExecutor(1) as pool:  # the ranks run while JAX compiles
        future = pool.submit(both, bpe, tokens)
        j = jax_mesh_pipeline(seeded_jax_params(), bpe, SIZE, 2, 1)
        want = {label: jax_generate(j, method, **kw) for label, method, kw in CALLS}
        mesh = jmesh.make_mesh(data=1, model=8)
        params = jsharding.shard_params(to_jax_params(tclip.init("cpu", seed=1)), mesh)
        with mesh:
            want["clip"] = np.asarray(jax.jit(jclip.encode_tokens)(params, jnp.asarray(tokens)))
        return future.result(), want


@pytest.mark.parametrize("batch", [1, 3])
def test_a_batch_the_data_axis_does_not_divide_matches_jax(runs, batch):
    (dp, _), want = runs
    want_img, want_lat = want[f"batch {batch}"]
    for outs, counts in dp:
        img, lat = outs[f"batch {batch}"]
        assert img.shape == want_img.shape == (batch, SIZE, SIZE, 3) and img.dtype == np.uint8
        np.testing.assert_allclose(lat, want_lat, rtol=TOL, atol=TOL)
        assert np.abs(img.astype(int) - want_img.astype(int)).max() <= 1
        assert counts[f"batch {batch}"]["comm"]["all_gather"] == 0  # nothing is gathered


def test_clip_on_model_8_matches_jax_with_the_same_mesh(runs):
    (_, clip), want = runs
    for rank in clip:
        np.testing.assert_allclose(rank["out"], want["clip"], rtol=2e-4, atol=2e-4)
        # the attention whole, the MLP's 3072 columns 384 a rank
        assert rank["heads"] == 12 and rank["q_proj"] == "Linear"
        assert rank["fc1"] == "ColumnParallelLinear" and rank["fc1_rows"] == 384
