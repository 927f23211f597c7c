"""Helpers shared by the port's tests (``tests/test_torch_*.py``): a synthetic CLIP
merges file, norm perturbation of JAX params, JAX params loaded into a port
module through ``weights.from_jax``, and the JAX and port pipelines on the same
small params."""

import gzip

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minsdtf_tpu import scheduler as jsched
from minsdtf_tpu.models import clip as jclip
from minsdtf_tpu.models import controlnet as jcontrolnet
from minsdtf_tpu.models import unet as junet
from minsdtf_tpu.models import vae as jvae
from minsdtf_tpu.pipeline import StableDiffusion as JaxStableDiffusion
from minsdtf_tpu_torch import StableDiffusion
from minsdtf_tpu_torch.models import clip as tclip
from minsdtf_tpu_torch.models import controlnet as tcontrolnet
from minsdtf_tpu_torch.models import unet as tunet
from minsdtf_tpu_torch.models import vae as tvae
from minsdtf_tpu_torch.weights.from_jax import from_jax, split_vae

# the pipelines' small widths; the UNet's widths[0] must be 320, the width of the
# timestep embeddings the pipeline feeds it
UNET = dict(widths=(320, 64, 128, 128), temb_dim=128)
VAE_ENC = (32, 32, 64, 64)
VAE_DEC = (64, 64, 32, 32)
LATENT_TOL = 1e-4
# the JAX pipeline's scheduler for each mode (minsdtf_tpu/pipeline.py)
JAX_SCHEDULERS = {
    "ddim": lambda: jsched.Scheduler(active_tcd=False),
    "tcd": lambda: jsched.Scheduler(active_tcd=True),
    "lcm": jsched.LCMScheduler,
    "dpm": jsched.DPMSolverScheduler,
    "dpm_karras": lambda: jsched.DPMSolverScheduler(karras_sigmas=True),
    "euler_a": jsched.EulerAncestralScheduler,
}

# enough merges for the test prompts to form multi-character tokens
MERGES = [
    "h e", "l l", "he ll", "o</w> w", "hell o</w>", "w o", "wo r", "wor l",
    "worl d</w>", "t h", "th e</w>", "c a", "ca t</w>", "d o", "do g</w>",
    "s t", "st a", "sta r</w>", "* *", "1 2", "Ã ©",
]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one thread for a test module that imports this fixture. The suite
    runs in several workers beside JAX, whose thread pools keep the cores busy,
    and torch's OpenMP regions then wait on threads that are not running: a 3-step
    64px image took 28 s on 8 threads against 2.7 s on one under such load."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_merges(path) -> str:
    """A gzipped merges file at ``path``; returns the path as a string."""
    with gzip.open(path, "wt") as f:
        f.write("#version: synthetic\n" + "\n".join(MERGES) + "\n")
    return str(path)


def write_clip_lora(path):
    """A rank-4 kohya LoRA on layer 0's q_proj (the JAX compat test's)."""
    rng = np.random.RandomState(3)
    rank = 4
    down = torch.from_numpy(rng.normal(0, 0.1, (rank, 768)).astype(np.float32))
    up = torch.from_numpy(rng.normal(0, 0.1, (768, rank)).astype(np.float32))
    name = "lora_te_text_model_encoder_layers_0_self_attn_q_proj"
    torch.save({f"{name}.lora_down.weight": down, f"{name}.lora_up.weight": up,
                f"{name}.alpha": torch.tensor(2.0)}, path)
    return str(path), (up @ down).numpy() * (2.0 / rank)


def perturb_norms(params, seed: int):
    """Norm scales to N(1, 0.3) and biases to N(0.1, 0.3), in place. With scale 1
    and bias 0 the CLIP output's per-token mean is ~1e-10, and the LPW
    mean-preserving rescale divides two near-zeros."""
    rs = np.random.RandomState(seed)
    for leaves in params.values():
        if "scale" in leaves:
            leaves["scale"] = rs.normal(1.0, 0.3, leaves["scale"].shape).astype(np.float32)
            leaves["bias"] = rs.normal(0.1, 0.3, leaves["bias"].shape).astype(np.float32)
    return params


def load(module, params):
    """``module`` with the JAX ``params`` loaded, in eval mode."""
    module.load_state_dict(from_jax(params, module))
    return module.eval()


def make_pipelines(bpe_path, size: int = 64, controlnet: bool = False):
    """The JAX pipeline and the port's, fp32 on the CPU, ``size`` x ``size``,
    holding the same small params (and a ControlNet at the UNet's widths when
    ``controlnet``)."""
    unet_p = junet.init_params(jax.random.PRNGKey(0), **UNET)
    vae_p = jvae.init_params(jax.random.PRNGKey(2), enc_widths=VAE_ENC, dec_widths=VAE_DEC)
    text_p = perturb_norms(jclip.init_params(jax.random.PRNGKey(1)), 3)

    jpipe = JaxStableDiffusion(size, size, compute_dtype=jnp.float32, bpe_path=bpe_path)
    jpipe._unet_params, jpipe._vae_params, jpipe._text_params = unet_p, vae_p, text_p
    pipe = StableDiffusion(size, size, bpe_path=bpe_path, compute_dtype=torch.float32,
                           device="cpu")
    pipe._unet = load(tunet.fuse_attention_projections(tunet.UNet(**UNET)), unet_p)
    enc_p, dec_p = split_vae(vae_p)
    pipe._encoder = load(tvae.VAEEncoder(VAE_ENC), enc_p)
    pipe._decoder = load(tvae.VAEDecoder(VAE_DEC), dec_p)
    pipe._text_model = load(tclip.CLIPTextModel(), text_p)
    if controlnet:
        cn_p = perturb_norms(jcontrolnet.init_params(jax.random.PRNGKey(3), scale=0.04, **UNET), 4)
        jpipe._controlnet_params = cn_p
        pipe._controlnet = load(
            tunet.fuse_attention_projections(tcontrolnet.ControlNet(**UNET)), cn_p)
    return jpipe, pipe


def with_settings(pipelines, **kw):
    """The JAX and port pipelines built anew with the constructor arguments ``kw``
    (``scheduler_type``, ``prediction_type``, ...), holding the params and modules
    of ``pipelines``."""
    jpipe, pipe = pipelines
    size = pipe.img_height
    j = JaxStableDiffusion(size, size, compute_dtype=jnp.float32, bpe_path=jpipe.bpe_path, **kw)
    for name in ("_unet_params", "_vae_params", "_text_params", "_controlnet_params"):
        setattr(j, name, getattr(jpipe, name))
    t = StableDiffusion(size, size, bpe_path=pipe.bpe_path, compute_dtype=torch.float32,
                        device="cpu", **kw)
    for name in ("_unet", "_encoder", "_decoder", "_text_model", "_controlnet"):
        setattr(t, name, getattr(pipe, name))
    return j, t


def jax_step_noise(seed, shape) -> torch.Tensor:
    """The JAX pipeline's per-step noise for ``seed``, in the port's
    ``draw_step_noise`` form: step i draws
    ``normal(fold_in(fold_in(PRNGKey(seed), 1), i), shape[1:])``."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 1)
    steps = [np.asarray(jax.random.normal(jax.random.fold_in(key, np.uint32(i)), tuple(shape[1:]),
                                          jnp.float32)) for i in range(shape[0])]
    return torch.from_numpy(np.stack(steps))


def assert_same_image(got, want, size: int = 64, batch: int = 1):
    """``(image, latent)`` pairs: the same uint8 image shape, the latents within
    ``LATENT_TOL`` and the images within 1."""
    (img, lat), (want_img, want_lat) = got, want
    assert img.shape == want_img.shape == (batch, size, size, 3) and img.dtype == np.uint8
    np.testing.assert_allclose(lat, want_lat, rtol=LATENT_TOL, atol=LATENT_TOL)
    assert np.abs(img.astype(int) - want_img.astype(int)).max() <= 1


def nchw(a) -> torch.Tensor:
    """An NHWC numpy array as a contiguous NCHW tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def edge_image(h: int, w: int) -> np.ndarray:
    """An (h, w, 3) uint8 edge map like a canny output: a ring and a diagonal,
    white on black."""
    yy, xx = np.mgrid[:h, :w]
    ring = np.abs(np.hypot(yy - h / 2, xx - w / 2) - min(h, w) / 3) < 1.5
    edges = np.where(ring | (np.abs(yy - xx) < 1), 255, 0).astype(np.uint8)
    return np.repeat(edges[..., None], 3, axis=-1)


def reference_image(h: int, w: int, seed: int = 11) -> np.ndarray:
    """An (h, w, 3) uint8 image: smooth colour gradients plus seeded noise."""
    yy, xx = np.mgrid[:h, :w] / max(h, w)
    base = np.stack([yy, xx, 1.0 - (yy + xx) / 2], axis=-1) * 200.0
    noise = np.random.RandomState(seed).uniform(0, 55, (h, w, 3))
    return (base + noise).astype(np.uint8)


def disc_mask(h: int, w: int) -> np.ndarray:
    """An (h, w) uint8 mask, 255 inside a disc about the centre and 0 outside."""
    yy, xx = np.mgrid[:h, :w]
    return np.where(np.hypot(yy - h / 2, xx - w / 2) < min(h, w) / 4, 255, 0).astype(np.uint8)
