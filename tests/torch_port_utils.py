"""Helpers shared by the port's tests (``tests/test_torch_*.py``): a synthetic CLIP
merges file, norm perturbation of JAX params, JAX params loaded into a port
module through ``weights.from_jax``, and the JAX and port pipelines on the same
small params."""

import contextlib
import gzip
import shutil

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
from minsdtf_tpu_torch import pipeline as tpipeline
from minsdtf_tpu_torch.models import clip as tclip
from minsdtf_tpu_torch.models import controlnet as tcontrolnet
from minsdtf_tpu_torch.models import unet as tunet
from minsdtf_tpu_torch.models import vae as tvae
from minsdtf_tpu_torch.weights import quantize as tquantize
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


@pytest.fixture
def tmp_path(tmp_path):
    """``tmp_path``, removed when the test ends, for a module that imports it: its
    tests write checkpoint-size files, which pytest would keep for three runs."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


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


class Int8Replay:
    """Holds the port's int8 rounding to the JAX package's, so that a comparison of
    an int8 model measures everything but the ties.

    A rounding boundary of an int8 activation can fall between the two packages'
    fp32 values (they differ by ~1e-7 relative); the two roundings then differ by
    one step, and every later int8 site of the model sees inputs that differ by
    about a step, flips more of its own roundings, and so on
    (``test_torch_int8_pipeline.py::test_int8_latent_turns_on_rounding_ties``: a
    1e-6 relative change of the context moves a 3-step CFG 7.5 int8 latent by
    more than 1e-2, an fp32 one by less than 1e-3). ``recording()`` keeps each of the JAX package's int8
    activations in call order (through an ordered ``jax.debug.callback``, so also
    inside its jitted programs); ``replaying()`` checks each of the port's against it:
    every element that differs must be one step apart with inputs within ``1e-5``
    of the activation's amax (a tie that fp32 noise decided), and the port then
    goes on with the JAX package's values. ``flips`` counts them."""

    def __init__(self):
        self.tape = []
        self.used = 0
        self.flips = 0

    @contextlib.contextmanager
    def recording(self):
        from minsdtf_tpu.ops import basic as jbasic

        original = jbasic._quantize_acts

        def keep(x, xq):
            self.tape.append((np.asarray(x, np.float32), np.asarray(xq)))

        def record(x, p, axes):
            xq, asc = original(x, p, axes)
            jax.debug.callback(keep, x, xq, ordered=True)
            return xq, asc

        jax.clear_caches()  # a program traced before would run without the callback
        jbasic._quantize_acts = record
        try:
            yield self
            jax.effects_barrier()
        finally:
            jbasic._quantize_acts = original
            jax.clear_caches()

    @contextlib.contextmanager
    def replaying(self):
        from minsdtf_tpu_torch.ops import basic as tbasic

        original = tbasic._quantize_acts

        def replay(x, site, dims, channel_dim):
            xq, asc = original(x, site, dims, channel_dim)
            want_x, want = self.tape[self.used]
            self.used += 1
            if channel_dim == 1:  # NHWC -> NCHW
                want_x, want = want_x.transpose(0, 3, 1, 2), want.transpose(0, 3, 1, 2)
            got = xq.numpy()
            assert got.shape == want.shape, (site.name, got.shape, want.shape)
            differ = got != want
            if differ.any():
                steps = np.abs(got[differ].astype(np.int64) - want[differ])
                gap = np.abs(x.float().numpy()[differ] - want_x[differ]).max()
                assert steps.max() == 1 and gap <= 1e-5 * np.abs(want_x).max(), (
                    site.name, int(differ.sum()), int(steps.max()), float(gap))
                self.flips += int(differ.sum())
                xq = torch.from_numpy(want.copy())
            return xq, asc

        tbasic._quantize_acts = replay
        try:
            yield self
        finally:
            tbasic._quantize_acts = original
        assert self.used == len(self.tape), (self.used, len(self.tape))


# The int8 pipelines against the JAX package's with the ties replayed: what is
# left is the fp32 difference of the float work, as for the fp32 pipelines
# (LATENT_TOL); assert_int8_image prints it.
INT8_LATENT_TOL = 1e-3


def int8_pipelines(base, monkeypatch, weight_dtype, **kw):
    """The JAX and port pipelines made with ``weight_dtype`` (and ``kw``), holding
    ``base``'s text encoder and VAE; each builds its UNet from ``base``'s small
    fp32 UNet params through its own ``unet`` property (the random init replaced
    by those params)."""
    jbase, tbase = base
    unet_p = jbase._unet_params
    monkeypatch.setattr(junet, "init_params",
                        lambda key, **_: {k: dict(v) for k, v in unet_p.items()})
    build = tpipeline.build
    monkeypatch.setattr(tpipeline, "build", lambda factory, device, seed: (
        load(tunet.UNet(**UNET), unet_p) if factory is tunet.UNet else build(factory, device, seed)))
    j = JaxStableDiffusion(64, 64, compute_dtype=jnp.float32, bpe_path=jbase.bpe_path,
                           weight_dtype=weight_dtype, **kw)
    t = StableDiffusion(64, 64, bpe_path=tbase.bpe_path, compute_dtype=torch.float32,
                        device="cpu", weight_dtype=weight_dtype, **kw)
    j._vae_params, j._text_params = jbase._vae_params, jbase._text_params
    t._encoder, t._decoder, t._text_model = tbase._encoder, tbase._decoder, tbase._text_model
    return j, t


def assert_same_int8_sites(model, jparams):
    """The port's int8 sites are the JAX params' quantized modules, bit for bit."""
    sites = tquantize.int8_sites(model)
    assert set(sites) == {n for n, leaves in jparams.items() if "kernel_q" in leaves}
    assert sites
    for name, site in sites.items():
        want = {k: np.asarray(v) for k, v in jparams[name].items()}
        q = want["kernel_q"]
        np.testing.assert_array_equal(site.weight_q.numpy(),
                                      q.transpose(3, 2, 0, 1) if q.ndim == 4 else q.T)
        for leaf, got in (("kernel_scale", site.weight_scale), ("act_scale", site.act_scale),
                          ("act_qmul", site.act_qmul), ("bias", site.bias)):
            assert (got is None) == (leaf not in want), (name, leaf)
            if got is not None:
                np.testing.assert_allclose(got.numpy(), want[leaf], rtol=1e-6, atol=0)


def int8_txt2img_pair(j, t, seed: int = 7):
    """The JAX and port pipelines' 3-step CFG 7.5 txt2img (image, latent), the
    port's roundings replayed from the JAX run."""
    replay = Int8Replay()
    with replay.recording():
        want = j.generate_image(j._encode_text_dev("hello world"), num_steps=3, seed=seed,
                                unconditional_guidance_scale=7.5, guidance_rescale=0.7,
                                return_latent=True)
    with replay.replaying():
        got = t.text_to_image("hello world", num_steps=3, seed=seed, return_latent=True)
    return got, want, replay


def assert_int8_image(got, want):
    (img, lat), (want_img, want_lat) = got, want
    assert img.shape == want_img.shape == (1, 64, 64, 3) and img.dtype == np.uint8
    assert np.isfinite(lat).all()
    print(f"int8 latent max |diff| {np.abs(lat - want_lat).max():.3e} (max |latent| "
          f"{np.abs(want_lat).max():.3f}), image max |diff| "
          f"{np.abs(img.astype(int) - want_img.astype(int)).max()}")
    np.testing.assert_allclose(lat, want_lat, rtol=INT8_LATENT_TOL, atol=INT8_LATENT_TOL)
    assert np.abs(img.astype(int) - want_img.astype(int)).max() <= 1


def to_jax_params(*modules) -> dict:
    """The JAX package's flat params of the port's unfused ``modules``, merged
    into one dict (a VAE's encoder and decoder make the JAX VAE's): conv kernels
    HWIO, dense kernels ``(in, out)``, norm ``scale`` / ``bias``, ``embedding``
    tables. :func:`from_jax` inverted, and checked by converting back."""
    params = {}
    for module in modules:
        own = {}
        for name, m in module.named_modules():
            w = None if not hasattr(m, "weight") else m.weight.detach().numpy()
            if isinstance(m, torch.nn.Conv2d):
                own[name] = {"kernel": w.transpose(2, 3, 1, 0)}
            elif isinstance(m, torch.nn.Linear):
                own[name] = {"kernel": w.T}
            elif isinstance(m, (torch.nn.GroupNorm, torch.nn.LayerNorm)):
                own[name] = {"scale": w}
            elif isinstance(m, torch.nn.Embedding):
                own[name] = {"embedding": w}
            else:
                continue
            if getattr(m, "bias", None) is not None:
                own[name]["bias"] = m.bias.detach().numpy()
        own = {k: {leaf: np.ascontiguousarray(v) for leaf, v in leaves.items()}
               for k, leaves in own.items()}
        back = from_jax(own, module)
        assert all(torch.equal(back[k], v) for k, v in module.state_dict().items())
        params.update(own)
    return params


def seeded_jax_params() -> dict:
    """The JAX pipeline's params (``_unet_params``, ``_text_params``,
    ``_vae_params``, ``_controlnet_params``) of ``torch_parallel_ranks.seeded_modules``."""
    import torch_parallel_ranks

    m = torch_parallel_ranks.seeded_modules()
    return {"_unet_params": to_jax_params(m["_unet"]),
            "_text_params": to_jax_params(m["_text_model"]),
            "_vae_params": to_jax_params(m["_encoder"], m["_decoder"]),
            "_controlnet_params": to_jax_params(m["_controlnet"])}


def jax_mesh_pipeline(params: dict, bpe: str, size: int, data: int, model: int, **kw):
    """The JAX pipeline on a (data, model) mesh of the first data * model virtual
    devices, fp32, ``size`` x ``size``, holding ``params`` placed by the JAX
    package's own rules: replicated under ``sequence_parallel``, else TP-sharded."""
    from minsdtf_tpu.parallel import mesh as jmesh
    from minsdtf_tpu.parallel import sharding as jsharding

    mesh = jmesh.make_mesh(data=data, model=model, devices=jax.devices()[:data * model])
    j = JaxStableDiffusion(size, size, compute_dtype=jnp.float32, bpe_path=bpe, mesh=mesh, **kw)
    place = jsharding.replicate_params if j.sequence_parallel else jsharding.shard_params
    for name, p in params.items():
        setattr(j, name, place(p, mesh))
    return j


def jax_generate(j, method: str = "text_to_image", **kw):
    """``(image, latent)`` of the JAX pipeline ``j``'s entry point ``method`` on
    "hello world", 3 steps, seed 7: its ``generate_image`` with the entry points'
    ``guidance_rescale=0.7``, since they return no latent."""
    assert method in ("text_to_image", "image_to_image", "inpaint")
    return j.generate_image(j._encode_text_dev("hello world"), guidance_rescale=0.7, num_steps=3,
                            seed=7, return_latent=True, **kw)
