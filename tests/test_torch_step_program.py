"""The card's step program (``minsdtf_tpu_torch.sampler._generate_program``) driven
through its static buffers on the CPU, where nothing is captured, against
``minsdtf_tpu.sampler.generate``: fp32 at small UNet widths, batch 2 under CFG, in
DDIM with the per-step trajectory and two guidance values on one program,
DPM-Solver++(2M) (the x0 carry), TCD with step noise, and inpaint with the decode
and unequal context lengths (two UNet calls a step). Then what the program cache
keys on: the attention route (``plain_scope``), the modules (``set_lora`` empties
a pipeline's cache), and what it does not: the guidance values and n_steps; and
the latent's layout in memory, which both paths keep NHWC."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minsdtf_tpu import sampler as jsampler
from minsdtf_tpu import scheduler as jsched
from minsdtf_tpu.models import unet as junet
from minsdtf_tpu.models import vae as jvae
from minsdtf_tpu_torch import StableDiffusion
from minsdtf_tpu_torch import sampler as tsampler
from minsdtf_tpu_torch import scheduler as tsched
from minsdtf_tpu_torch.models import unet as tunet
from minsdtf_tpu_torch.models import vae as tvae
from minsdtf_tpu_torch.ops import attention as tattn
from minsdtf_tpu_torch.weights.from_jax import split_vae
from torch_port_utils import JAX_SCHEDULERS, jax_step_noise, load, one_torch_thread  # noqa: F401

SAMPLER_TOL = 2e-4  # as tests/test_torch_samplers.py holds the loop against JAX
SMALL = dict(widths=(32, 64, 128, 128), temb_dim=128)
VAE_ENC, VAE_DEC = (32, 32, 64, 64), (64, 64, 32, 32)
STEPS = 4
SEED = 9


@pytest.fixture(scope="module")
def models():
    unet_p = junet.fuse_attention_projections(
        junet.init_params(jax.random.PRNGKey(0), dtype=jnp.float32, scale=0.04, **SMALL))
    vae_p = jvae.init_params(jax.random.PRNGKey(5), scale=0.04, enc_widths=VAE_ENC,
                             dec_widths=VAE_DEC)
    unet = load(tunet.fuse_attention_projections(tunet.UNet(**SMALL)), unet_p)
    decoder = load(tvae.VAEDecoder(VAE_DEC), split_vae(vae_p)[1])
    return unet_p, vae_p, unet, decoder


def _inputs(uncond_len=77):
    rs = np.random.RandomState(3)
    latent0 = rs.normal(0, 1, (2, 8, 8, 4)).astype(np.float32)
    ctx = rs.normal(0, 1, (2, 77, 768)).astype(np.float32)
    unc = rs.normal(0, 1, (1, uncond_len, 768)).astype(np.float32)
    return latent0, ctx, unc


def _inpaint_inputs():
    rs = np.random.RandomState(4)
    return dict(init_latent=rs.normal(0, 1, (1, 8, 8, 4)).astype(np.float32),
                blend_noise=rs.normal(0, 1, (2, 8, 8, 4)).astype(np.float32),
                latent_mask=(rs.uniform(size=(1, 8, 8, 1)) > 0.5).astype(np.float32),
                image_for_blend=rs.uniform(size=(1, 64, 64, 3)).astype(np.float32),
                pixel_mask=(rs.uniform(size=(1, 64, 64, 1)) > 0.5).astype(np.float32))


def _schedules(name, eta):
    schedule = tsched.build_denoise_schedule(tsched.make_scheduler(name), STEPS, eta=eta)
    jschedule = jsched.build_denoise_schedule(JAX_SCHEDULERS[name](), STEPS, eta=eta)
    jrows = {k: np.asarray(getattr(jschedule, k), np.float32) for k in tsched.ROW_KEYS}
    return schedule, jrows


def _program(unet, decoder, schedule, inputs, guidance, programs, **kw):
    latent0, ctx, unc = (torch.from_numpy(a) for a in inputs)
    t_embs = torch.from_numpy(tsched.timestep_embedding(schedule.timesteps, dim=32))
    # oneDNN's fp32 convolutions sum in another order than XLA's (test_torch_samplers.py)
    with torch.backends.mkldnn.flags(enabled=False):
        return tsampler._generate_program(
            unet, decoder, latent0, ctx, unc, t_embs, schedule.rows, guidance, 0.7,
            mode=schedule.mode, programs=programs, **kw)


def _jax(unet_p, vae_p, schedule, jrows, inputs, guidance, **kw):
    latent0, ctx, unc = (jnp.asarray(a) for a in inputs)
    t_embs = tsched.timestep_embedding(schedule.timesteps, dim=32)
    mode = schedule.mode
    flags = dict(use_cfg=True, active_tcd=mode == "tcd", stochastic="noise_key" in kw,
                 lcm=False, dpm=mode == "dpm", euler_a=False, use_controls=False,
                 use_inpaint="init_latent" in kw, decode=vae_p is not None)
    return jsampler.generate(unet_p, vae_p, latent0, ctx, unc, jnp.asarray(t_embs), jrows,
                             jnp.float32(guidance), jnp.float32(0.7), **flags, **kw)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=SAMPLER_TOL,
                               atol=SAMPLER_TOL)


def test_ddim_program_at_two_guidance_values_matches_jax(models):
    """One program serves both values (the scale and rescale are buffers), each
    equal to JAX's at its value; the trajectory is JAX's too."""
    unet_p, _, unet, _ = models
    schedule, jrows = _schedules("ddim", 0.3)
    inputs = _inputs()
    programs = tsampler.ProgramCache()
    for guidance in (7.5, 5.0):
        got = _program(unet, None, schedule, inputs, guidance, programs, trace_latents=True)
        want = _jax(unet_p, None, schedule, jrows, inputs, guidance, trace_latents=True)
        assert got[0] is None and len(got) == 3
        _close(got[1], want[1])
        assert got[2].shape == (STEPS, 2, 8, 8, 4)
        _close(got[2], want[2])
        np.testing.assert_array_equal(got[2][-1].numpy(), got[1].numpy())
    assert programs.builds == 1 and len(programs.programs) == 1


def test_dpm_program_carries_x0_as_jax_does(models):
    unet_p, _, unet, _ = models
    schedule, jrows = _schedules("dpm", 0.3)
    inputs = _inputs()
    programs = tsampler.ProgramCache()
    got = _program(unet, None, schedule, inputs, 7.5, programs)
    _close(got[1], _jax(unet_p, None, schedule, jrows, inputs, 7.5)[1])
    # a second call starts from a zero carry again
    again = _program(unet, None, schedule, inputs, 7.5, programs)
    np.testing.assert_array_equal(again[1].numpy(), got[1].numpy())
    assert programs.builds == 1


def test_tcd_program_with_step_noise_matches_jax(models):
    """CFG 3, as tests/test_torch_samplers.py runs the samplers that start at t = 999."""
    unet_p, _, unet, _ = models
    schedule, jrows = _schedules("tcd", 0.3)
    inputs = _inputs()
    step_noise = jax_step_noise(SEED, (STEPS, 2, 8, 8, 4))
    got = _program(unet, None, schedule, inputs, 3.0, tsampler.ProgramCache(),
                   step_noise=step_noise)
    want = _jax(unet_p, None, schedule, jrows, inputs, 3.0,
                noise_key=jax.random.fold_in(jax.random.PRNGKey(SEED), 1))
    _close(got[1], want[1])


def test_inpaint_program_with_two_unet_calls_and_the_decode_matches_jax(models):
    """The unconditional context is 154 tokens against the prompt's 77, so each
    step makes two UNet calls; the decode blends the reference outside the pixel
    mask."""
    unet_p, vae_p, unet, decoder = models
    schedule, jrows = _schedules("ddim", 0.3)
    inputs = _inputs(uncond_len=154)
    blend = _inpaint_inputs()
    inpaint = tsampler.Inpaint(*(torch.from_numpy(blend[k]) for k in (
        "init_latent", "blend_noise", "latent_mask", "image_for_blend", "pixel_mask")))
    got = _program(unet, decoder, schedule, inputs, 7.5, tsampler.ProgramCache(),
                   inpaint=inpaint)
    want = _jax(unet_p, vae_p, schedule, jrows, inputs, 7.5,
                **{k: jnp.asarray(v) for k, v in blend.items()})
    _close(got[1], want[1])
    image, want_image = got[0].numpy(), np.asarray(want[0])
    assert image.shape == want_image.shape == (2, 64, 64, 3) and image.dtype == np.uint8
    assert int(np.abs(image.astype(int) - want_image.astype(int)).max()) <= 1
    keep = blend["pixel_mask"][0, ..., 0] == 0
    reference = np.clip(blend["image_for_blend"][0] * 255.0, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(image[:, keep], np.broadcast_to(reference[keep], image[:, keep].shape))


def _small_call(unet, programs, num_steps=2, guidance=7.5, callback=None):
    schedule = tsched.build_denoise_schedule(tsched.make_scheduler("ddim"), num_steps)
    return _program(unet, None, schedule, _inputs(), guidance, programs, callback=callback)


def test_the_key_changes_with_the_attention_route_not_with_guidance_or_steps(models):
    unet = models[2]
    programs = tsampler.ProgramCache()
    steps = []
    first = _small_call(unet, programs, callback=steps.append)
    assert steps == [1, 2]
    _small_call(unet, programs, num_steps=3, guidance=5.0)
    assert programs.builds == 1
    with tattn.plain_scope():
        plain = _small_call(unet, programs)
    assert programs.builds == 2 and len(programs.programs) == 2
    # on the CPU the plain route is the kernels' plain versions: the same latent
    np.testing.assert_allclose(plain[1].numpy(), first[1].numpy(), rtol=1e-5, atol=1e-5)


def test_the_cache_holds_its_size_least_recently_used_out_first(models):
    unet = models[2]
    programs = tsampler.ProgramCache(size=2)
    _small_call(unet, programs)
    with tattn.plain_scope():
        _small_call(unet, programs)
    _small_call(unet, programs)  # a hit makes the first the most recent
    keys = list(programs.programs)
    other = tunet.fuse_attention_projections(tunet.UNet(**SMALL)).eval()
    other.load_state_dict(unet.state_dict())
    _small_call(other, programs)  # another module: another program; the plain one goes
    assert programs.builds == 3 and list(programs.programs)[0] == keys[1]
    assert len(programs.programs) == 2


def test_set_lora_and_a_lazy_load_empty_the_pipelines_programs(models):
    unet = models[2]
    pipe = StableDiffusion(64, 64, compute_dtype=torch.float32, device="cpu")
    pipe._unet = unet
    _small_call(pipe.unet, pipe._programs)
    assert len(pipe._programs.programs) == 1
    pipe.set_lora(None)
    assert len(pipe._programs.programs) == 0 and pipe._unet is None
    # a lazy load replaces a module: the programs go too
    pipe._unet = unet
    _small_call(pipe.unet, pipe._programs)
    assert len(pipe._programs.programs) == 1
    assert pipe.decoder is not None  # built here: the random full-width decoder
    assert len(pipe._programs.programs) == 0
    # a module whose tensors moved gives another key, whatever its identity
    moved = tunet.fuse_attention_projections(tunet.UNet(**SMALL)).eval()
    moved.load_state_dict(unet.state_dict())
    before = tsampler._weights_key(moved)
    moved.conv_in.weight.data = moved.conv_in.weight.data.clone()
    assert tsampler._weights_key(moved) != before


def test_the_latent_is_nhwc_in_memory_whatever_the_inputs_layouts(models):
    """The VAE encoder's latent is NCHW in memory; the loop and the program both
    take it, the start latent and the step noise dense, so each step's latent is
    laid out as a program's buffer is and the decoder's convolutions run in one
    memory format on both paths."""
    unet = models[2]
    schedule = tsched.build_denoise_schedule(tsched.make_scheduler("tcd"), 2, eta=0.3)
    t_embs = torch.from_numpy(tsched.timestep_embedding(schedule.timesteps, dim=32))
    _, ctx, unc = (torch.from_numpy(a) for a in _inputs())
    gen = torch.Generator().manual_seed(0)
    nchw = torch.randn(2, 4, 8, 8, generator=gen).permute(0, 2, 3, 1)
    inpaint = tsampler.Inpaint(nchw[:1], torch.randn(2, 8, 8, 4, generator=gen),
                               torch.ones(1, 8, 8, 1), torch.rand(1, 64, 64, 3), torch.ones(1, 64, 64, 1))
    step_noise = torch.randn(2, 2, 4, 8, 8, generator=gen).permute(0, 1, 3, 4, 2)
    args = (unet, None, nchw, ctx, unc, t_embs, schedule.rows, 7.5, 0.7)
    kw = dict(inpaint=inpaint, mode="tcd", step_noise=step_noise, trace_latents=True)
    for got in (tsampler._generate_eager(*args, **kw),
                tsampler._generate_program(*args, programs=tsampler.ProgramCache(), **kw)):
        assert got[1].is_contiguous() and got[2].is_contiguous()


def test_row_table_carries_the_loops_host_arithmetic():
    """The rows in fp32 as the JAX sampler takes them, held in float64 so that an
    fp64 run keeps them exact; the body takes 1 + w and 1 / sr_t on the device,
    in the update's dtype."""
    schedule = tsched.build_denoise_schedule(tsched.make_scheduler("dpm"), 5)
    keys, table = tsampler.row_table(schedule.rows)
    assert table.dtype == np.float64 and table.shape == (5, len(schedule.rows))
    assert keys == tuple(sorted(schedule.rows))
    for k, col in zip(keys, table.T):
        np.testing.assert_array_equal(col, np.asarray(schedule.rows[k], np.float32))


def _threaded(unet, programs, seeds, guidance):
    """One 2-step DDIM call a seed, each on its own thread, all on ``programs``
    (oneDNN off for all of them: its switch is the process's)."""
    import threading

    schedule = tsched.build_denoise_schedule(tsched.make_scheduler("ddim"), 2)
    t_embs = torch.from_numpy(tsched.timestep_embedding(schedule.timesteps, dim=32))
    _, ctx, unc = (torch.from_numpy(a) for a in _inputs())
    got, errors = {}, []

    def call(seed):
        try:
            latent0 = torch.from_numpy(
                np.random.RandomState(seed).normal(0, 1, (2, 8, 8, 4)).astype(np.float32))
            got[seed] = tsampler._generate_program(
                unet, None, latent0, ctx, unc, t_embs, schedule.rows, guidance, 0.7,
                programs=programs)[1]
        except BaseException as e:  # noqa: BLE001 - raised below on the test's thread
            errors.append(e)

    threads = [threading.Thread(target=call, args=(seed,)) for seed in seeds]
    with torch.backends.mkldnn.flags(enabled=False):
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    return got


def test_threads_that_share_a_cache_each_get_their_own_image(models):
    """Calls of one signature share a program's buffers: the cache's lock makes
    threads take turns, so each gets the image it gets alone."""
    unet = models[2]
    seeds = (11, 12, 13)
    alone = {seed: _threaded(unet, tsampler.ProgramCache(), (seed,), 7.5)[seed] for seed in seeds}
    programs = tsampler.ProgramCache()
    for _ in range(2):
        together = _threaded(unet, programs, seeds, 7.5)
        for seed in seeds:
            np.testing.assert_array_equal(together[seed].numpy(), alone[seed].numpy())
    assert programs.builds == 1


def test_a_callback_that_raises_keeps_the_program(models):
    """Only a failed capture drops a program: a callback that cancels the image,
    or a replay that raises, leaves it for the next call."""
    unet = models[2]
    programs = tsampler.ProgramCache()

    def cancel(step):
        raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        _small_call(unet, programs, callback=cancel)
    assert len(programs.programs) == 1
    _small_call(unet, programs)
    assert programs.builds == 1
