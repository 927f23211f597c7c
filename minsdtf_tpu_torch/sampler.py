"""The classifier-free-guidance denoising loop, as a Python step loop.

Per step: the UNet (after the ControlNet, when one is given) on the batched CFG
pair (batch 2B; two calls when the cond and uncond context lengths differ), the
CFG combine and std-matching rescale (arXiv:2305.08891 §3.4), for v-prediction
the conversion of v to (x0, eps), the update of the schedule's mode (DDIM, TCD,
LCM, DPM-Solver++(2M) or Euler-a) from the rows of
:class:`minsdtf_tpu_torch.scheduler.DenoiseSchedule`, and for inpaint the latent
blend. Then the VAE decode, the inpaint pixel blend and
``(x + 1) / 2 -> clip -> uint8``.

The stochastic updates (LCM, Euler-a, TCD with eta > 0) take their per-step
noise from ``step_noise``, drawn by the caller before the loop.
"""

from __future__ import annotations

from typing import Callable, Mapping, NamedTuple, Optional

import numpy as np
import torch

from minsdtf_tpu_torch.ops.basic import stats_dtype
from minsdtf_tpu_torch.scheduler import MODES


def rescale_noise_cfg(noise_cfg, noise_pred_text, guidance_rescale: float, epsilon: float = 1e-5):
    """Std-matching CFG rescale; the identity when ``guidance_rescale == 0``."""
    dims = tuple(range(1, noise_cfg.dim()))
    wide = stats_dtype(noise_cfg.dtype)
    std_text = noise_pred_text.to(wide).std(dim=dims, keepdim=True, correction=0)
    std_cfg = noise_cfg.to(wide).std(dim=dims, keepdim=True, correction=0) + epsilon
    rescaled = noise_cfg * (std_text / std_cfg).to(noise_cfg.dtype)
    return guidance_rescale * rescaled + (1.0 - guidance_rescale) * noise_cfg


class Inpaint(NamedTuple):
    """What the inpaint blends take; each tensor fp32 and NHWC, batch 1 or B."""
    init_latent: torch.Tensor   # (1|B, h, w, 4), the encoded reference image
    noise: torch.Tensor         # (B, h, w, 4), the initial noise, reused every step
    latent_mask: torch.Tensor   # (1, h, w, 1), 1 = generate
    image01: torch.Tensor       # (1, H, W, 3), the reference image in [0, 1]
    pixel_mask: torch.Tensor    # (1, H, W, 1)


NOISY_MODES = ("lcm", "euler_a")  # modes that need step_noise; TCD takes it optionally


@torch.inference_mode()
def generate(
    unet,
    decoder,
    latent0: torch.Tensor,                   # (B, h, w, 4) in the compute dtype
    context: torch.Tensor,                   # (B or 1, S, 768)
    uncond_context: Optional[torch.Tensor],  # (B or 1, S', 768); None = no CFG
    t_embs: torch.Tensor,                    # (n, 320) timestep embeddings
    rows: Mapping[str, np.ndarray],          # DenoiseSchedule rows, each (n,)
    guidance_scale: float,
    guidance_rescale: float,
    controlnet=None,
    hint: Optional[torch.Tensor] = None,     # (B, 320, h, w) HintNet output, with controlnet
    inpaint: Optional[Inpaint] = None,
    callback: Optional[Callable[[int], None]] = None,
    mode: str = "ddim",                      # DenoiseSchedule.mode
    step_noise: Optional[torch.Tensor] = None,  # (n, B, h, w, 4) fp32 z per step
    v_prediction: bool = False,
    trace_latents: bool = False,
):
    """Returns ``(image uint8 (B, 8h, 8w, 3), latent (B, h, w, 4))``, and with
    ``trace_latents`` a third element, the fp32 ``(n, B, h, w, 4)`` latent after
    each step; the image is None when ``decoder`` is None. With ``controlnet``,
    each UNet call takes its residuals for the same inputs and ``hint``. With
    ``inpaint``, each step's new latent outside the mask is the reference latent
    noised to the step's t, and the decoded image outside the pixel mask is the
    reference image. ``callback(step)`` is called after each step, from 1.

    ``mode`` must be one of ``scheduler.MODES``; "lcm" and "euler_a" need
    ``step_noise``, and "tcd" re-noises only when it is given. With
    ``v_prediction`` the model predicts v = sr*eps - nr*x0; CFG acts on the raw
    v."""
    if mode not in MODES:
        raise ValueError(f"unknown sampler mode {mode!r}; one of {MODES}")
    if mode in NOISY_MODES and step_noise is None:
        raise ValueError(f"mode {mode!r} needs step_noise")
    dtype = latent0.dtype
    wide = stats_dtype(dtype)  # the update's dtype: fp32, fp64 in fp64
    batch = latent0.shape[0]
    n_steps = t_embs.shape[0]
    if step_noise is not None and tuple(step_noise.shape) != (n_steps, *latent0.shape):
        raise ValueError(f"step_noise is {tuple(step_noise.shape)}, not "
                         f"{(n_steps, *latent0.shape)}")
    use_cfg = uncond_context is not None
    context = context.to(dtype).expand(batch, -1, -1)
    if use_cfg:
        uncond_context = uncond_context.to(dtype).expand(batch, -1, -1)
    cfg_batched = use_cfg and uncond_context.shape[1] == context.shape[1]
    ctx_pair = torch.cat([uncond_context, context]) if cfg_batched else context
    if controlnet is not None:
        hint = hint.to(dtype)
    hint_pair = torch.cat([hint, hint]) if cfg_batched and controlnet is not None else hint
    t_embs = t_embs.to(dtype)
    # the CFG scalars rounded to the compute dtype, as the JAX sampler casts them
    guidance_scale, guidance_rescale = (
        torch.tensor(s, dtype=dtype).item() for s in (guidance_scale, guidance_rescale))
    rows = {k: [float(x) for x in np.asarray(v, np.float32)] for k, v in rows.items()}

    def one_pass(lat, t_emb, ctx, hint_in):
        controls = None if controlnet is None else controlnet(lat, t_emb, ctx, hint_in)
        return unet(lat, t_emb, ctx, controls)

    latent = latent0
    x0_prev = torch.zeros(latent0.shape, device=latent0.device) if mode == "dpm" else None
    trajectory = []
    for i in range(n_steps):
        t_emb = t_embs[i][None]
        if not use_cfg:
            out = one_pass(latent, t_emb.expand(batch, -1), context, hint)
        else:
            if cfg_batched:
                pair = one_pass(torch.cat([latent, latent]), t_emb.expand(2 * batch, -1),
                                ctx_pair, hint_pair)
                uncond, cond = pair.chunk(2)
            else:
                uncond = one_pass(latent, t_emb.expand(batch, -1), uncond_context, hint)
                cond = one_pass(latent, t_emb.expand(batch, -1), context, hint)
            merged = uncond + guidance_scale * (cond - uncond)
            out = rescale_noise_cfg(merged, cond, guidance_rescale)
        out = out.to(wide)
        lat32 = latent.to(wide)
        r = {k: v[i] for k, v in rows.items()}
        if v_prediction:
            # v = sr*eps - nr*x0  =>  x0 = sr*x - nr*v, eps = nr*x + sr*v
            x0 = r["sr_t"] * lat32 - r["nr_t"] * out
            eps = r["nr_t"] * lat32 + r["sr_t"] * out
        else:
            eps = out
            x0 = (lat32 - r["nr_t"] * eps) / r["sr_t"]
        last = r["is_last"] > 0
        z = None if step_noise is None else step_noise[i]
        if mode == "dpm":
            # the 2M combine with the fp32 x0 of the step before, taken before
            # the inpaint blend; w = 0 on the first and last steps
            d = (1.0 + r["w"]) * x0 - r["w"] * x0_prev
            new = r["c_x"] * lat32 + r["c_d"] * d
            x0_prev = x0
        elif mode == "lcm":
            denoised = r["c_out"] * x0 + r["c_skip"] * lat32
            new = denoised if last else r["sr_prev"] * denoised + r["nr_prev"] * z
        elif mode == "euler_a":
            new = x0 if last else r["c_x"] * lat32 + r["c_d"] * eps + r["c_noise"] * z
        elif mode == "tcd":
            denoised = r["sr_s"] * x0 + r["nr_s"] * eps
            new = denoised if last or z is None else r["c_denoised"] * denoised + r["c_noise"] * z
        else:
            new = x0 if last else r["sr_prev"] * x0 + r["nr_prev"] * eps
        if inpaint is not None:
            # the reference latent noised to the *current* t with the same noise
            # every step, blended in fp32 before the cast
            origin = r["sr_t"] * inpaint.init_latent + r["nr_t"] * inpaint.noise
            m = inpaint.latent_mask
            new = origin * (1.0 - m) + new * m
        latent = new.to(dtype)
        if trace_latents:
            trajectory.append(latent.to(wide))
        if callback is not None:
            callback(i + 1)
    traced = (torch.stack(trajectory),) if trace_latents else ()

    if decoder is None:
        return (None, latent, *traced)
    image = (decoder(latent).to(wide) + 1.0) * 0.5
    if inpaint is not None:
        pm = inpaint.pixel_mask
        image = inpaint.image01 * (1.0 - pm) + image * pm
    return ((image * 255.0).clamp(0.0, 255.0).to(torch.uint8), latent, *traced)
