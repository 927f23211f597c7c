"""The DDIM + classifier-free-guidance denoising loop, as a Python step loop.

Per step: the UNet (after the ControlNet, when one is given) on the batched CFG
pair (batch 2B; two calls when the cond and uncond context lengths differ), the
CFG combine and std-matching rescale (arXiv:2305.08891 §3.4), the DDIM row update
from :class:`minsdtf_tpu_torch.scheduler.DenoiseSchedule`, and for inpaint the
latent blend. Then the VAE decode, the inpaint pixel blend and
``(x + 1) / 2 -> clip -> uint8``.
"""

from __future__ import annotations

from typing import Callable, Mapping, NamedTuple, Optional

import numpy as np
import torch


def rescale_noise_cfg(noise_cfg, noise_pred_text, guidance_rescale: float, epsilon: float = 1e-5):
    """Std-matching CFG rescale; the identity when ``guidance_rescale == 0``."""
    dims = tuple(range(1, noise_cfg.dim()))
    std_text = noise_pred_text.float().std(dim=dims, keepdim=True, correction=0)
    std_cfg = noise_cfg.float().std(dim=dims, keepdim=True, correction=0) + epsilon
    rescaled = noise_cfg * (std_text / std_cfg).to(noise_cfg.dtype)
    return guidance_rescale * rescaled + (1.0 - guidance_rescale) * noise_cfg


class Inpaint(NamedTuple):
    """What the inpaint blends take; each tensor fp32 and NHWC, batch 1 or B."""
    init_latent: torch.Tensor   # (1|B, h, w, 4), the encoded reference image
    noise: torch.Tensor         # (B, h, w, 4), the initial noise, reused every step
    latent_mask: torch.Tensor   # (1, h, w, 1), 1 = generate
    image01: torch.Tensor       # (1, H, W, 3), the reference image in [0, 1]
    pixel_mask: torch.Tensor    # (1, H, W, 1)


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
):
    """Returns ``(image uint8 (B, 8h, 8w, 3), latent (B, h, w, 4))``; the image is
    None when ``decoder`` is None. With ``controlnet``, each UNet call takes its
    residuals for the same inputs and ``hint``. With ``inpaint``, each step's new
    latent outside the mask is the reference latent noised to the step's t, and the
    decoded image outside the pixel mask is the reference image. ``callback(step)``
    is called after each step, from 1."""
    dtype = latent0.dtype
    batch = latent0.shape[0]
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
    for i in range(t_embs.shape[0]):
        t_emb = t_embs[i][None]
        if not use_cfg:
            eps = one_pass(latent, t_emb.expand(batch, -1), context, hint)
        else:
            if cfg_batched:
                out = one_pass(torch.cat([latent, latent]), t_emb.expand(2 * batch, -1),
                               ctx_pair, hint_pair)
                uncond, cond = out.chunk(2)
            else:
                uncond = one_pass(latent, t_emb.expand(batch, -1), uncond_context, hint)
                cond = one_pass(latent, t_emb.expand(batch, -1), context, hint)
            merged = uncond + guidance_scale * (cond - uncond)
            eps = rescale_noise_cfg(merged, cond, guidance_rescale)
        eps = eps.float()
        lat32 = latent.float()
        x0 = (lat32 - rows["nr_t"][i] * eps) / rows["sr_t"][i]
        if rows["is_last"][i] > 0:
            new = x0
        else:
            new = rows["sr_prev"][i] * x0 + rows["nr_prev"][i] * eps
        if inpaint is not None:
            # the reference latent noised to the *current* t with the same noise
            # every step, blended in fp32 before the cast
            origin = rows["sr_t"][i] * inpaint.init_latent + rows["nr_t"][i] * inpaint.noise
            m = inpaint.latent_mask
            new = origin * (1.0 - m) + new * m
        latent = new.to(dtype)
        if callback is not None:
            callback(i + 1)

    if decoder is None:
        return None, latent
    image = (decoder(latent).float() + 1.0) * 0.5
    if inpaint is not None:
        pm = inpaint.pixel_mask
        image = inpaint.image01 * (1.0 - pm) + image * pm
    return (image * 255.0).clamp(0.0, 255.0).to(torch.uint8), latent
