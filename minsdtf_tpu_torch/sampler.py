"""The DDIM + classifier-free-guidance denoising loop, as a Python step loop.

Per step: the UNet on the batched CFG pair (batch 2B; two calls when the cond and
uncond context lengths differ), the CFG combine and std-matching rescale
(arXiv:2305.08891 §3.4), and the DDIM row update from
:class:`minsdtf_tpu_torch.scheduler.DenoiseSchedule`. Then the VAE decode and
``(x + 1) / 2 -> clip -> uint8``.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch


def rescale_noise_cfg(noise_cfg, noise_pred_text, guidance_rescale: float, epsilon: float = 1e-5):
    """Std-matching CFG rescale; the identity when ``guidance_rescale == 0``."""
    dims = tuple(range(1, noise_cfg.dim()))
    std_text = noise_pred_text.float().std(dim=dims, keepdim=True, correction=0)
    std_cfg = noise_cfg.float().std(dim=dims, keepdim=True, correction=0) + epsilon
    rescaled = noise_cfg * (std_text / std_cfg).to(noise_cfg.dtype)
    return guidance_rescale * rescaled + (1.0 - guidance_rescale) * noise_cfg


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
):
    """Returns ``(image uint8 (B, 8h, 8w, 3), latent (B, h, w, 4))``; the image is
    None when ``decoder`` is None."""
    dtype = latent0.dtype
    batch = latent0.shape[0]
    use_cfg = uncond_context is not None
    context = context.to(dtype).expand(batch, -1, -1)
    if use_cfg:
        uncond_context = uncond_context.to(dtype).expand(batch, -1, -1)
    cfg_batched = use_cfg and uncond_context.shape[1] == context.shape[1]
    ctx_pair = torch.cat([uncond_context, context]) if cfg_batched else context
    t_embs = t_embs.to(dtype)
    # the CFG scalars rounded to the compute dtype, as the JAX sampler casts them
    guidance_scale, guidance_rescale = (
        torch.tensor(s, dtype=dtype).item() for s in (guidance_scale, guidance_rescale))
    rows = {k: [float(x) for x in np.asarray(v, np.float32)] for k, v in rows.items()}

    latent = latent0
    for i in range(t_embs.shape[0]):
        t_emb = t_embs[i][None]
        if not use_cfg:
            eps = unet(latent, t_emb.expand(batch, -1), context)
        else:
            if cfg_batched:
                out = unet(torch.cat([latent, latent]), t_emb.expand(2 * batch, -1), ctx_pair)
                uncond, cond = out.chunk(2)
            else:
                uncond = unet(latent, t_emb.expand(batch, -1), uncond_context)
                cond = unet(latent, t_emb.expand(batch, -1), context)
            merged = uncond + guidance_scale * (cond - uncond)
            eps = rescale_noise_cfg(merged, cond, guidance_rescale)
        eps = eps.float()
        lat32 = latent.float()
        x0 = (lat32 - rows["nr_t"][i] * eps) / rows["sr_t"][i]
        if rows["is_last"][i] > 0:
            new = x0
        else:
            new = rows["sr_prev"][i] * x0 + rows["nr_prev"][i] * eps
        latent = new.to(dtype)

    if decoder is None:
        return None, latent
    image = (decoder(latent).float() + 1.0) * 0.5
    return (image * 255.0).clamp(0.0, 255.0).to(torch.uint8), latent
