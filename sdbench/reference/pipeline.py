"""Text to image in plain fp32 PyTorch: the reference a served image is held
against.

For one request (prompt, seed, size, batch, sampler, steps, guidance, rescale
and, with a ControlNet, the uint8 control image) it works out everything again
from those inputs: the prompt's tokens and weights, the CLIP context with the
weighted mean-preserving rescale, the unconditional context, the initial noise
of the seed, the sampler's schedule rows and its step noise, each step's guided
and rescaled noise estimate, and the decoded uint8 images.

Samplers: "ddim" (the deterministic update), "tcd" (with eta 0.3, the step
noise from a CPU ``torch.Generator`` seeded with the request's seed), "dpm" and
"dpm_karras" (DPM-Solver++(2M), data prediction, on the DDIM grid or the Karras
spacing snapped to the training grid).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import philox
from .text import UNCOND_IDS, BPE, prompt_rows

SAMPLERS = ("ddim", "tcd", "dpm", "dpm_karras")
TCD_ORIGINAL_STEPS = 50  # the distillation schedule TCD subsamples
TCD_ETA = 0.3            # ``text_to_image`` runs TCD at the library's default eta


def _alphas_cumprod(sched: dict) -> np.ndarray:
    n_train = sched["num_train_timesteps"]
    betas = np.linspace(np.sqrt(sched["beta_start"]), np.sqrt(sched["beta_end"]), n_train) ** 2
    return np.cumprod(1.0 - betas)


def _karras(steps: int, acp: np.ndarray, rho: float = 7.0) -> np.ndarray:
    """Karras et al.'s sigmas (arXiv:2206.00364, eq. 5), each snapped to the
    training timestep of the nearest sigma, pushed down where two collide."""
    sigmas = np.sqrt((1.0 - acp) / acp)
    lo, hi = sigmas[0] ** (1 / rho), sigmas[-1] ** (1 / rho)
    want = (hi + np.linspace(0, 1, steps) * (lo - hi)) ** rho
    ts = np.array([int(np.argmin(np.abs(sigmas - s))) for s in want], np.int64)
    for i in range(1, steps):
        ts[i] = min(ts[i], ts[i - 1] - 1)
    return ts


def timesteps(sampler: str, steps: int, sched: dict) -> np.ndarray:
    """The descending timesteps the UNet is called at."""
    n_train = sched["num_train_timesteps"]
    if sampler == "tcd":
        k = n_train // TCD_ORIGINAL_STEPS
        origin = (np.arange(1, TCD_ORIGINAL_STEPS + 1) * k - 1)[::-1]
        return origin[np.floor(np.arange(steps) * (TCD_ORIGINAL_STEPS / steps)).astype(np.int64)]
    if sampler == "dpm_karras":
        return _karras(steps, _alphas_cumprod(sched))
    return np.floor(np.arange(steps) * (n_train / steps)).astype(np.int64)[::-1]


def schedule_rows(sampler: str, steps: int, sched: dict):
    """(timesteps, [row of each step]): each row's coefficients, computed in
    float64 and rounded to fp32 as the update takes them."""
    if sampler not in SAMPLERS:
        raise ValueError(f"the reference has no sampler {sampler!r}; it has {SAMPLERS}")
    acp = _alphas_cumprod(sched)
    ts = timesteps(sampler, steps, sched)
    rows, prev_h = [], None
    for i, t in enumerate(ts):
        last = i == steps - 1
        prev = ts[i + 1] if not last else (0 if sampler == "tcd" else t)
        a_t, a_p = acp[t], acp[prev]
        row = {"sr": np.sqrt(a_t), "nr": np.sqrt(1 - a_t), "sr_prev": np.sqrt(a_p), "nr_prev": np.sqrt(1 - a_p)}
        if sampler == "tcd":
            a_s = acp[int(np.floor((1.0 - TCD_ETA) * prev))]
            row.update(sr_s=np.sqrt(a_s), nr_s=np.sqrt(1 - a_s), c_denoised=np.sqrt(a_p / a_s),
                       c_noise=np.sqrt(max(0.0, 1.0 - a_p / a_s)))
        elif sampler in ("dpm", "dpm_karras"):
            if last:
                row.update(c_x=0.0, c_d=1.0, w=0.0)
            else:
                h = float(np.log(np.sqrt(a_p) / np.sqrt(1 - a_p)) - np.log(np.sqrt(a_t) / np.sqrt(1 - a_t)))
                row.update(c_x=np.sqrt(1 - a_p) / np.sqrt(1 - a_t), c_d=np.sqrt(a_p) * (1.0 - np.exp(-h)),
                           w=0.0 if prev_h is None else h / (2.0 * prev_h))
                prev_h = h
        rows.append({k: float(np.float32(v)) for k, v in row.items()})
    return ts, rows


class Reference:
    """The models of one configuration in fp32 on ``device``, built from the
    benchmark's weights (``{kind: {name: tensor}}``)."""

    def __init__(self, cfg: dict, weights: dict, merges_path: str, device, ops=None):
        from .models import build  # noqa: PLC0415

        self.cfg, self.device = cfg, torch.device(device)
        self.bpe = BPE(merges_path)
        self.models = {}
        for kind, state in weights.items():
            model = build(kind, cfg, ops, device="meta")
            model.load_state_dict(state, strict=True, assign=True)
            self.models[kind] = model.to(self.device)

    @torch.no_grad()
    def context(self, prompt: str) -> torch.Tensor:
        tokens, weights = prompt_rows(self.bpe, prompt)
        clip = self.models["text_encoder"]
        ctx = clip(torch.tensor([tokens], device=self.device))
        prev = ctx.mean()
        ctx = ctx * torch.tensor(weights, device=self.device)[None, :, None]
        return ctx * (prev / ctx.mean())

    @torch.no_grad()
    def uncond(self) -> torch.Tensor:
        return self.models["text_encoder"](torch.tensor([UNCOND_IDS], device=self.device))

    @torch.no_grad()
    def generate(self, context: torch.Tensor, noise: np.ndarray, steps: int, guidance: float, rescale: float,
                 control: Optional[np.ndarray] = None, sampler: str = "ddim",
                 step_seed: Optional[int] = None) -> np.ndarray:
        """The uint8 (B, H, W, 3) images of the (B, h, w, 4) initial ``noise``
        under ``context`` ((1 or B), S, 768): guided with the unconditional
        context where ``guidance`` > 0, TCD's step noise from ``step_seed``."""
        dev = self.device
        x = torch.from_numpy(np.ascontiguousarray(noise)).to(dev).permute(0, 3, 1, 2).contiguous()
        batch = x.shape[0]
        cond = context.to(dev).expand(batch, -1, -1)
        guided = guidance > 0.0
        ctx = torch.cat([self.uncond().expand(batch, -1, -1), cond]) if guided else cond
        unet, cn = self.models["unet"], self.models.get("controlnet")
        hint = None
        if control is not None:
            image01 = torch.from_numpy(np.asarray(control, np.float32) / 255.0).to(dev)
            hint = cn.hint(image01.permute(2, 0, 1)[None]).expand(ctx.shape[0], -1, -1, -1)
        ts, rows = schedule_rows(sampler, steps, self.cfg["scheduler"])
        z = None
        if sampler == "tcd":
            gen = torch.Generator().manual_seed(int(step_seed))
            z = torch.randn((steps, batch, x.shape[2], x.shape[3], 4), generator=gen, dtype=torch.float32)
        x0_prev = None
        for i, t in enumerate(ts):
            r = rows[i]
            xx = torch.cat([x, x]) if guided else x
            tt = torch.full((xx.shape[0],), float(t), device=dev)
            controls = None if hint is None else cn(xx, tt, ctx, hint)
            out = unet(xx, tt, ctx, controls)
            if guided:
                eps_u, eps_c = out.chunk(2)
                eps = eps_u + guidance * (eps_c - eps_u)
                std_c = eps_c.std(dim=(1, 2, 3), keepdim=True, correction=0)
                std_g = eps.std(dim=(1, 2, 3), keepdim=True, correction=0) + 1e-5
                eps = rescale * (eps * std_c / std_g) + (1.0 - rescale) * eps
            else:
                eps = out
            x0 = (x - r["nr"] * eps) / r["sr"]
            last = i == steps - 1
            if sampler == "tcd":
                x = r["sr_s"] * x0 + r["nr_s"] * eps
                if not last:
                    x = r["c_denoised"] * x + r["c_noise"] * z[i].to(dev).permute(0, 3, 1, 2)
            elif sampler in ("dpm", "dpm_karras"):
                d = x0 if x0_prev is None else (1.0 + r["w"]) * x0 - r["w"] * x0_prev
                x, x0_prev = r["c_x"] * x + r["c_d"] * d, x0
            else:
                x = x0 if last else r["sr_prev"] * x0 + r["nr_prev"] * eps
        image = (self.models["vae"](x) + 1.0) * 0.5
        image = (image * 255.0).clamp(0.0, 255.0).to(torch.uint8)
        return image.permute(0, 2, 3, 1).cpu().numpy()

    def text_to_image(self, prompt: str, seed: int, height: int, width: int, steps: int,
                      guidance: float, rescale: float, control: Optional[np.ndarray] = None,
                      batch: int = 1, sampler: str = "ddim") -> np.ndarray:
        """The uint8 (B, H, W, 3) images of one request: the seed's noise rows for
        the whole batch, and the seed again for TCD's step noise."""
        noise = philox.stateless_normal((batch, height // 8, width // 8, 4), seed)
        return self.generate(self.context(prompt), noise, steps, guidance, rescale, control, sampler, seed)

    def request(self, req, mix: dict) -> np.ndarray:
        """The images of a ``traffic.Request`` of ``mix``."""
        return self.text_to_image(req.prompt, req.seed, mix["height"], mix["width"], req.steps, req.guidance,
                                  req.rescale, req.control, req.batch, mix.get("scheduler", "ddim"))

