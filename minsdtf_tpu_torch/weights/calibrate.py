"""Static activation-scale calibration for the W8A8 int8 path.

The port's copy of the JAX package's ``weights/calibrate.py``. Dynamic activation
quantization (:func:`minsdtf_tpu_torch.ops.basic._quantize_acts`) takes the amax
of every int8 site's input at every call. Calibration runs the real denoising
trajectory once with dynamic scales, records each site's activation statistics,
and :func:`bake_act_scales` stores ``act_scale = margin * amax / 127`` on the
stable sites, whose quantization then is one clipped round.

Each int8 site knows its name, so one pass records (name, statistics) in call
order on the calibration tape (:func:`minsdtf_tpu_torch.ops.basic.set_calibration_tape`);
the JAX package's separate name pass through ``jax.eval_shape`` has no
counterpart here. The ``.npz`` schema of :func:`save_scales` / :func:`load_scales`
is the JAX package's, so each package reads what the other writes.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from minsdtf_tpu_torch.models.common import Int8Site
from minsdtf_tpu_torch.ops import basic

_CH_KEYS = ("ch_amax", "ch_mean", "ch_msq")


def _fp32(a) -> torch.Tensor:
    """``a`` (numpy or a tensor on any device) as an fp32 tensor."""
    if isinstance(a, torch.Tensor):
        return a.float()
    return torch.as_tensor(np.asarray(a, np.float32))


@torch.inference_mode()
def _instrumented_step(unet: nn.Module, lat, te, ctx) -> tuple:
    """One UNet call with the tape on: ``(eps, names, scalars, channel stats)``;
    the statistics come to the host in two transfers, packed as
    ``[amax..., out_msq...]`` and the concatenated per-channel rows."""
    tape: list = []
    basic.set_calibration_tape(tape)
    try:
        eps = unet(lat, te, ctx)
    finally:
        basic.set_calibration_tape(None)
    scalars = torch.stack([v["amax"] for v in tape] + [v["out_msq"] for v in tape])
    chcat = torch.cat([v[k] for v in tape for k in _CH_KEYS])
    sizes = [int(v["ch_amax"].numel()) for v in tape]
    return (eps.float().cpu().numpy(), [v["name"] for v in tape], sizes,
            scalars.cpu().numpy(), chcat.cpu().numpy())


def collect_unet_amax(
    unet: nn.Module,
    latent0: torch.Tensor,        # (B, h, w, 4) initial noise latent, compute dtype
    context,                      # (B, S, 768)
    uncond_context,               # (B, S, 768)
    t_embs,                       # (n, 320)
    rows: dict,                   # host DenoiseSchedule coefficient rows, each (n,)
    guidance_scale: float = 7.5,
    guidance_rescale: float = 0.7,
) -> Dict[str, dict]:
    """Run the CFG + rescale + DDIM txt2img trajectory with the UNet's int8 sites
    on dynamic scales and return per-site statistics: ``amax`` (the max over the
    steps), ``ratio`` (max / min over the steps: the stability that gates baking),
    and per input channel ``ch_amax`` (max), ``ch_mean`` and ``ch_msq`` (averaged
    over the steps), and ``out_msq`` of the output before the bias. The per-channel
    statistics are over (N, H, W) of a conv's NCHW input and over every axis but
    the last of a dense input. The UNet runs on its device in ``latent0``'s dtype;
    the guidance and the update run on the host in fp32 numpy, as in the JAX
    package."""
    device = next(unet.parameters()).device
    dtype = latent0.dtype
    b = latent0.shape[0]
    ctx_pair = torch.cat([_fp32(uncond_context).to(device),
                          _fp32(context).to(device)]).to(dtype)
    t_embs = _fp32(t_embs).cpu().numpy()

    latent = latent0.float().cpu().numpy()
    acc: Optional[list] = None  # per-site running statistics across steps
    names = None
    n_steps = t_embs.shape[0]
    for i in range(n_steps):
        lat_in = torch.from_numpy(np.concatenate([latent, latent], axis=0)).to(device, dtype)
        te = torch.from_numpy(t_embs[i]).to(device, dtype)[None].expand(2 * b, -1)
        eps_pair, names, sizes, scalars, chcat = _instrumented_step(unet, lat_in, te, ctx_pair)
        n = len(names)
        offsets = np.cumsum([0] + [3 * s for s in sizes])
        vals = []
        for j in range(n):
            s = sizes[j]
            block = chcat[offsets[j]:offsets[j + 1]]
            vals.append({
                "amax": float(scalars[j]),
                "out_msq": float(scalars[n + j]),
                "ch_amax": block[:s].copy(),
                "ch_mean": block[s:2 * s].copy(),
                "ch_msq": block[2 * s:].copy(),
            })
        if acc is None:
            acc = [dict(v, amin=v["amax"]) for v in vals]
        else:
            for cur, v in zip(acc, vals):
                cur["amax"] = max(cur["amax"], v["amax"])
                cur["amin"] = min(cur["amin"], v["amax"])
                np.maximum(cur["ch_amax"], v["ch_amax"], out=cur["ch_amax"])
                cur["ch_mean"] += v["ch_mean"]
                cur["ch_msq"] += v["ch_msq"]
                cur["out_msq"] += v["out_msq"]
        uncond_eps, cond_eps = eps_pair[:b], eps_pair[b:]
        eps = uncond_eps + guidance_scale * (cond_eps - uncond_eps)
        if guidance_rescale > 0:
            std_t = np.std(cond_eps, axis=(1, 2, 3), keepdims=True)
            std_c = np.std(eps, axis=(1, 2, 3), keepdims=True) + 1e-5
            eps = guidance_rescale * (eps * std_t / std_c) + (1 - guidance_rescale) * eps
        x0 = (latent - rows["nr_t"][i] * eps) / rows["sr_t"][i]
        if rows["is_last"][i]:
            latent = x0.astype(np.float32)
        else:
            latent = (rows["sr_prev"][i] * x0 + rows["nr_prev"][i] * eps).astype(np.float32)

    out: Dict[str, dict] = {}
    for name, site in zip(names, acc):
        cur = out.get(name)
        if cur is None:
            out[name] = {
                "amax": site["amax"],
                "amin": site["amin"],
                "ch_amax": site["ch_amax"].copy(),
                "ch_mean": site["ch_mean"] / n_steps,
                "ch_msq": site["ch_msq"] / n_steps,
                "out_msq": site["out_msq"] / n_steps,
            }
        else:
            # a site called more than once a step (none in the UNet; the tape is
            # in call order, not keyed by name): folded conservatively
            cur["amax"] = max(cur["amax"], site["amax"])
            cur["amin"] = min(cur["amin"], site["amin"])
            np.maximum(cur["ch_amax"], site["ch_amax"], out=cur["ch_amax"])
            cur["ch_mean"] = (cur["ch_mean"] + site["ch_mean"] / n_steps) / 2.0
            cur["ch_msq"] = (cur["ch_msq"] + site["ch_msq"] / n_steps) / 2.0
            cur["out_msq"] = (cur["out_msq"] + site["out_msq"] / n_steps) / 2.0
    for cur in out.values():
        cur["ratio"] = cur["amax"] / max(cur.pop("amin"), 1e-9)
    return out


def bake_act_scales(
    model: nn.Module,
    amax_by_name: Dict[str, object],
    margin: float = 1.05,
    include_dense: bool = False,
    stability_threshold: float = 1.5,
) -> nn.Module:
    """Set ``act_scale = max(amax, 1e-12) * margin / 127`` on every calibrated int8
    site of ``model``, in place; returns ``model``. Dense sites keep per-token
    dynamic scales unless ``include_dense``, and sites whose amax swings more than
    ``stability_threshold`` across the steps (the convs fed by the un-normalized
    residual stream) stay dynamic. ``amax_by_name`` also takes plain floats (no
    ratio: always baked, subject to ``include_dense``)."""
    for name, site in model.named_modules():
        stats = amax_by_name.get(name)
        if stats is None or not isinstance(site, Int8Site):
            continue
        if isinstance(stats, dict):
            amax, ratio = stats["amax"], stats.get("ratio", 1.0)
        else:
            amax, ratio = float(stats), 1.0
        if not include_dense and not site.is_conv:
            continue
        if ratio > stability_threshold:
            continue
        site.act_scale = torch.tensor(np.float32(max(amax, 1e-12) * margin / 127.0),
                                      device=site.weight_q.device)
    return model


def merge_stats(into: Dict[str, dict], new: Dict[str, dict]) -> None:
    """Fold a second calibration run (another seed or prompt) into ``into`` in
    place: worst-case maxima, the union's stability ratio, averaged moments."""
    for k, v in new.items():
        cur = into.get(k)
        if cur is None:
            into[k] = dict(v)
            continue
        amin = min(cur["amax"] / cur.get("ratio", 1.0),
                   v["amax"] / v.get("ratio", 1.0))
        cur["amax"] = max(cur["amax"], v["amax"])
        cur["ratio"] = cur["amax"] / max(amin, 1e-9)
        if "ch_amax" in cur and "ch_amax" in v:
            cur["ch_amax"] = np.maximum(cur["ch_amax"], v["ch_amax"])
            cur["ch_mean"] = (cur["ch_mean"] + v["ch_mean"]) / 2.0
            cur["ch_msq"] = (cur["ch_msq"] + v["ch_msq"]) / 2.0
            cur["out_msq"] = (cur.get("out_msq", 0.0) + v.get("out_msq", 0.0)) / 2.0


def save_scales(path: str, amax_by_name: Dict[str, dict]) -> None:
    """npz: one float32[2] = (amax, ratio) per site (plain floats saved as ratio
    1); sites with per-channel statistics add ``{name}::ch``, a float32 (3, C)
    array of rows (ch_amax, ch_mean, ch_msq), and ``{name}::out_msq``."""
    arrs = {}
    for k, v in amax_by_name.items():
        if isinstance(v, dict):
            arrs[k] = np.asarray([v["amax"], v.get("ratio", 1.0)], np.float32)
            if "ch_amax" in v:
                arrs[k + "::ch"] = np.stack(
                    [v["ch_amax"], v["ch_mean"], v["ch_msq"]]).astype(np.float32)
                arrs[k + "::out_msq"] = np.float32(v.get("out_msq", 0.0))
        else:
            arrs[k] = np.asarray([float(v), 1.0], np.float32)
    np.savez(path, **arrs)


def load_scales(path: str) -> Dict[str, dict]:
    with np.load(path) as z:
        out = {}
        for k in z.files:
            if "::" in k:
                continue
            a = np.atleast_1d(z[k]).astype(np.float32)
            out[k] = {"amax": float(a[0]),
                      "ratio": float(a[1]) if a.size > 1 else 1.0}
            if k + "::ch" in z.files:
                ch = z[k + "::ch"].astype(np.float32)
                out[k]["ch_amax"], out[k]["ch_mean"], out[k]["ch_msq"] = ch
                out[k]["out_msq"] = float(z[k + "::out_msq"])
        return out
