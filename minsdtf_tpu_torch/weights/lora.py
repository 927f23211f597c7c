"""LoRA checkpoint -> per-module delta-W dicts, merged into base weights at load time
(a copy of the JAX package's ``weights/lora.py``).

Kohya-style keys (``lora_te_*`` / ``lora_unet_*`` with ``.alpha`` /
``.lora_down.weight`` / ``.lora_up.weight`` triplets); ``dW = (up @ down) * alpha /
rank`` with the conv 1x1 / kxk composition cases; names rewritten to diffusers
keys. The pipeline merges at load and switches at run time
(``StableDiffusion.set_lora``).

Returned dicts map ``<diffusers module>.weight`` -> numpy delta in torch layout
(out, in[, kh, kw]), ready for ``convert.build_state_dict(lora=...)``, which adds
the delta to the fp32 checkpoint tensor.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from minsdtf_tpu_torch.weights.convert import StateDict, read_state_dict

# Ordered rewrites from kohya underscore-names to diffusers dotted names. Longest /
# most-specific first where it matters.
_TE_REWRITES = [
    ("lora_te_text_model_encoder_layers_", "text_model.encoder.layers."),
    ("_mlp_fc1", ".mlp.fc1.weight"),
    ("_mlp_fc2", ".mlp.fc2.weight"),
    ("_self_attn_q_proj", ".self_attn.q_proj.weight"),
    ("_self_attn_k_proj", ".self_attn.k_proj.weight"),
    ("_self_attn_v_proj", ".self_attn.v_proj.weight"),
    ("_self_attn_out_proj", ".self_attn.out_proj.weight"),
]

_UNET_REWRITES = [
    ("lora_unet_", ""),
    ("down_blocks_", "down_blocks."),
    ("up_blocks_", "up_blocks."),
    ("mid_block_", "mid_block."),
    ("_resnets", ".resnets"),
    ("resnets_", "resnets."),
    ("_attentions", ".attentions"),
    ("attentions_", "attentions."),
    ("_transformer_blocks_", ".transformer_blocks."),
    ("_proj_in", ".proj_in.weight"),
    ("_proj_out", ".proj_out.weight"),
    ("_attn1_to_q", ".attn1.to_q.weight"),
    ("_attn1_to_k", ".attn1.to_k.weight"),
    ("_attn1_to_v", ".attn1.to_v.weight"),
    ("_attn1_to_out_0", ".attn1.to_out.0.weight"),
    ("_attn2_to_q", ".attn2.to_q.weight"),
    ("_attn2_to_k", ".attn2.to_k.weight"),
    ("_attn2_to_v", ".attn2.to_v.weight"),
    ("_attn2_to_out_0", ".attn2.to_out.0.weight"),
    ("_ff_net_0_proj", ".ff.net.0.proj.weight"),
    ("_ff_net_2", ".ff.net.2.weight"),
    ("_time_emb_proj", ".time_emb_proj.weight"),
    ("_conv_shortcut", ".conv_shortcut.weight"),
    ("_downsamplers_0_conv", ".downsamplers.0.conv.weight"),
    ("_upsamplers_0_conv", ".upsamplers.0.conv.weight"),
    ("_conv2", ".conv2.weight"),
    ("_conv1", ".conv1.weight"),
]


def _rewrite(name: str, rules) -> str:
    for old, new in rules:
        name = name.replace(old, new)
    return name


def compose_delta(up: np.ndarray, down: np.ndarray, alpha: float) -> np.ndarray:
    """dW in torch layout from the low-rank factors."""
    rank = float(up.shape[1])
    scale = float(alpha) / rank
    if down.ndim == 2:  # linear: (out,r) @ (r,in)
        w = up @ down
    elif down.shape[2:4] == (1, 1):  # conv 1x1
        w = (up[:, :, 0, 0] @ down[:, :, 0, 0])[:, :, None, None]
    else:  # conv kxk: up is (out,r,1,1); contract rank against down (r,in,kh,kw)
        w = np.einsum("or,rihw->oihw", up[:, :, 0, 0], down)
    return (w * scale).astype(np.float32)


def scale_lora(deltas: StateDict, scale: float) -> StateDict:
    """Scale a delta dict (LoRA strength knob; 1.0 = as trained)."""
    if scale == 1.0:
        return deltas
    return {k: v * np.float32(scale) for k, v in deltas.items()}


def load_lora(path_or_sd) -> Tuple[StateDict, StateDict]:
    """-> (text_encoder_deltas, unet_deltas), diffusers-keyed."""
    sd = read_state_dict(path_or_sd) if isinstance(path_or_sd, str) else path_or_sd
    te: StateDict = {}
    unet: StateDict = {}
    for key in list(sd.keys()):
        if not key.endswith(".alpha"):
            continue
        name = key[: -len(".alpha")]
        alpha = float(np.asarray(sd[key]).reshape(-1)[0])
        down = np.asarray(sd[f"{name}.lora_down.weight"], dtype=np.float32)
        up = np.asarray(sd[f"{name}.lora_up.weight"], dtype=np.float32)
        delta = compose_delta(up, down, alpha)
        if name.startswith("lora_te_text_model"):
            te[_rewrite(name, _TE_REWRITES)] = delta
        elif name.startswith("lora_unet_"):
            unet[_rewrite(name, _UNET_REWRITES)] = delta
    return te, unet
