"""Checkpoint key layouts -> the port's module names, generated from the block
structure (a copy of the JAX package's ``weights/mapping.py``; the port imports
nothing of that package).

Layouts handled:
  - UNet:     LDM ``model.diffusion_model.*``  ->  diffusers ``down_blocks.*`` etc.
  - VAE:      LDM ``first_stage_model.{encoder,decoder}.*`` -> diffusers
              ``encoder.down_blocks.*`` (the LDM decoder's ``up.{i}`` indices are
              reversed relative to diffusers ``up_blocks.{i}``).
  - CLIP:     LDM ``cond_stage_model.transformer.text_model.*`` -> ``text_model.*``
              (prefix strip).
  - ControlNet: LDM ``control_model.*`` (lllyasviel's ``.pth`` layout) -> diffusers
              controlnet names.

All mappings are **module-level** (no ``.weight``/``.bias`` suffix); the converter
appends leaf suffixes.
"""

from __future__ import annotations

from typing import Dict

# ---- inner-module name tables --------------------------------------------------------

_RESNET_INNER = {
    "in_layers.0": "norm1",
    "in_layers.2": "conv1",
    "emb_layers.1": "time_emb_proj",
    "out_layers.0": "norm2",
    "out_layers.3": "conv2",
    "skip_connection": "conv_shortcut",
}

_ATTN_INNER = (
    ["norm", "proj_in", "proj_out"]
    + [f"transformer_blocks.0.norm{i}" for i in (1, 2, 3)]
    + [f"transformer_blocks.0.attn{a}.{w}" for a in (1, 2) for w in ("to_q", "to_k", "to_v", "to_out.0")]
    + ["transformer_blocks.0.ff.net.0.proj", "transformer_blocks.0.ff.net.2"]
)

_VAE_RESNET_INNER = {
    "norm1": "norm1",
    "conv1": "conv1",
    "norm2": "norm2",
    "conv2": "conv2",
    "nin_shortcut": "conv_shortcut",
}

_VAE_ATTN_INNER = {
    "norm": "group_norm",
    "q": "to_q",
    "k": "to_k",
    "v": "to_v",
    "proj_out": "to_out.0",
}

# Old-diffusers VAE attention names (what sd-vae-ft-mse ships) -> the canonical names.
VAE_ATTN_ALTERNATES = {
    "to_q": "query",
    "to_k": "key",
    "to_v": "value",
    "to_out.0": "proj_attn",
}


def _unet_body(m: Dict[str, str], ldm_prefix: str) -> None:
    """Shared LDM->diffusers body for the UNet down/mid path (also ControlNet's)."""
    m[f"{ldm_prefix}time_embed.0"] = "time_embedding.linear_1"
    m[f"{ldm_prefix}time_embed.2"] = "time_embedding.linear_2"
    m[f"{ldm_prefix}input_blocks.0.0"] = "conv_in"
    for i in range(1, 12):
        block, j = (i - 1) // 3, (i - 1) % 3
        if j == 2:  # i in {3, 6, 9}: stride-2 downsampler
            m[f"{ldm_prefix}input_blocks.{i}.0.op"] = f"down_blocks.{block}.downsamplers.0.conv"
            continue
        for ldm_inner, dif_inner in _RESNET_INNER.items():
            m[f"{ldm_prefix}input_blocks.{i}.0.{ldm_inner}"] = (
                f"down_blocks.{block}.resnets.{j}.{dif_inner}"
            )
        if block < 3:
            for inner in _ATTN_INNER:
                m[f"{ldm_prefix}input_blocks.{i}.1.{inner}"] = (
                    f"down_blocks.{block}.attentions.{j}.{inner}"
                )
    for mid_idx, dif in ((0, "resnets.0"), (2, "resnets.1")):
        for ldm_inner, dif_inner in _RESNET_INNER.items():
            m[f"{ldm_prefix}middle_block.{mid_idx}.{ldm_inner}"] = f"mid_block.{dif}.{dif_inner}"
    for inner in _ATTN_INNER:
        m[f"{ldm_prefix}middle_block.1.{inner}"] = f"mid_block.attentions.0.{inner}"


def unet_ldm_to_diffusers() -> Dict[str, str]:
    """Module-level LDM (``model.diffusion_model.*``) -> diffusers UNet mapping."""
    m: Dict[str, str] = {}
    p = "model.diffusion_model."
    _unet_body(m, p)
    for i in range(12):
        block, j = i // 3, i % 3
        for ldm_inner, dif_inner in _RESNET_INNER.items():
            m[f"{p}output_blocks.{i}.0.{ldm_inner}"] = (
                f"up_blocks.{block}.resnets.{j}.{dif_inner}"
            )
        if block > 0:
            for inner in _ATTN_INNER:
                m[f"{p}output_blocks.{i}.1.{inner}"] = f"up_blocks.{block}.attentions.{j}.{inner}"
    # Upsamplers are the last sub-entry of output_blocks {2, 5, 8}: index .1 on the
    # attention-less up_blocks.0, else .2.
    m[f"{p}output_blocks.2.1.conv"] = "up_blocks.0.upsamplers.0.conv"
    m[f"{p}output_blocks.5.2.conv"] = "up_blocks.1.upsamplers.0.conv"
    m[f"{p}output_blocks.8.2.conv"] = "up_blocks.2.upsamplers.0.conv"
    m[f"{p}out.0"] = "conv_norm_out"
    m[f"{p}out.2"] = "conv_out"
    return m


def controlnet_ldm_to_diffusers() -> Dict[str, str]:
    """``control_model.*`` (lllyasviel .pth) -> diffusers-style controlnet modules."""
    m: Dict[str, str] = {}
    p = "control_model."
    _unet_body(m, p)
    for i in range(12):
        m[f"{p}zero_convs.{i}.0"] = f"controlnet_down_blocks.{i}"
    m[f"{p}middle_block_out.0"] = "controlnet_mid_block"
    hint_names = (
        ["controlnet_cond_embedding.conv_in"]
        + [f"controlnet_cond_embedding.blocks.{i}" for i in range(6)]
        + ["controlnet_cond_embedding.conv_out"]
    )
    for k, name in enumerate(hint_names):
        m[f"{p}input_hint_block.{2 * k}"] = name
    return m


def vae_ldm_to_diffusers() -> Dict[str, str]:
    """LDM first-stage VAE -> diffusers module names (without ``first_stage_model.``
    prefix, which the converter strips first)."""
    m: Dict[str, str] = {}

    def attn(ldm_prefix, dif_prefix):
        for ldm_inner, dif_inner in _VAE_ATTN_INNER.items():
            m[f"{ldm_prefix}.{ldm_inner}"] = f"{dif_prefix}.{dif_inner}"

    def res(ldm_prefix, dif_prefix):
        for ldm_inner, dif_inner in _VAE_RESNET_INNER.items():
            m[f"{ldm_prefix}.{ldm_inner}"] = f"{dif_prefix}.{dif_inner}"

    m["encoder.conv_in"] = "encoder.conv_in"
    for i in range(4):
        for j in range(2):
            res(f"encoder.down.{i}.block.{j}", f"encoder.down_blocks.{i}.resnets.{j}")
        if i < 3:
            m[f"encoder.down.{i}.downsample.conv"] = f"encoder.down_blocks.{i}.downsamplers.0.conv"
    res("encoder.mid.block_1", "encoder.mid_block.resnets.0")
    attn("encoder.mid.attn_1", "encoder.mid_block.attentions.0")
    res("encoder.mid.block_2", "encoder.mid_block.resnets.1")
    m["encoder.norm_out"] = "encoder.conv_norm_out"
    m["encoder.conv_out"] = "encoder.conv_out"
    m["quant_conv"] = "quant_conv"

    m["post_quant_conv"] = "post_quant_conv"
    m["decoder.conv_in"] = "decoder.conv_in"
    res("decoder.mid.block_1", "decoder.mid_block.resnets.0")
    attn("decoder.mid.attn_1", "decoder.mid_block.attentions.0")
    res("decoder.mid.block_2", "decoder.mid_block.resnets.1")
    for i in range(4):
        # LDM decoder up indices are reversed: up.3 is adjacent to mid.
        for j in range(3):
            res(f"decoder.up.{3 - i}.block.{j}", f"decoder.up_blocks.{i}.resnets.{j}")
        if i < 3:
            m[f"decoder.up.{3 - i}.upsample.conv"] = f"decoder.up_blocks.{i}.upsamplers.0.conv"
    m["decoder.norm_out"] = "decoder.conv_norm_out"
    m["decoder.conv_out"] = "decoder.conv_out"
    return m


TEXT_ENCODER_LDM_PREFIX = "cond_stage_model.transformer."
UNET_LDM_PREFIX = "model.diffusion_model."
VAE_LDM_PREFIX = "first_stage_model."
