"""VAE encoder and decoder (sd-vae-ft-mse architecture) as ``nn.Module`` classes.

Encoder: conv 128 -> 4 levels of 2 ResBlocks at 128/256/512/512, each of the
first three followed by a stride-2 conv with the asymmetric ``((0, 1), (0, 1))``
pad -> mid Res-Attn-Res -> GN+SiLU -> conv 8 -> 1x1 quant conv -> the mean half
times 0.18215 (no sampling).

Decoder: 1/0.18215 rescale -> 1x1 post-quant conv -> conv 512 -> mid
Res-Attn-Res -> 3x (3 ResBlocks + nearest-2x upsample conv) at 512/512/256 -> 3
ResBlocks at 128 -> GN+SiLU -> conv 3. The VAE ResBlock has no time embedding; its
attention block is single-head over h*w tokens scaled by 1/sqrt(C).

The encoder takes NHWC images in [-1, 1] and returns NHWC latents; the decoder
the other way round. Inside, activations are (B, C, H, W) laid out channels-last,
as in :mod:`minsdtf_tpu_torch.models.unet`, and the attention's tokens a view.
Under :func:`ops.attention.sequence_parallel_scope` each resolution that
:func:`parallel.spatial.plan` marks is H-sharded end to end, where the JAX package
anchors it (``minsdtf_tpu/models/vae.py:48``, ``:102``):
halo-row convs, GroupNorm over the model axis, the single-head attention on the
sharded ring; the encoder's downsampler out of a sharded level gathers its
output rows, and the last output of either is gathered once.

``state_dict`` keys are diffusers-style (``encoder.down_blocks.{i}.*`` and
``quant_conv``; ``decoder.up_blocks.{i}.*`` in decoder order and
``post_quant_conv``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from minsdtf_tpu_torch.models.common import (
    apply_conv, apply_dense, build, conv3, downsample, norm, norm_act, param_shapes, upsample,
)
from minsdtf_tpu_torch.ops.attention import single_head_spatial_attention
from minsdtf_tpu_torch.parallel import spatial

SCALE_FACTOR = 0.18215
ENC_WIDTHS = (128, 256, 512, 512)
DEC_WIDTHS = (512, 512, 256, 128)


class VAEResBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = norm(cin)
        self.conv1 = nn.Conv2d(cin, cout, 3)
        self.norm2 = norm(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3)
        if cin != cout:
            self.conv_shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x, sharded: bool = False):
        h = conv3(self.conv1, norm_act(self.norm1, x, sharded), sharded)
        h = conv3(self.conv2, norm_act(self.norm2, h, sharded), sharded)
        if hasattr(self, "conv_shortcut"):
            x = apply_conv(self.conv_shortcut, x)
        return h + x


class VAEAttention(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.num_heads = 1  # single-head: TP keeps it whole
        self.group_norm = norm(c)
        self.to_q = nn.Linear(c, c)
        self.to_k = nn.Linear(c, c)
        self.to_v = nn.Linear(c, c)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, x, sharded: bool = False):
        b, c, h, w = x.shape  # this rank's rows when sharded
        z = norm_act(self.group_norm, x, sharded, silu=False)
        z = z.flatten(2).transpose(1, 2)  # (B, HW, C)
        out = single_head_spatial_attention(apply_dense(self.to_q, z), apply_dense(self.to_k, z),
                                            apply_dense(self.to_v, z), sharded)
        out = apply_dense(self.to_out[0], out).transpose(1, 2).reshape(b, c, h, w)
        return out + x


class _MidBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResBlock(c, c), VAEResBlock(c, c)])
        self.attentions = nn.ModuleList([VAEAttention(c)])

    def forward(self, x, sharded: bool = False):
        x = self.attentions[0](self.resnets[0](x, sharded), sharded)
        return self.resnets[1](x, sharded)


class _Sampler(nn.Module):
    """Holds the ``.conv`` of a down- or upsampler."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3)


class _Block(nn.Module):
    def __init__(self, cin: int, c: int, depth: int, sampler: str = ""):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResBlock(cin if j == 0 else c, c) for j in range(depth)])
        if sampler:
            setattr(self, sampler, nn.ModuleList([_Sampler(c)]))


class Encoder(nn.Module):
    def __init__(self, widths):
        super().__init__()
        self.conv_in = nn.Conv2d(3, widths[0], 3)
        cins = (widths[0],) + tuple(widths[:-1])
        self.down_blocks = nn.ModuleList(
            [_Block(cin, c, 2, "downsamplers" if level < 3 else "")
             for level, (cin, c) in enumerate(zip(cins, widths))])
        self.mid_block = _MidBlock(widths[-1])
        self.conv_norm_out = norm(widths[-1])
        self.conv_out = nn.Conv2d(widths[-1], 8, 3)


class VAEEncoder(nn.Module):
    def __init__(self, enc_widths=ENC_WIDTHS):
        super().__init__()
        self.encoder = Encoder(enc_widths)
        self.quant_conv = nn.Conv2d(8, 8, 1)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        """image (B, H, W, 3) in [-1, 1] -> latent (B, H/8, W/8, 4), mean * 0.18215."""
        e = self.encoder
        sharded = spatial.plan(image.shape[1], image.shape[2], 4)
        x = conv3(e.conv_in, image.permute(0, 3, 1, 2), sharded[0], whole_input=True)
        for level, block in enumerate(e.down_blocks):
            for res in block.resnets:
                x = res(x, sharded[level])
            if level < 3:
                x = downsample(block.downsamplers[0].conv, x, sharded[level], sharded[level + 1],
                               padding=((0, 1), (0, 1)))
        x = e.mid_block(x, sharded[3])
        x = conv3(e.conv_out, norm_act(e.conv_norm_out, x, sharded[3]), sharded[3])
        x = apply_conv(self.quant_conv, x)  # mean | logvar
        if sharded[3]:
            x = spatial.gather_rows(x)
        return (x[:, :4] * SCALE_FACTOR).permute(0, 2, 3, 1)


class Decoder(nn.Module):
    def __init__(self, widths):
        super().__init__()
        self.conv_in = nn.Conv2d(4, widths[0], 3)
        self.mid_block = _MidBlock(widths[0])
        cins = (widths[0],) + tuple(widths[:-1])
        self.up_blocks = nn.ModuleList(
            [_Block(cin, c, 3, "upsamplers" if level < 3 else "")
             for level, (cin, c) in enumerate(zip(cins, widths))])
        self.conv_norm_out = norm(widths[-1])
        self.conv_out = nn.Conv2d(widths[-1], 3, 3)


class VAEDecoder(nn.Module):
    def __init__(self, dec_widths=DEC_WIDTHS):
        super().__init__()
        self.post_quant_conv = nn.Conv2d(4, 4, 1)
        self.decoder = Decoder(dec_widths)

    def forward(self, latent: torch.Tensor) -> torch.Tensor:
        """latent (B, h, w, 4) -> image (B, 8h, 8w, 3) in [-1, 1]."""
        d = self.decoder
        sharded = spatial.plan(latent.shape[1], latent.shape[2], 4, up=True)
        x = apply_conv(self.post_quant_conv, latent.permute(0, 3, 1, 2) / SCALE_FACTOR)
        x = conv3(d.conv_in, x, sharded[0], whole_input=True)
        x = d.mid_block(x, sharded[0])
        for level, block in enumerate(d.up_blocks):
            for res in block.resnets:
                x = res(x, sharded[level])
            if level < 3:
                x = upsample(block.upsamplers[0].conv, x, sharded[level], sharded[level + 1])
        x = conv3(d.conv_out, norm_act(d.conv_norm_out, x, sharded[3]), sharded[3])
        if sharded[3]:
            x = spatial.gather_rows(x)
        return x.permute(0, 2, 3, 1)


def encoder_param_specs(enc_widths=ENC_WIDTHS) -> Dict[str, Tuple[int, ...]]:
    return param_shapes(lambda: VAEEncoder(enc_widths))


def init_encoder(device, seed: int = 4, **kw) -> VAEEncoder:
    """Random-initialized encoder on ``device`` (see :func:`models.common.build`)."""
    return build(lambda: VAEEncoder(**kw), device, seed)


def decoder_param_specs(dec_widths=DEC_WIDTHS) -> Dict[str, Tuple[int, ...]]:
    return param_shapes(lambda: VAEDecoder(dec_widths))


def init_decoder(device, seed: int = 2, **kw) -> VAEDecoder:
    """Random-initialized decoder on ``device`` (see :func:`models.common.build`)."""
    return build(lambda: VAEDecoder(**kw), device, seed)
