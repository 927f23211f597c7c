"""VAE decoder (sd-vae-ft-mse architecture) as an ``nn.Module``.

1/0.18215 rescale -> 1x1 post-quant conv -> conv 512 -> mid Res-Attn-Res -> 3x (3
ResBlocks + nearest-2x upsample conv) at 512/512/256 -> 3 ResBlocks at 128 ->
GN+SiLU -> conv 3. The VAE ResBlock has no time embedding; its attention block is
single-head over h*w tokens scaled by 1/sqrt(C).

``forward`` takes NHWC latents and returns NHWC images in [-1, 1]. ``state_dict``
keys are diffusers-style (``decoder.up_blocks.{i}.*`` in decoder order,
``post_quant_conv``). The encoder comes with img2img.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from minsdtf_tpu_torch.models.common import apply_conv, apply_dense, build, norm, param_shapes
from minsdtf_tpu_torch.ops.attention import single_head_spatial_attention
from minsdtf_tpu_torch.ops.basic import group_norm, group_norm_silu, upsample2x_conv3x3

SCALE_FACTOR = 0.18215
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

    def forward(self, x):
        h = group_norm_silu(x, self.norm1.weight, self.norm1.bias)
        h = apply_conv(self.conv1, h, padding=1)
        h = group_norm_silu(h, self.norm2.weight, self.norm2.bias)
        h = apply_conv(self.conv2, h, padding=1)
        if hasattr(self, "conv_shortcut"):
            x = apply_conv(self.conv_shortcut, x)
        return h + x


class VAEAttention(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.group_norm = norm(c)
        self.to_q = nn.Linear(c, c)
        self.to_k = nn.Linear(c, c)
        self.to_v = nn.Linear(c, c)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, x):
        b, c, h, w = x.shape
        z = group_norm(x, self.group_norm.weight, self.group_norm.bias)
        z = z.flatten(2).transpose(1, 2)  # (B, HW, C)
        out = single_head_spatial_attention(apply_dense(self.to_q, z), apply_dense(self.to_k, z),
                                            apply_dense(self.to_v, z))
        out = apply_dense(self.to_out[0], out).transpose(1, 2).reshape(b, c, h, w)
        return out + x


class _MidBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResBlock(c, c), VAEResBlock(c, c)])
        self.attentions = nn.ModuleList([VAEAttention(c)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _UpSampler(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3)


class _UpBlock(nn.Module):
    def __init__(self, cin: int, c: int, upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResBlock(cin if j == 0 else c, c) for j in range(3)])
        if upsample:
            self.upsamplers = nn.ModuleList([_UpSampler(c)])


class Decoder(nn.Module):
    def __init__(self, widths):
        super().__init__()
        self.conv_in = nn.Conv2d(4, widths[0], 3)
        self.mid_block = _MidBlock(widths[0])
        cins = (widths[0],) + tuple(widths[:-1])
        self.up_blocks = nn.ModuleList(
            [_UpBlock(cin, c, level < 3) for level, (cin, c) in enumerate(zip(cins, widths))])
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
        x = apply_conv(self.post_quant_conv, latent.permute(0, 3, 1, 2) / SCALE_FACTOR)
        x = d.mid_block(apply_conv(d.conv_in, x, padding=1))
        for level, block in enumerate(d.up_blocks):
            for res in block.resnets:
                x = res(x)
            if level < 3:
                up = block.upsamplers[0].conv
                x = upsample2x_conv3x3(x, up.weight, up.bias)
        x = group_norm_silu(x, d.conv_norm_out.weight, d.conv_norm_out.bias)
        return apply_conv(d.conv_out, x, padding=1).permute(0, 2, 3, 1)


def decoder_param_specs(dec_widths=DEC_WIDTHS) -> Dict[str, Tuple[int, ...]]:
    return param_shapes(lambda: VAEDecoder(dec_widths))


def init_decoder(device, seed: int = 2, **kw) -> VAEDecoder:
    """Random-initialized decoder on ``device`` (see :func:`models.common.build`)."""
    return build(lambda: VAEDecoder(**kw), device, seed)
