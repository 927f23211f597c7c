"""ControlNet (canny): the hint branch and the control branch, as ``nn.Module`` classes.

  - :class:`HintNet` (``controlnet_cond_embedding``): 8 convs (16, 16, 32, 32, 96,
    96, 256, 320) with SiLU between all but the last, stride 2 on convs 3, 5 and 7;
    maps the (B, H, W, 3) hint image in [0, 1] to a (B, 320, H/8, W/8) feature map,
    computed once per generation.
  - :class:`ControlNet`: a copy of the UNet's down path and mid block
    (:func:`models.unet.down_and_mid_blocks`, with its own time embedding) whose
    input is ``conv_in(latent) + hint``. Its 12 skips and the mid block's output
    each go through a 1x1 zero conv, giving the 13 residuals that
    ``UNet.forward(controls=...)`` adds.

Under spatial SP the control branch shares the UNet's H-sharded levels
(:func:`models.unet.run_down_and_mid`), so its residuals at a sharded level are
this rank's rows, which the UNet adds shard for shard. The HintNet runs whole,
as the JAX package's ``hint_net`` carries no anchor; its output is cut to this
rank's rows at the add.

``state_dict`` keys are the diffusers names: the UNet's (``conv_in``,
``time_embedding.*``, ``down_blocks.*``, ``mid_block.*``), the zero convs
``controlnet_down_blocks.{0..11}`` and ``controlnet_mid_block``, and the hint
branch ``controlnet_cond_embedding.{conv_in, blocks.0..5, conv_out}``. The
residuals and the hint are (B, C, H, W) laid out channels-last, as the UNet's
activations are.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from minsdtf_tpu_torch.models.common import apply_conv, build, conv3, param_shapes
from minsdtf_tpu_torch.models.unet import (
    BLOCK_WIDTHS, CONTEXT_DIM, down_and_mid_blocks, embed_time, run_down_and_mid,
    time_embedding_module,
)
from minsdtf_tpu_torch.ops.basic import silu
from minsdtf_tpu_torch.parallel import spatial

HINT_WIDTHS = (16, 16, 32, 32, 96, 96, 256, 320)
HINT_STRIDES = (1, 1, 2, 1, 2, 1, 2, 1)


def hint_widths(widths) -> Tuple[int, ...]:
    """The hint convs' widths: ``HINT_WIDTHS`` at the SD1.5 widths; at smaller
    (test) widths ``max(4, w // 8)`` and then ``widths[0]``, as the JAX package's
    ``controlnet.param_specs`` scales them."""
    if tuple(widths) == BLOCK_WIDTHS:
        return HINT_WIDTHS
    return tuple(max(4, w // 8) for w in HINT_WIDTHS[:-1]) + (widths[0],)


class HintNet(nn.Module):
    def __init__(self, widths=HINT_WIDTHS):
        super().__init__()
        cins = (3,) + tuple(widths[:-1])
        self.conv_in = nn.Conv2d(cins[0], widths[0], 3)
        self.blocks = nn.ModuleList([nn.Conv2d(cins[i], widths[i], 3) for i in range(1, 7)])
        self.conv_out = nn.Conv2d(cins[7], widths[7], 3)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) in [0, 1] -> (B, widths[-1], H/8, W/8)."""
        x = image.permute(0, 3, 1, 2)
        convs = [self.conv_in, *self.blocks, self.conv_out]
        for i, (conv, stride) in enumerate(zip(convs, HINT_STRIDES)):
            x = apply_conv(conv, x, stride=stride, padding=1)
            if i < 7:
                x = silu(x)
        return x


class ControlNet(nn.Module):
    def __init__(self, widths=BLOCK_WIDTHS, temb_dim: int = 1280,
                 context_dim: int = CONTEXT_DIM):
        super().__init__()
        w0, w1, w2, w3 = widths
        self.time_embedding = time_embedding_module(w0, temb_dim)
        self.conv_in = nn.Conv2d(4, w0, 3)
        self.down_blocks, self.mid_block = down_and_mid_blocks(widths, temb_dim, context_dim)
        self.controlnet_cond_embedding = HintNet(hint_widths(widths))
        skip_cs = (w0, w0, w0, w0, w1, w1, w1, w2, w2, w2, w3, w3)
        self.controlnet_down_blocks = nn.ModuleList([nn.Conv2d(c, c, 1) for c in skip_cs])
        self.controlnet_mid_block = nn.Conv2d(w3, w3, 1)

    def forward(self, latent: torch.Tensor, t_emb: torch.Tensor, context: torch.Tensor,
                hint: torch.Tensor) -> List[torch.Tensor]:
        """(B, h, w, 4), (B, 320), (B, S, 768), the (B, w0, h, w) HintNet output ->
        the 13 (B, C, H, W) residuals (12 skips + the mid block)."""
        temb = embed_time(self.time_embedding, t_emb)
        sharded = spatial.plan(latent.shape[1], latent.shape[2], 4)
        x = conv3(self.conv_in, latent.permute(0, 3, 1, 2), sharded[0], whole_input=True)
        hint = spatial.local_rows(hint) if sharded[0] else hint
        x, skips = run_down_and_mid(self.down_blocks, self.mid_block, x + hint.to(x.dtype),
                                    temb, context, sharded)
        outs = [apply_conv(conv, s) for conv, s in zip(self.controlnet_down_blocks, skips)]
        return outs + [apply_conv(self.controlnet_mid_block, x)]


def param_specs(widths=BLOCK_WIDTHS, temb_dim: int = 1280,
                context_dim: int = CONTEXT_DIM) -> Dict[str, Tuple[int, ...]]:
    """``{state_dict key: shape}``; the defaults are the full SD1.5 ControlNet."""
    return param_shapes(lambda: ControlNet(widths, temb_dim, context_dim))


def init(device, seed: int = 3, **kw) -> ControlNet:
    """Random-initialized ControlNet on ``device`` (see :func:`models.common.build`)."""
    return build(lambda: ControlNet(**kw), device, seed)
