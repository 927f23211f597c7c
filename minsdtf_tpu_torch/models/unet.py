"""SD1.5 UNet (eps-prediction) as an ``nn.Module``.

conv_in 320; three down levels of [ResBlock + SpatialTransformer] x2 + stride-2
downsample at widths 320/640/1280; down_blocks.3 = 2 ResBlocks; mid Res-Attn-Res;
four up levels of 3 ResBlocks with skip-concat (+ SpatialTransformer except
up_blocks.0) and nearest-2x upsamplers; exit GroupNorm+SiLU+conv -> 4. 8 heads
everywhere; one TransformerBlock per attention (self-attn, cross-attn against the
768-d context, GEGLU-tanh FF x4).

``forward`` takes and returns the JAX package's layouts (NHWC latents, (B, S, C)
context). Inside, activations are (B, C, H, W) tensors laid out channels-last in
memory: the latent's ``permute(0, 3, 1, 2)`` view, with no copy, then every conv
(its weight channels-last since :func:`models.common.cast_weights_`), GroupNorm,
add, concatenation and upsample keeps that layout, a SpatialTransformer's tokens
are a view of it, and the output's ``permute(0, 2, 3, 1)`` is a dense view again.
The CFG cond/uncond pair arrives batched. The down
path and mid block are built and run by functions that
:mod:`minsdtf_tpu_torch.models.controlnet` shares.
``state_dict`` keys are the JAX package's flat module names plus ``.weight`` /
``.bias`` (``down_blocks.0.resnets.0.conv1.weight``).

Under :func:`ops.attention.sequence_parallel_scope` the forward keeps every level
that :func:`parallel.spatial.plan` marks H-sharded so end to end, where the JAX
package places ``constrain_spatial`` / ``constrain_tokens``
(``minsdtf_tpu/models/unet.py:67``, ``:109-112``, ``:134-173``): the residual
stream, the skips and the tokens stay this rank's rows, the 3x3 convs exchange
halo rows, the GroupNorms sum over the model axis, self-attention runs the
sharded ring and cross-attention the local queries against the whole context.
The downsampler out of a sharded level gathers its output rows, and
``conv_out``'s output is gathered, so the latent is whole on every rank.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from minsdtf_tpu_torch.models.common import (
    apply_conv, apply_dense, build, conv3, downsample, norm, norm_act, param_shapes, upsample,
)
from minsdtf_tpu_torch.ops.attention import multi_head_attention
from minsdtf_tpu_torch.ops.basic import gelu_gate, layer_norm, silu
from minsdtf_tpu_torch.parallel import spatial

WHOLE = (False,) * 4  # no level H-sharded

NUM_HEADS = 8
CONTEXT_DIM = 768
BLOCK_WIDTHS = (320, 640, 1280, 1280)


class ResBlock(nn.Module):
    """GN+SiLU+conv, + time projection, GN+SiLU+conv, + shortcut (1x1 conv iff the
    channel count changes)."""

    def __init__(self, cin: int, cout: int, temb_dim: int):
        super().__init__()
        self.norm1 = norm(cin)
        self.conv1 = nn.Conv2d(cin, cout, 3)
        self.time_emb_proj = nn.Linear(temb_dim, cout)
        self.norm2 = norm(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3)
        if cin != cout:
            self.conv_shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x, temb, sharded: bool = False):
        h = conv3(self.conv1, norm_act(self.norm1, x, sharded), sharded)
        h = h + apply_dense(self.time_emb_proj, temb)[:, :, None, None]
        h = conv3(self.conv2, norm_act(self.norm2, h, sharded), sharded)
        if hasattr(self, "conv_shortcut"):
            x = apply_conv(self.conv_shortcut, x)
        return h + x


class CrossAttention(nn.Module):
    """No-bias q/k/v projections, biased out-projection; ``context`` is ``x`` for
    self-attention. After :meth:`fuse`, self-attention runs q/k/v as one (C, 3C)
    product (``to_qkv``) and cross-attention k/v as one (``to_kv``). ``num_heads``
    is this rank's head count (8 // model under TP,
    :func:`minsdtf_tpu_torch.parallel.sharding.tp_shard`)."""

    def __init__(self, c: int, context_dim: int):
        super().__init__()
        self.num_heads = NUM_HEADS
        self.to_q = nn.Linear(c, c, bias=False)
        self.to_k = nn.Linear(context_dim, c, bias=False)
        self.to_v = nn.Linear(context_dim, c, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def fuse(self, self_attention: bool) -> None:
        names = ("q", "k", "v") if self_attention else ("k", "v")
        weight = torch.cat([getattr(self, f"to_{n}").weight for n in names], dim=0)
        fused = nn.Linear(weight.shape[1], weight.shape[0], bias=False, device="meta")
        fused.weight = nn.Parameter(weight.detach())
        for n in names:
            delattr(self, f"to_{n}")
        setattr(self, "to_qkv" if self_attention else "to_kv", fused)

    def forward(self, x, context, sharded: bool = False):
        """``sharded``: a self-attention on this rank's tokens of an H-sharded level."""
        if hasattr(self, "to_qkv"):
            q, k, v = apply_dense(self.to_qkv, x).chunk(3, dim=-1)
        elif hasattr(self, "to_kv"):
            q = apply_dense(self.to_q, x)
            k, v = apply_dense(self.to_kv, context).chunk(2, dim=-1)
        else:
            q = apply_dense(self.to_q, x)
            k = apply_dense(self.to_k, context)
            v = apply_dense(self.to_v, context)
        out = multi_head_attention(q, k, v, num_heads=self.num_heads, sharded=sharded)
        return apply_dense(self.to_out[0], out)


class GEGLUProj(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.proj = nn.Linear(c, c * 8)


class TransformerBlock(nn.Module):
    """LN -> self-attn, LN -> cross-attn, LN -> GEGLU FF, all residual."""

    def __init__(self, c: int, context_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(c)
        self.attn1 = CrossAttention(c, c)
        self.norm2 = nn.LayerNorm(c)
        self.attn2 = CrossAttention(c, context_dim)
        self.norm3 = nn.LayerNorm(c)
        self.ff = nn.Module()
        self.ff.net = nn.ModuleDict({"0": GEGLUProj(c), "2": nn.Linear(c * 4, c)})

    def forward(self, x, context, sharded: bool = False):
        h = layer_norm(x, self.norm1.weight, self.norm1.bias)
        x = self.attn1(h, h, sharded) + x
        x = self.attn2(layer_norm(x, self.norm2.weight, self.norm2.bias), context) + x
        h = layer_norm(x, self.norm3.weight, self.norm3.bias)
        h = gelu_gate(apply_dense(self.ff.net["0"].proj, h))
        return apply_dense(self.ff.net["2"], h) + x


class SpatialTransformer(nn.Module):
    """GN -> 1x1 proj_in -> tokens -> TransformerBlock -> 1x1 proj_out + residual."""

    def __init__(self, c: int, context_dim: int):
        super().__init__()
        self.norm = norm(c)
        self.proj_in = nn.Conv2d(c, c, 1)
        self.transformer_blocks = nn.ModuleList([TransformerBlock(c, context_dim)])
        self.proj_out = nn.Conv2d(c, c, 1)

    def forward(self, x, context, sharded: bool = False):
        b, c, h, w = x.shape  # this rank's rows when sharded: its tokens are a slice of HW
        z = apply_conv(self.proj_in, norm_act(self.norm, x, sharded, silu=False))
        z = z.flatten(2).transpose(1, 2)  # (B, HW, C)
        z = self.transformer_blocks[0](z, context, sharded)
        z = z.transpose(1, 2).reshape(b, c, h, w)
        return apply_conv(self.proj_out, z) + x


class _Sampler(nn.Module):
    """Holds the ``.conv`` of a down- or upsampler."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3)


class _Level(nn.Module):
    def __init__(self, resnets, attentions=None, sampler=None, up=False):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if sampler is not None:
            setattr(self, "upsamplers" if up else "downsamplers", nn.ModuleList([sampler]))


def time_embedding_module(w0: int, temb_dim: int) -> nn.Module:
    """``linear_1`` (w0 -> temb_dim) and ``linear_2``, as :func:`embed_time` reads them."""
    te = nn.Module()
    te.linear_1 = nn.Linear(w0, temb_dim)
    te.linear_2 = nn.Linear(temb_dim, temb_dim)
    return te


def embed_time(te: nn.Module, t_emb: torch.Tensor) -> torch.Tensor:
    """(B, 320) -> Dense -> SiLU -> Dense -> SiLU -> (B, temb_dim)."""
    return silu(apply_dense(te.linear_2, silu(apply_dense(te.linear_1, t_emb))))


def down_and_mid_blocks(widths, temb_dim: int, context_dim: int):
    """The down path (three levels of [ResBlock + SpatialTransformer] x2 + a
    stride-2 downsample, then 2 ResBlocks) and the mid Res-Attn-Res: the part of
    the UNet that the ControlNet copies."""
    w0, w1, w2, w3 = widths
    down = []
    for level in range(3):
        cin = widths[level - 1] if level > 0 else w0
        c = widths[level]
        down.append(_Level(
            [ResBlock(cin, c, temb_dim), ResBlock(c, c, temb_dim)],
            [SpatialTransformer(c, context_dim) for _ in range(2)],
            _Sampler(c)))
    down.append(_Level([ResBlock(w2, w3, temb_dim), ResBlock(w3, w3, temb_dim)]))
    mid = _Level([ResBlock(w3, w3, temb_dim), ResBlock(w3, w3, temb_dim)],
                 [SpatialTransformer(w3, context_dim)])
    return nn.ModuleList(down), mid


def run_down_and_mid(down_blocks, mid_block, x, temb, context, sharded=WHOLE):
    """The down path and the mid block on ``x`` (B, C, H, W, after ``conv_in``). Returns
    the mid block's output and the 12 skips: ``x`` itself, then every down
    ResBlock / SpatialTransformer pair's and downsampler's output. ``sharded[l]``
    says whether level l (``x``'s resolution halved l times) is H-sharded; its
    activations and skips are then this rank's rows."""
    skips = [x]
    for i, level in enumerate(down_blocks[:3]):
        for res, attn in zip(level.resnets, level.attentions):
            x = attn(res(x, temb, sharded[i]), context, sharded[i])
            skips.append(x)
        x = downsample(level.downsamplers[0].conv, x, sharded[i], sharded[i + 1])
        skips.append(x)
    for res in down_blocks[3].resnets:
        x = res(x, temb, sharded[3])
        skips.append(x)
    mid = mid_block.attentions[0](mid_block.resnets[0](x, temb, sharded[3]), context, sharded[3])
    return mid_block.resnets[1](mid, temb, sharded[3]), skips


class UNet(nn.Module):
    def __init__(self, widths=BLOCK_WIDTHS, temb_dim: int = 1280,
                 context_dim: int = CONTEXT_DIM):
        super().__init__()
        w0, w1, w2, w3 = widths
        self.time_embedding = time_embedding_module(w0, temb_dim)
        self.conv_in = nn.Conv2d(4, w0, 3)
        self.down_blocks, self.mid_block = down_and_mid_blocks(widths, temb_dim, context_dim)

        # up path input channels: x concat skip; the skip channels mirror the
        # down path's stack of outputs
        skip_cs = [w0, w0, w0, w0, w1, w1, w1, w2, w2, w2, w3, w3]
        up = []
        x_c = w3
        for level, c in enumerate((w3, w2, w1, w0)):
            resnets, attns = [], []
            for _ in range(3):
                resnets.append(ResBlock(x_c + skip_cs.pop(), c, temb_dim))
                if level > 0:
                    attns.append(SpatialTransformer(c, context_dim))
                x_c = c
            up.append(_Level(resnets, attns, _Sampler(c) if level < 3 else None, up=True))
        self.up_blocks = nn.ModuleList(up)

        self.conv_norm_out = norm(w0)
        self.conv_out = nn.Conv2d(w0, 4, 3)

    def forward(self, latent: torch.Tensor, t_emb: torch.Tensor, context: torch.Tensor,
                controls: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """(B, h, w, 4), (B, 320), (B, S, 768) -> (B, h, w, 4). ``controls``: the
        ControlNet's 13 residuals, (B, C, H, W) (:class:`models.controlnet.ControlNet`),
        added to the 12 skips and the mid block's output (this rank's rows at the
        H-sharded levels, as the ControlNet under the same scope gives them)."""
        temb = embed_time(self.time_embedding, t_emb)
        sharded = spatial.plan(latent.shape[1], latent.shape[2], 4)
        x = conv3(self.conv_in, latent.permute(0, 3, 1, 2), sharded[0], whole_input=True)
        x, skips = run_down_and_mid(self.down_blocks, self.mid_block, x, temb, context, sharded)
        if controls is not None:
            x = x + controls[12].to(x.dtype)
            skips = [s + c.to(s.dtype) for s, c in zip(skips, controls[:12])]

        for i, level in enumerate(self.up_blocks):
            sp = sharded[3 - i]
            for j, res in enumerate(level.resnets):
                x = res(torch.cat([x, skips.pop()], dim=1), temb, sp)
                if i > 0:
                    x = level.attentions[j](x, context, sp)
            if i < 3:
                x = upsample(level.upsamplers[0].conv, x, sp, sharded[2 - i])

        x = conv3(self.conv_out, norm_act(self.conv_norm_out, x, sharded[0]), sharded[0])
        if sharded[0]:
            x = spatial.gather_rows(x)
        return x.permute(0, 2, 3, 1)


def fuse_attention_projections(model: nn.Module) -> nn.Module:
    """Fuse every attn1 q/k/v into ``to_qkv`` and every attn2 k/v into ``to_kv``
    of ``model`` (a UNet or a ControlNet), in place: one wide product in place of
    three (two) on the same input."""
    for m in model.modules():
        if isinstance(m, TransformerBlock):
            if hasattr(m.attn1, "to_q") and hasattr(m.attn1, "to_k"):
                m.attn1.fuse(self_attention=True)
            if hasattr(m.attn2, "to_k"):
                m.attn2.fuse(self_attention=False)
    return model


def param_specs(widths=BLOCK_WIDTHS, temb_dim: int = 1280,
                context_dim: int = CONTEXT_DIM) -> Dict[str, Tuple[int, ...]]:
    """``{state_dict key: shape}``; the defaults are the full SD1.5 UNet."""
    return param_shapes(lambda: UNet(widths, temb_dim, context_dim))


def init(device, seed: int = 0, **kw) -> UNet:
    """Random-initialized UNet on ``device`` (see :func:`models.common.build`)."""
    return build(lambda: UNet(**kw), device, seed)
