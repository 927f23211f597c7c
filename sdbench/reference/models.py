"""Plain fp32 PyTorch models of Stable Diffusion 1.5: the CLIP text encoder, the
UNet, the canny ControlNet and the VAE decoder, written from the published
architecture (diffusers' ``UNet2DConditionModel``, ``ControlNetModel``,
``AutoencoderKL`` and transformers' ``CLIPTextModel``) with their parameter
names. No kernel, cache or batching: every product is ``F.linear`` /
``F.conv2d`` / a matmul in float32, and attention over long sequences runs in
blocks of queries so that its scores fit in memory.

Departures from diffusers, where the system under test defines its model
otherwise (the library was written after minSDTF's Keras model): GEGLU gates with
the tanh approximation of GELU, and every GroupNorm uses eps 1e-5 (diffusers:
exact GELU; eps 1e-6 in the transformer's and the VAE's GroupNorms).

``Ops`` holds the products. :class:`Fp8Ops` rounds each product's inputs to
float8 e4m3 with a per-tensor scale: the control that a lower precision than the
configuration's must fail.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

GN_EPS = 1e-5
LN_EPS = 1e-5
SCORE_BLOCK_ELEMENTS = 1 << 28  # fp32 scores held at once by one attention block (1 GiB)


class Ops:
    """The products of a forward, in float32."""

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def linear(self, x, m: nn.Module):
        return F.linear(self.q(x), self.q(m.weight), m.bias)

    def conv(self, x, m: nn.Module, stride: int = 1, padding: int = 1):
        return F.conv2d(self.q(x), self.q(m.weight), m.bias, stride=stride, padding=padding)

    def attention(self, q, k, v, heads: int, causal: bool = False, scale: Optional[float] = None):
        """(B, S, H*D) scaled dot-product attention, in blocks of queries."""
        b, sq, c = q.shape
        sk = k.shape[1]
        d = c // heads
        scale = d ** -0.5 if scale is None else scale
        qh = self.q(q).view(b, sq, heads, d).transpose(1, 2)
        kh = self.q(k).view(b, sk, heads, d).transpose(1, 2)
        vh = self.q(v).view(b, sk, heads, d).transpose(1, 2)
        out = torch.empty_like(qh)
        block = max(1, SCORE_BLOCK_ELEMENTS // (b * heads * sk))
        for i in range(0, sq, block):
            scores = (qh[:, :, i:i + block] @ kh.transpose(-1, -2)) * scale
            if causal:
                rows = torch.arange(i, min(i + block, sq), device=q.device)[:, None]
                scores = scores.masked_fill(torch.arange(sk, device=q.device) > rows, float("-inf"))
            out[:, :, i:i + block] = self.q(scores.softmax(-1)) @ vh
        return out.transpose(1, 2).reshape(b, sq, c)


class Fp8Ops(Ops):
    """Every product's inputs rounded to float8 e4m3 with a per-tensor scale that
    maps the tensor's largest magnitude to e4m3's largest, 448."""

    def q(self, t: torch.Tensor) -> torch.Tensor:
        scale = 448.0 / t.detach().abs().amax().clamp(min=1e-30)
        return (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale


def silu(x):
    return x * torch.sigmoid(x)


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def group_norm(m: nn.GroupNorm, x):
    return F.group_norm(x, m.num_groups, m.weight, m.bias, GN_EPS)


def layer_norm(m: nn.LayerNorm, x):
    return F.layer_norm(x, (x.shape[-1],), m.weight, m.bias, LN_EPS)


def _gn(c: int, groups: int) -> nn.GroupNorm:
    return nn.GroupNorm(groups, c)


# ---- CLIP ViT-L/14 text encoder ------------------------------------------------------


class CLIPTextModel(nn.Module):
    """transformers' ``CLIPTextModel``: token + position embedding, pre-LN
    encoder layers with causal self-attention and a quick-GELU MLP, final
    LayerNorm. ``forward`` returns the last hidden state (clip skip 1)."""

    def __init__(self, cfg: dict, ops: Ops):
        super().__init__()
        self.ops, self.heads = ops, cfg["num_attention_heads"]
        d, ff = cfg["hidden_size"], cfg["intermediate_size"]
        tm = self.text_model = nn.Module()
        tm.embeddings = nn.Module()
        tm.embeddings.token_embedding = nn.Embedding(cfg["vocab_size"], d)
        tm.embeddings.position_embedding = nn.Embedding(cfg["max_position_embeddings"], d)
        tm.encoder = nn.Module()
        tm.encoder.layers = nn.ModuleList()
        for _ in range(cfg["num_hidden_layers"]):
            layer = nn.Module()
            layer.layer_norm1 = nn.LayerNorm(d)
            layer.self_attn = nn.Module()
            for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
                setattr(layer.self_attn, name, nn.Linear(d, d))
            layer.layer_norm2 = nn.LayerNorm(d)
            layer.mlp = nn.Module()
            layer.mlp.fc1 = nn.Linear(d, ff)
            layer.mlp.fc2 = nn.Linear(ff, d)
            tm.encoder.layers.append(layer)
        tm.final_layer_norm = nn.LayerNorm(d)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        o, tm = self.ops, self.text_model
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        x = tm.embeddings.token_embedding.weight[tokens] + tm.embeddings.position_embedding.weight[pos]
        for layer in tm.encoder.layers:
            a = layer.self_attn
            h = layer_norm(layer.layer_norm1, x)
            h = o.attention(o.linear(h, a.q_proj), o.linear(h, a.k_proj), o.linear(h, a.v_proj),
                            self.heads, causal=True)
            x = x + o.linear(h, a.out_proj)
            h = o.linear(layer_norm(layer.layer_norm2, x), layer.mlp.fc1)
            x = x + o.linear(h * torch.sigmoid(1.702 * h), layer.mlp.fc2)
        return layer_norm(tm.final_layer_norm, x)


# ---- UNet and ControlNet ------------------------------------------------------------


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, temb: Optional[int], groups: int):
        super().__init__()
        self.norm1 = _gn(cin, groups)
        self.conv1 = nn.Conv2d(cin, cout, 3)
        if temb is not None:
            self.time_emb_proj = nn.Linear(temb, cout)
        self.norm2 = _gn(cout, groups)
        self.conv2 = nn.Conv2d(cout, cout, 3)
        if cin != cout:
            self.conv_shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, o: Ops, x, temb=None):
        h = o.conv(silu(group_norm(self.norm1, x)), self.conv1)
        if temb is not None:
            h = h + o.linear(silu(temb), self.time_emb_proj)[:, :, None, None]
        h = o.conv(silu(group_norm(self.norm2, h)), self.conv2)
        if hasattr(self, "conv_shortcut"):
            x = o.conv(x, self.conv_shortcut, padding=0)
        return x + h


class Attention(nn.Module):
    def __init__(self, c: int, kv_dim: int, heads: int, bias: bool = False):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(c, c, bias=bias)
        self.to_k = nn.Linear(kv_dim, c, bias=bias)
        self.to_v = nn.Linear(kv_dim, c, bias=bias)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, o: Ops, x, context=None, scale=None):
        context = x if context is None else context
        out = o.attention(o.linear(x, self.to_q), o.linear(context, self.to_k),
                          o.linear(context, self.to_v), self.heads, scale=scale)
        return o.linear(out, self.to_out[0])


class Transformer2D(nn.Module):
    """GroupNorm, 1x1 ``proj_in``, one BasicTransformerBlock (self-attention,
    cross-attention, GEGLU feed-forward, each pre-LN and residual), 1x1
    ``proj_out``, residual."""

    def __init__(self, c: int, context_dim: int, heads: int, groups: int):
        super().__init__()
        self.norm = _gn(c, groups)
        self.proj_in = nn.Conv2d(c, c, 1)
        blk = nn.Module()
        blk.norm1, blk.norm2, blk.norm3 = nn.LayerNorm(c), nn.LayerNorm(c), nn.LayerNorm(c)
        blk.attn1 = Attention(c, c, heads)
        blk.attn2 = Attention(c, context_dim, heads)
        blk.ff = nn.Module()
        geglu = nn.Module()
        geglu.proj = nn.Linear(c, 8 * c)
        blk.ff.net = nn.ModuleDict({"0": geglu, "2": nn.Linear(4 * c, c)})
        self.transformer_blocks = nn.ModuleList([blk])
        self.proj_out = nn.Conv2d(c, c, 1)

    def forward(self, o: Ops, x, context):
        b, c, h, w = x.shape
        blk = self.transformer_blocks[0]
        z = o.conv(group_norm(self.norm, x), self.proj_in, padding=0)
        z = z.flatten(2).transpose(1, 2)
        z = z + blk.attn1(o, layer_norm(blk.norm1, z))
        z = z + blk.attn2(o, layer_norm(blk.norm2, z), context)
        value, gate = o.linear(layer_norm(blk.norm3, z), blk.ff.net["0"].proj).chunk(2, dim=-1)
        z = z + o.linear(value * gelu_tanh(gate), blk.ff.net["2"])
        z = z.transpose(1, 2).reshape(b, c, h, w)
        return x + o.conv(z, self.proj_out, padding=0)


class _Conv(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3)


class _Block(nn.Module):
    def __init__(self, resnets, attentions=(), sampler: str = "", c: int = 0):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if sampler:
            setattr(self, sampler, nn.ModuleList([_Conv(c)]))


def _time_embedding(w0: int, temb: int) -> nn.Module:
    te = nn.Module()
    te.linear_1 = nn.Linear(w0, temb)
    te.linear_2 = nn.Linear(temb, temb)
    return te


def timestep_features(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal features of the timesteps ``t`` (B,), cosines first
    (``flip_sin_to_cos``, frequency shift 0), computed in float64."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float64, device=t.device) / half)
    args = t.to(torch.float64)[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1).float()


class _DownMid(nn.Module):
    """The UNet's time embedding, ``conv_in``, down path and mid block: what the
    ControlNet copies."""

    def _build_down_mid(self, cfg: dict):
        widths, groups = cfg["block_out_channels"], cfg["norm_num_groups"]
        heads, ctx, layers = cfg["attention_head_dim"], cfg["cross_attention_dim"], cfg["layers_per_block"]
        temb = 4 * widths[0]
        self.time_embedding = _time_embedding(widths[0], temb)
        self.conv_in = nn.Conv2d(cfg["in_channels"], widths[0], 3)
        self.down_blocks = nn.ModuleList()
        cin = widths[0]
        for i, (c, kind) in enumerate(zip(widths, cfg["down_block_types"])):
            attn = kind == "CrossAttnDownBlock2D"
            last = i == len(widths) - 1
            self.down_blocks.append(_Block(
                [ResnetBlock(cin if j == 0 else c, c, temb, groups) for j in range(layers)],
                [Transformer2D(c, ctx, heads, groups) for _ in range(layers)] if attn else (),
                "" if last else "downsamplers", c))
            cin = c
        w = widths[-1]
        self.mid_block = _Block([ResnetBlock(w, w, temb, groups), ResnetBlock(w, w, temb, groups)],
                                [Transformer2D(w, ctx, heads, groups)])
        self.w0 = widths[0]

    def _down_mid(self, o: Ops, x, t, context, hint=None):
        temb = o.linear(silu(o.linear(timestep_features(t, self.w0), self.time_embedding.linear_1)),
                        self.time_embedding.linear_2)
        x = o.conv(x, self.conv_in)
        if hint is not None:
            x = x + hint
        skips = [x]
        for block in self.down_blocks:
            attns = getattr(block, "attentions", None)
            for j, res in enumerate(block.resnets):
                x = res(o, x, temb)
                if attns is not None:
                    x = attns[j](o, x, context)
                skips.append(x)
            if hasattr(block, "downsamplers"):
                x = o.conv(x, block.downsamplers[0].conv, stride=2)
                skips.append(x)
        mid = self.mid_block
        x = mid.resnets[1](o, mid.attentions[0](o, mid.resnets[0](o, x, temb), context), temb)
        return x, skips, temb


class UNet(_DownMid):
    """diffusers' ``UNet2DConditionModel`` as SD1.5 configures it. ``forward``
    takes NCHW latents, (B,) timesteps and (B, S, C) contexts."""

    def __init__(self, cfg: dict, ops: Ops):
        super().__init__()
        self.ops = ops
        self._build_down_mid(cfg)
        widths, groups = cfg["block_out_channels"], cfg["norm_num_groups"]
        heads, ctx, layers = cfg["attention_head_dim"], cfg["cross_attention_dim"], cfg["layers_per_block"]
        temb = 4 * widths[0]
        rev = list(reversed(widths))
        skip_cs = [widths[0]]
        for i, c in enumerate(widths):
            skip_cs += [c] * layers + ([c] if i < len(widths) - 1 else [])
        self.up_blocks = nn.ModuleList()
        cin = rev[0]
        for i, (c, kind) in enumerate(zip(rev, cfg["up_block_types"])):
            attn = kind == "CrossAttnUpBlock2D"
            last = i == len(rev) - 1
            resnets = []
            for _ in range(layers + 1):
                resnets.append(ResnetBlock(cin + skip_cs.pop(), c, temb, groups))
                cin = c
            self.up_blocks.append(_Block(
                resnets, [Transformer2D(c, ctx, heads, groups) for _ in range(layers + 1)] if attn else (),
                "" if last else "upsamplers", c))
        self.conv_norm_out = _gn(widths[0], groups)
        self.conv_out = nn.Conv2d(widths[0], cfg["out_channels"], 3)

    def forward(self, x, t, context, controls: Optional[Sequence[torch.Tensor]] = None):
        o = self.ops
        x, skips, temb = self._down_mid(o, x, t, context)
        if controls is not None:
            skips = [s + c for s, c in zip(skips, controls[:-1])]
            x = x + controls[-1]
        for block in self.up_blocks:
            attns = getattr(block, "attentions", None)
            for j, res in enumerate(block.resnets):
                x = res(o, torch.cat([x, skips.pop()], dim=1), temb)
                if attns is not None:
                    x = attns[j](o, x, context)
            if hasattr(block, "upsamplers"):
                x = o.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"), block.upsamplers[0].conv)
        return o.conv(silu(group_norm(self.conv_norm_out, x)), self.conv_out)


class ControlNet(_DownMid):
    """diffusers' ``ControlNetModel``: the conditioning embedding (HintNet), the
    UNet's down path and mid block on ``conv_in(x) + hint``, and a 1x1 zero conv
    on each skip and on the mid block's output."""

    def __init__(self, cfg: dict, ops: Ops):
        super().__init__()
        self.ops = ops
        self._build_down_mid(cfg)
        widths = cfg["block_out_channels"]
        hint = cfg["conditioning_embedding_out_channels"]
        ce = self.controlnet_cond_embedding = nn.Module()
        ce.conv_in = nn.Conv2d(cfg["conditioning_channels"], hint[0], 3)
        ce.blocks = nn.ModuleList()
        for a, b in zip(hint[:-1], hint[1:]):
            ce.blocks.append(nn.Conv2d(a, a, 3))
            ce.blocks.append(nn.Conv2d(a, b, 3))
        ce.conv_out = nn.Conv2d(hint[-1], widths[0], 3)
        layers = cfg["layers_per_block"]
        skip_cs = [widths[0]]
        for i, c in enumerate(widths):
            skip_cs += [c] * layers + ([c] if i < len(widths) - 1 else [])
        self.controlnet_down_blocks = nn.ModuleList([nn.Conv2d(c, c, 1) for c in skip_cs])
        self.controlnet_mid_block = nn.Conv2d(widths[-1], widths[-1], 1)

    def hint(self, image01: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) in [0, 1] -> (B, w0, H/8, W/8)."""
        o, ce = self.ops, self.controlnet_cond_embedding
        x = silu(o.conv(image01, ce.conv_in))
        for i, conv in enumerate(ce.blocks):
            x = silu(o.conv(x, conv, stride=2 if i % 2 else 1))
        return o.conv(x, ce.conv_out)

    def forward(self, x, t, context, hint) -> List[torch.Tensor]:
        o = self.ops
        x, skips, _ = self._down_mid(o, x, t, context, hint)
        outs = [o.conv(s, conv, padding=0) for s, conv in zip(skips, self.controlnet_down_blocks)]
        return outs + [o.conv(x, self.controlnet_mid_block, padding=0)]


# ---- VAE decoder ---------------------------------------------------------------------


class VAEAttention(nn.Module):
    def __init__(self, c: int, groups: int):
        super().__init__()
        self.group_norm = _gn(c, groups)
        self.to_q, self.to_k, self.to_v = nn.Linear(c, c), nn.Linear(c, c), nn.Linear(c, c)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, o: Ops, x):
        b, c, h, w = x.shape
        z = group_norm(self.group_norm, x).flatten(2).transpose(1, 2)
        z = o.attention(o.linear(z, self.to_q), o.linear(z, self.to_k), o.linear(z, self.to_v), 1)
        return x + o.linear(z, self.to_out[0]).transpose(1, 2).reshape(b, c, h, w)


class VAEDecoder(nn.Module):
    """diffusers' ``AutoencoderKL`` decoder half: ``latent / scaling_factor`` ->
    ``post_quant_conv`` -> ``conv_in`` -> mid (resnet, attention, resnet) -> up
    blocks of ``layers_per_block + 1`` resnets with nearest-2x upsamplers ->
    GroupNorm, SiLU, ``conv_out``. Takes and returns NCHW."""

    def __init__(self, cfg: dict, ops: Ops):
        super().__init__()
        self.ops, self.scaling = ops, cfg["scaling_factor"]
        widths, groups, lat = list(reversed(cfg["block_out_channels"])), cfg["norm_num_groups"], cfg["latent_channels"]
        self.post_quant_conv = nn.Conv2d(lat, lat, 1)
        d = self.decoder = nn.Module()
        d.conv_in = nn.Conv2d(lat, widths[0], 3)
        d.mid_block = _Block([ResnetBlock(widths[0], widths[0], None, groups) for _ in range(2)],
                             [VAEAttention(widths[0], groups)])
        d.up_blocks = nn.ModuleList()
        cin = widths[0]
        for i, c in enumerate(widths):
            d.up_blocks.append(_Block(
                [ResnetBlock(cin if j == 0 else c, c, None, groups)
                 for j in range(cfg["layers_per_block"] + 1)],
                (), "upsamplers" if i < len(widths) - 1 else "", c))
            cin = c
        d.conv_norm_out = _gn(widths[-1], groups)
        d.conv_out = nn.Conv2d(widths[-1], cfg["out_channels"], 3)

    def forward(self, latent):
        o, d = self.ops, self.decoder
        x = o.conv(latent / self.scaling, self.post_quant_conv, padding=0)
        x = o.conv(x, d.conv_in)
        mid = d.mid_block
        x = mid.resnets[1](o, mid.attentions[0](o, mid.resnets[0](o, x)))
        for block in d.up_blocks:
            for res in block.resnets:
                x = res(o, x)
            if hasattr(block, "upsamplers"):
                x = o.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"), block.upsamplers[0].conv)
        return o.conv(silu(group_norm(d.conv_norm_out, x)), d.conv_out)


MODELS = {"text_encoder": CLIPTextModel, "unet": UNet, "controlnet": ControlNet, "vae": VAEDecoder}


def build(kind: str, cfg: dict, ops: Optional[Ops] = None, device="meta") -> nn.Module:
    """The ``kind`` model of ``cfg[kind]`` on ``device`` (meta: no memory)."""
    with torch.device(device):
        return MODELS[kind](cfg[kind], ops or Ops()).eval()
