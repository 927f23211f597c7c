"""CLIP ViT-L/14 text stack as an ``nn.Module`` plus functions over it.

  - the token + position embedding is a separate stage from the transformer, so
    textual-inversion vectors can be spliced in between;
  - 12 pre-LayerNorm encoder blocks, 12 heads, 768 dim, quick_gelu MLP, causal mask;
  - ``clip_skip``: run layers ``0 .. 12 + clip_skip`` and apply the final
    LayerNorm to that output (-1 is the usual last layer).

The encoder always runs in fp32 (weights stored in the compute dtype are upcast per
op), as in the JAX package. ``state_dict`` keys use the HF/diffusers names
(``text_model.encoder.layers.{i}.*``, ``text_model.embeddings.*``,
``text_model.final_layer_norm``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from minsdtf_tpu_torch.models.common import apply_dense, build, param_shapes
from minsdtf_tpu_torch.ops.attention import multi_head_attention
from minsdtf_tpu_torch.ops.basic import layer_norm, quick_gelu

EMBED_DIM = 768
NUM_HEADS = 12
NUM_LAYERS = 12
VOCAB_SIZE = 49408
MAX_LENGTH = 77
# CLIP's special token ids, for the unconditional row [BOS] + [EOT]*76
UNCOND_BOS = 49406
UNCOND_PAD = 49407


def _ln(m: nn.LayerNorm, x):
    return layer_norm(x, m.weight, m.bias)


class EncoderLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(EMBED_DIM)
        self.self_attn = nn.Module()
        self.self_attn.num_heads = NUM_HEADS  # this rank's heads under TP
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self.self_attn, proj, nn.Linear(EMBED_DIM, EMBED_DIM))
        self.layer_norm2 = nn.LayerNorm(EMBED_DIM)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(EMBED_DIM, EMBED_DIM * 4)
        self.mlp.fc2 = nn.Linear(EMBED_DIM * 4, EMBED_DIM)

    def forward(self, x):
        a = self.self_attn
        h = _ln(self.layer_norm1, x)
        attn = multi_head_attention(apply_dense(a.q_proj, h), apply_dense(a.k_proj, h),
                                    apply_dense(a.v_proj, h), num_heads=a.num_heads,
                                    causal=True)
        x = x + apply_dense(a.out_proj, attn)
        h = quick_gelu(apply_dense(self.mlp.fc1, _ln(self.layer_norm2, x)))
        return x + apply_dense(self.mlp.fc2, h)


class TextModel(nn.Module):
    def __init__(self):
        super().__init__()
        self.embeddings = nn.Module()
        self.embeddings.token_embedding = nn.Embedding(VOCAB_SIZE, EMBED_DIM)
        self.embeddings.position_embedding = nn.Embedding(MAX_LENGTH, EMBED_DIM)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList([EncoderLayer() for _ in range(NUM_LAYERS)])
        self.final_layer_norm = nn.LayerNorm(EMBED_DIM)


class CLIPTextModel(nn.Module):
    def __init__(self):
        super().__init__()
        self.text_model = TextModel()


def clip_embedding(model: CLIPTextModel, tokens: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    """Token + position embedding. tokens/positions: (B, S) int -> (B, S, 768)."""
    emb = model.text_model.embeddings
    return emb.token_embedding.weight[tokens] + emb.position_embedding.weight[positions]


def text_encoder(model: CLIPTextModel, clip_emb: torch.Tensor, clip_skip: int = -1) -> torch.Tensor:
    """Encoder layers ``0 .. NUM_LAYERS + clip_skip`` then the final LayerNorm."""
    num_effective = NUM_LAYERS + clip_skip + 1
    if not 1 <= num_effective <= NUM_LAYERS:
        raise ValueError(f"invalid clip_skip {clip_skip}")
    tm = model.text_model
    x = clip_emb
    for layer in tm.encoder.layers[:num_effective]:
        x = layer(x)
    return _ln(tm.final_layer_norm, x)


def fused_lpw_encode(
    model: CLIPTextModel,
    tokens: torch.Tensor,              # (B, (MAX_LENGTH-2)*m + 2) int, LPW-padded
    weights: Optional[torch.Tensor],   # (B, L_out) fp32 per-token weights, or None
    embedding: Optional[torch.Tensor] = None,  # (1, splice_n, 768) textual inversion
    *,
    m: int,                            # chunk count
    splice_n: int = 0,                 # textual-inversion token count (0 = none)
    with_uncond: bool,                 # also encode [BOS]+[EOT]*76 in the same batch
    no_boseos_middle: bool,
    clip_skip: int,
    bos: int,                          # tokenizer BOS/EOT ids for chunk boundaries
    eot: int,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The whole text stack in one batch: chunk split -> embed -> textual-inversion
    splice -> encoder -> boundary strip -> LPW weighting with the mean-preserving
    rescale, plus the unconditional context as one extra batch row when
    ``with_uncond``. The splice writes ``embedding`` over positions ``1..splice_n``
    of chunk 0 of each prompt row; the unconditional row is left as it is.

    Returns ``(context fp32 (B, L_out, 768), uncond fp32 (1, 77, 768) | None)``."""
    b = tokens.shape[0]
    chunk = MAX_LENGTH
    step = chunk - 2
    if m == 1:
        rows = tokens
    else:
        # overlapping 77-token windows with BOS/EOT written over the boundaries
        cs = []
        for i in range(m):
            c = tokens[:, i * step: i * step + chunk].clone()
            c[:, 0] = bos
            c[:, -1] = eot
            cs.append(c)
        rows = torch.cat(cs, dim=0)  # (m*B, 77), chunk-major
    if with_uncond:
        urow = torch.full((1, chunk), UNCOND_PAD, dtype=rows.dtype, device=rows.device)
        urow[0, 0] = UNCOND_BOS
        rows = torch.cat([rows, urow], dim=0)
    positions = torch.arange(chunk, device=rows.device).expand(rows.shape)
    emb = clip_embedding(model, rows, positions)
    if splice_n:
        tiled = embedding.to(emb.dtype).expand(b, splice_n, emb.shape[-1])
        head = torch.cat([emb[:b, :1], tiled, emb[:b, splice_n + 1:]], dim=1)
        emb = torch.cat([head, emb[b:]], dim=0)
    enc = text_encoder(model, emb.float(), clip_skip=clip_skip)
    uncond = enc[-1:] if with_uncond else None
    if with_uncond:
        enc = enc[:-1]
    if m == 1:
        out = enc
    else:
        parts = []
        for i in range(m):
            e = enc[i * b: (i + 1) * b]
            if no_boseos_middle:
                e = e[:, (0 if i == 0 else 1): (None if i == m - 1 else -1)]
            parts.append(e)
        out = torch.cat(parts, dim=1)
    out = out.float()
    if weights is not None:
        prev_mean = out.mean(dim=(-2, -1))
        out = out * weights.float()[:, :, None]
        out = out * (prev_mean / out.mean(dim=(-2, -1)))[:, None, None]
    return out, uncond


def encode_tokens(model: CLIPTextModel, tokens: torch.Tensor, clip_skip: int = -1) -> torch.Tensor:
    """Embedding + encoder in one call; positions are 0..S-1."""
    positions = torch.arange(tokens.shape[-1], device=tokens.device).expand(tokens.shape)
    return text_encoder(model, clip_embedding(model, tokens, positions).float(), clip_skip)


def param_specs() -> Dict[str, Tuple[int, ...]]:
    return param_shapes(CLIPTextModel)


def init(device, seed: int = 1) -> CLIPTextModel:
    """Random-initialized text model on ``device`` (see :func:`models.common.build`)."""
    return build(CLIPTextModel, device, seed)


def uncond_tokens() -> np.ndarray:
    return np.asarray([[UNCOND_BOS] + [UNCOND_PAD] * (MAX_LENGTH - 1)], np.int64)
