"""A toy model family at small widths for the CPU tests, with what a second
architecture such as SDXL brings that SD1.5 has not: two text encoders whose last
hidden states are concatenated on the feature axis into the context, and a
pooled vector (the second encoder's state at the first end-of-text token, through
its ``text_projection``) added to the UNet's time embedding through a linear.
It counts its own FLOPs and long attentions, and its system under test is its
own reference behind its ``ReferencePipe``.

It lives outside ``sdbench/families/``: a test registers it as
``sdbench.families.twotext`` (``monkeypatch.setitem(sys.modules, ...)``), as a
new family file would be found, with no edit to the benchmark's files.

Its sampler is the deterministic DDIM update; it leaves out the prompt's
emphasis weights and the guidance rescale, and takes no control image.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from sdbench import flops
from sdbench.reference import philox
from sdbench.reference.models import (CLIPTextModel, Ops, ResnetBlock, Transformer2D, VAEDecoder, group_norm,
                                      silu, timestep_features)
from sdbench.reference.pipeline import schedule_rows
from sdbench.reference.text import BPE, UNCOND_IDS, prompt_rows

NAME = "twotext"
TOKENS = 77


def config() -> dict:
    return {
        "name": NAME, "family": NAME, "dtype": "float32",
        "tokenizer": {"merges": "sdbench/data/clip_merges.txt"},
        "scheduler": {"beta_end": 0.012, "beta_start": 0.00085, "num_train_timesteps": 1000},
        "text_encoder": {"hidden_size": 32, "intermediate_size": 64, "num_attention_heads": 2,
                         "num_hidden_layers": 2, "max_position_embeddings": TOKENS, "vocab_size": 49408},
        "text_encoder_2": {"hidden_size": 48, "intermediate_size": 96, "num_attention_heads": 3,
                           "num_hidden_layers": 2, "max_position_embeddings": TOKENS, "vocab_size": 49408,
                           "projection_dim": 24},
        "unet": {"width": 32, "heads": 2, "norm_num_groups": 8, "cross_attention_dim": 32 + 48,
                 "pooled_dim": 24},
        "vae": {"block_out_channels": [32, 32, 64, 64], "latent_channels": 4, "layers_per_block": 1,
                "norm_num_groups": 32, "out_channels": 3, "scaling_factor": 0.13025},
    }


class CLIPTextWithProjection(CLIPTextModel):
    """The second encoder: its last hidden state and its pooled, projected vector."""

    def __init__(self, cfg: dict, ops: Ops):
        super().__init__(cfg, ops)
        self.text_projection = nn.Linear(cfg["hidden_size"], cfg["projection_dim"], bias=False)

    def forward(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        hidden = super().forward(tokens)
        eos = tokens.argmax(-1)  # the end-of-text id is the vocabulary's last
        pooled = hidden[torch.arange(tokens.shape[0], device=tokens.device), eos]
        return hidden, self.ops.linear(pooled, self.text_projection)


class UNet(nn.Module):
    """``conv_in``, one ResNet block on the time embedding plus the pooled
    vector's, one transformer on the context, GroupNorm, SiLU, ``conv_out``."""

    def __init__(self, cfg: dict, ops: Ops):
        super().__init__()
        self.ops, self.width = ops, cfg["width"]
        w, groups, temb = cfg["width"], cfg["norm_num_groups"], 4 * cfg["width"]
        te = self.time_embedding = nn.Module()
        te.linear_1, te.linear_2 = nn.Linear(w, temb), nn.Linear(temb, temb)
        self.add_embedding = nn.Linear(cfg["pooled_dim"], temb)
        self.conv_in = nn.Conv2d(4, w, 3)
        self.resnet = ResnetBlock(w, w, temb, groups)
        self.attention = Transformer2D(w, cfg["cross_attention_dim"], cfg["heads"], groups)
        self.conv_norm_out = nn.GroupNorm(groups, w)
        self.conv_out = nn.Conv2d(w, 4, 3)

    def forward(self, x, t, context, pooled):
        o, te = self.ops, self.time_embedding
        temb = o.linear(silu(o.linear(timestep_features(t, self.width), te.linear_1)), te.linear_2)
        temb = temb + o.linear(pooled, self.add_embedding)
        h = self.resnet(o, o.conv(x, self.conv_in), temb)
        h = self.attention(o, h, context)
        return o.conv(silu(group_norm(self.conv_norm_out, h)), self.conv_out)


MODELS = {"text_encoder": CLIPTextModel, "text_encoder_2": CLIPTextWithProjection, "unet": UNet,
          "vae": VAEDecoder}


def kinds(cfg: dict) -> List[str]:
    return list(MODELS)


def build(kind: str, cfg: dict, ops: Optional[Ops] = None, device="meta") -> nn.Module:
    with torch.device(device):
        return MODELS[kind](cfg[kind], ops or Ops()).eval()


class Reference:
    """The toy's models in fp32 on ``device``, from ``{kind: {name: tensor}}``."""

    def __init__(self, cfg: dict, weights: Dict[str, Dict[str, torch.Tensor]], merges_path: str, device,
                 ops: Optional[Ops] = None):
        self.cfg, self.device = cfg, torch.device(device)
        self.bpe = BPE(merges_path)
        self.models = {}
        for kind, state in weights.items():
            model = build(kind, cfg, ops)
            model.load_state_dict(state, strict=True, assign=True)
            self.models[kind] = model.to(self.device)

    @torch.no_grad()
    def _packed(self, ids: List[int]) -> torch.Tensor:
        """(78, C1 + C2): both encoders' states side by side, and the pooled
        vector as one more row, zero-padded: one tensor, as the serving worker
        stacks a context."""
        tokens = torch.tensor([ids], device=self.device)
        first = self.models["text_encoder"](tokens)
        second, pooled = self.models["text_encoder_2"](tokens)
        context = torch.cat([first, second], dim=-1)[0]
        row = torch.zeros(1, context.shape[1], device=self.device)
        row[0, :pooled.shape[1]] = pooled[0]
        return torch.cat([context, row])

    def context(self, prompt: str) -> torch.Tensor:
        return self._packed(prompt_rows(self.bpe, prompt)[0])

    @torch.no_grad()
    def generate(self, packed: torch.Tensor, noise: np.ndarray, steps: int, guidance: float) -> np.ndarray:
        """The uint8 (B, H, W, 3) images of the (B, h, w, 4) ``noise`` under the
        packed contexts ((1 or B), 78, C), guided where ``guidance`` > 0."""
        dev = self.device
        x = torch.from_numpy(np.ascontiguousarray(noise)).to(dev).permute(0, 3, 1, 2).contiguous()
        batch = x.shape[0]
        cond = packed.to(dev).expand(batch, -1, -1)
        guided = guidance > 0.0
        if guided:
            cond = torch.cat([self._packed(UNCOND_IDS)[None].expand(batch, -1, -1), cond])
        context, pooled = cond[:, :-1], cond[:, -1, :self.cfg["unet"]["pooled_dim"]]
        ts, rows = schedule_rows("ddim", steps, self.cfg["scheduler"])
        for i, t in enumerate(ts):
            r = rows[i]
            xx = torch.cat([x, x]) if guided else x
            out = self.models["unet"](xx, torch.full((xx.shape[0],), float(t), device=dev), context, pooled)
            if guided:
                eps_u, eps_c = out.chunk(2)
                out = eps_u + guidance * (eps_c - eps_u)
            x0 = (x - r["nr"] * out) / r["sr"]
            x = x0 if i == steps - 1 else r["sr_prev"] * x0 + r["nr_prev"] * out
        return self.decode(x)

    @torch.no_grad()
    def decode(self, latent: torch.Tensor) -> np.ndarray:
        image = (self.models["vae"](latent) + 1.0) * 0.5
        image = (image * 255.0).clamp(0.0, 255.0).to(torch.uint8)
        return image.permute(0, 2, 3, 1).cpu().numpy()

    def text_to_image(self, prompt: str, seed: int, height: int, width: int, steps: int, guidance: float,
                      batch: int = 1) -> np.ndarray:
        noise = philox.stateless_normal((batch, height // 8, width // 8, 4), seed)
        return self.generate(self.context(prompt)[None], noise, steps, guidance)

    def request(self, req, mix: dict) -> np.ndarray:
        return self.text_to_image(req.prompt, req.seed, mix["height"], mix["width"], req.steps, req.guidance,
                                  req.batch)


class ReferencePipe:
    """The toy's reference behind the entry points the harness and the serving
    worker call: a context is the packed tensor of ``Reference.context``."""

    def __init__(self, ref: Reference, mix: dict, device):
        if mix.get("scheduler", "ddim") != "ddim" or mix.get("control"):
            raise ValueError("the toy family runs DDIM only, with no control image")
        self.ref = ref
        self.img_height, self.img_width = mix["height"], mix["width"]
        self.device = torch.device(device)

    def _encode_text_dev(self, prompt: str) -> torch.Tensor:
        return self.ref.context(prompt)

    def encode_text(self, prompt: str) -> np.ndarray:
        return self.ref.context(prompt).cpu().numpy()

    def text_to_image(self, prompt, batch_size=1, num_steps=50, unconditional_guidance_scale=7.5,
                      guidance_rescale=0.7, seed=None, control_net_image=None):
        return self.ref.text_to_image(prompt, seed, self.img_height, self.img_width, num_steps,
                                      unconditional_guidance_scale, batch_size)

    def generate_image(self, encoded_text, negative_prompt=None, batch_size=1, num_steps=50,
                       unconditional_guidance_scale=7.5, diffusion_noise=None, seed=None, guidance_rescale=0.0,
                       _defer_fetch=False):
        packed = torch.as_tensor(encoded_text, dtype=torch.float32).to(self.device)
        packed = packed[None] if packed.dim() == 2 else packed
        noise = (np.asarray(diffusion_noise, np.float32) if diffusion_noise is not None else
                 philox.stateless_normal((batch_size, self.img_height // 8, self.img_width // 8, 4), seed))
        return self.ref.generate(packed, noise, num_steps, unconditional_guidance_scale)


def build_pipeline(cfg: dict, weights: Dict[str, Dict[str, torch.Tensor]], mix: dict, device, merges_path: str,
                   compute_dtype: Optional[torch.dtype] = None) -> ReferencePipe:
    return ReferencePipe(Reference(cfg, weights, merges_path, device), mix, device)


def _settings(mix: dict, req) -> Tuple[int, int, int]:
    """(steps, rows a UNet call, batch) of ``req``, or of a one-image request at
    the mix's settings."""
    if req is None:
        return mix["steps"], 2 if mix["guidance"] > 0 else 1, 1
    return req.steps, 2 if req.guidance > 0 else 1, req.batch


def request_flops(cfg: dict, mix: dict, req=None) -> int:
    """Both encoders on the prompt, the UNet every step on the guided pair, the
    decode of each image."""
    steps, rows, batch = _settings(mix, req)
    h8, w8, meta = mix["height"] // 8, mix["width"] // 8, torch.device("meta")
    tokens = torch.zeros(1, TOKENS, dtype=torch.long, device=meta)
    with torch.no_grad():
        text = sum(flops.count(lambda k=k: build(k, cfg)(tokens)) for k in ("text_encoder", "text_encoder_2"))
        unet = build("unet", cfg)
        step = flops.count(lambda: unet(torch.zeros(rows, 4, h8, w8, device=meta), torch.zeros(rows, device=meta),
                                        torch.zeros(rows, TOKENS, cfg["unet"]["cross_attention_dim"], device=meta),
                                        torch.zeros(rows, cfg["unet"]["pooled_dim"], device=meta)))
        decode = flops.count(lambda: build("vae", cfg)(torch.zeros(1, 4, h8, w8, device=meta)))
    return text + batch * (steps * step + decode)


def long_attentions(cfg: dict, mix: dict, req=None) -> List[Tuple[int, Tuple[int, int, int, int]]]:
    """Every self-attention over the latent: the UNet's each step, the VAE's once."""
    steps, rows, batch = _settings(mix, req)
    tokens, u = (mix["height"] // 8) * (mix["width"] // 8), cfg["unet"]
    return [(steps, (batch * rows, tokens, u["heads"], u["width"] // u["heads"])),
            (1, (batch, tokens, 1, cfg["vae"]["block_out_channels"][-1]))]
