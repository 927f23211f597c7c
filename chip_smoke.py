"""Smoke run of the PyTorch port on one NVIDIA card (H100): builds the CUDA kernels,
holds each against its plain PyTorch version, times them, and drives the main path
(SD1.5 txt2img, 512x512, 25 steps, CFG 7.5, bf16, full widths, random weights),
the 1024x1024 path, whose UNet level 0 (16384 tokens) runs on K2, and at 512x512
img2img and inpaint (strength 0.8: 20 steps; the VAE encoder's attention on K2)
and ControlNet txt2img (its self-attention on K1), on synthetic numpy inputs;
then on the same 512x512 modules the other samplers: DPM++ 2M Karras (15 steps),
Euler-a (25), TCD at batch 8 (4 steps; K1 at B = 16), LCM (4), and a 25-step
txt2img with a textual-inversion embedding from a ``.safetensors`` file, a
``.pt`` negative embedding and a two-chunk prompt, which takes two UNet calls a
step (K1 at B = 1).

    python3 chip_smoke.py

Every image goes through the pipeline's captured step program (``sampler``: the
step's body and the decode as CUDA graphs, captured at a signature's first image
and replayed); the mesh paths of group 12 run the step loop, the same body with
nothing captured. Phase 5l holds the
1024px program against the sampler's step loop (``sampler._generate_eager``)
bit for bit, with the launch counts, and times three warm 1024px images through
the loop. Phase 5k, after 5c-5j, holds the program against the loop bit for bit
at 512x512 (txt2img, ControlNet, inpaint, TCD at batch 8, DPM++ 2M Karras), runs
CFG 5.0 after 7.5 (no new capture, equal to the loop), prints each pipeline's
programs (held, captured, capture seconds, replays, pool bytes) and times five
warm 512px images through the loop, whose profiles (phases 7 and 7b) go to
``profile_loop.txt`` and ``profile_1024_loop.txt``. Each phase's log line also gives the cold image's
difference from the first warm one.

After the checks it profiles one more warm image with ``torch.profiler`` at each
size, with the ControlNet and of img2img, and one TCD batch of 8, and prints the
device time by kernel group and the device's busy share (the full tables by
kernel go to ``chiprun_out/chip_smoke/profile.txt``, ``profile_1024.txt``,
``profile_controlnet.txt``, ``profile_img2img.txt`` and ``profile_tcd_b8.txt``).
In every profile (these, the serve burst's and int8's) the launch counters' change
over the image must equal the K1, K2 and int8 kernels that the device ran, by
name: a replay adds its capture's counts, and this holds them to the graphs.

Then it loads weights from files written from the same seeds, under
``build/chip_smoke_ckpt/`` (removed at the end; about 5.8 GB of checkpoints and
5.7 GB of converted-weights caches): a fp32 single-file LDM checkpoint (8a), a
``control_model.*`` ControlNet ``.pth`` (8b) and a kohya LoRA over every module
its rewrite tables reach (8c). The loaded tensors must equal the random
pipeline's bit for bit and give its images exactly; the LoRA-merged weights must
equal the script's own fp32 merge, and ``set_lora(None)`` must give 8a's image
back.

Phase group 9 drives the serving path on the 512px pipeline, while 8a's files
still exist: ``generate_images`` over four pre-encoded prompts against each
seed's ``generate_image`` (9a); the batching HTTP server (``tools.serve``) with 8
concurrent requests, merged batches held against their replays and measured
against each request's batch-1 image, and a profile of the burst
(``profile_serve.txt``; 9b); ``warm_text``, a prompt-cache hit and ``set_lora``
emptying the cache (9c); ``tools.golden`` twice and ``tools.selfcheck`` (9d).

Phase group 10 trains: the full-width SD1.5 UNet (fp32, fused, seed 0) takes one
step and five timed steps of the port's AdamW on a batch of 4 64x64 latents
(10a: s/step, samples/s, peak memory; finite falling losses, finite nonzero
gradients, no kernel launch, and a TransformerBlock on the default route with
grad refused by the kernels' wrappers); two steps of a small UNet at a 32x32
latent on the card and on the CPU agree, each device's AdamW equals optax's on
its own gradients, and a card run with torch's default weight decay fails that
check (10b).

Phase group 11 runs the int8 paths (``weight_dtype="int8"`` and ``"int8_hybrid"``)
at full width, 512x512, 25 steps, CFG 7.5, bf16, on weights from phase 5's seeds:
int8 with dynamic activation scales, 227 sites and 5,675 products an image, K1/K2
250/1, its PSNR against phase 5's bf16 image (11a); each distinct int8 product
shape of that image, the card's int32 result against the CPU's bit for bit and
timed against a bf16 product of the same shape, and each im2col convolution
against an fp64 convolution of the integer values (11b); a profile of one warm
int8 image beside phase 7's bf16 groups (11f, ``profile_int8.txt``);
``calibrate_int8`` and the baked scales, saved and reloaded by a new pipeline that
must give the same image bit for bit (11c); int8_hybrid after calibration and a
ControlNet txt2img under int8, 350/1 (11d); and at small widths in fp32 the three
paths on the card against the CPU, with the card's int8 roundings held to the
CPU's ties (``RoundingReplay``; 11e).

Phase 6e settles the t = 999 samplers at CFG 7.5: TCD, LCM and DPM++ 2M Karras at
phase 6c's small setting in fp64 on the CPU, against which fp32 on the CPU and on
the card are measured; the card's error may be at most twice the CPU's.

Phase group 12 runs the multi-device layer (``parallel/``, ``ops/ring_attention.py``)
at full width, 512x512, 25 steps, CFG 7.5, bf16, on phase 5's seeds. The card's
machine has one GPU, and NCCL takes one GPU per rank, so only 12a runs NCCL (world
size 1, mesh (1, 1), in this process: ``text_to_image`` with ``mesh=``, and a small
fp32 run against the CPU); the others spawn ``gloo`` ranks that share the card,
each rank's launches counted on its own: 12c DP, mesh (2, 1), batch 2, at
``MESH_CUT_STEPS`` = 10 steps (so are 12b's), each rank's row bit for bit
against one device's batch-1 call on the same modules, then a batch
of 3, which the data axis does not divide: each rank runs it whole, gathers
nothing and must equal one device's batch of 3 bit for bit; 12d spatial SP, mesh
(1, 2), 1024x1024: the UNet's level 0 and every decoder level H-sharded, the
sharded ring carrying the 125 self-attentions at 16384 tokens and the VAE's (K1
250, K2 0), every collective counted by kind with its bytes and host seconds,
only the level-0 downsampler's, ``conv_out``'s and the decoder's output rows
gathered, each rank's peak memory beside phase 5b's; 12g small fp32 spatial SP
runs at 128x128 (``MINSDTF_SP_MIN_SEQ=256``: the UNet's level 0 and every VAE
level shard) of txt2img and img2img (the encoder sharded) against the CPU; 12b
TP, mesh (1, 2), K1 at
(2,4096,4,40) and (2,1024,4,80) and K2 path B at (1,4096,1,512) on each rank
(100/1), against one device's 10-step image, then a small fp32 TP run against
the CPU; 12e two steps of the small UNet's train step on mesh (2, 2), four ranks,
against one CPU process (10b's tolerances); 12f the dry run on four ranks. The
times of group 12 are this one card's: the ranks share it and reach each other
through host memory.

Exits non-zero on any failure, when no card is visible, or when the port's package
is not beside this file. The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it lists every kernel with its
launches on the main path, its error, its time and its bound. Kernel times (``ms``)
are device times, from a CUDA graph of many calls; ``loop_ms`` is the per-call time
of a plain loop of wrapper calls, host cost included. Phase 4 also prints the floor
that the exponentials set on the special-function units, and does not time the
plain version where its fp32 scores alone would exceed ``PLAIN_MAX_SCORE_BYTES``;
phase 4f times the fp32 kernels at the shapes of fp32 512px and 1024px images,
beside SDPA with TF32 off and the kernels it ran.

Phase 4g holds the NHWC GroupNorm kernel (``csrc/group_norm.cu``, no TPU
counterpart) against the plain composition and fp64 at every UNet and VAE shape
of 512px and 1024px at batch 1 and 2, every timed shape and ragged ones, in bf16
and fp32, with and without SiLU, and times it at the 512px and 1024px UNet and VAE
shapes beside its bound (input read once and output written once, at 3.35 TB/s)
and the time of the bytes it moves (input read twice), the plain composition as
the NCHW path ran it and ``F.group_norm`` + ``F.silu``. Phases 5 and 5b also hold
the layout counters: every GroupNorm of an image on the kernel (1,555, three
launches each), none on the plain composition, no convolution that transposes;
the profiles hold the GroupNorm kernels' launches to the device's records as they
hold K1's and K2's, and the kernels' row gives each path's launches.

Phase 5m, before phase 5, drives the fp32 path: one full-width fp32 txt2img at
512x512 (25 steps, CFG 7.5, through the captured program, TF32 off; K1 250, K2 1
on the fp32 kernels), and one fp32 UNet call at that shape with the kernels
against the same call under ``plain_scope()``.
Longer logs go to ``chiprun_out/chip_smoke/``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import gzip
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import zlib

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out", "chip_smoke")
# Published H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32
# outside them, HBM3.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# The plain versions hold (B, H, Sq, Sk) fp32 scores, and a few tensors of that
# size at once: phase 4 does not time the plain version above this, and phase 3
# runs it over groups of heads whose scores stay under REF_GROUP_SCORE_BYTES.
PLAIN_MAX_SCORE_BYTES = 10e9
REF_GROUP_SCORE_BYTES = 2e9
MERGES = ["h e", "l l", "he ll", "o</w> w", "hell o</w>", "w o", "wo r", "wor l",
          "worl d</w>", "t h", "th e</w>", "a</w> b", "c a", "ca t</w>", "d o",
          "do g</w>", "s t", "st a", "sta r</w>", "1 2", "* *"]
PROMPT = "a photo of an astronaut riding a horse"
WARM_IMAGES = 5
WARM_IMAGES_1024 = 3
WARM_IMAGES_NEW = 3  # img2img, inpaint and ControlNet (phases 5c-5e)
WARM_IMAGES_SAMPLERS = 2  # the other samplers and textual inversion (phases 5f-5j)
# Phase 3: kernel, B, Sq, Sk, H, D, dtype, layout; the first of each kernel is the
# main path's.
bf16, f32 = torch.bfloat16, torch.float32
CASES = [
    ("onepass", 2, 4096, 4096, 8, 40, bf16, "fused_qkv"),
    ("onepass", 2, 1024, 1024, 8, 80, bf16, "fused_qkv"),
    ("onepass", 1, 1000, 777, 2, 40, bf16, "contiguous"),    # ragged q and KV tiles
    ("onepass", 1, 1000, 4095, 2, 40, bf16, "contiguous"),
    ("onepass", 1, 1000, 777, 2, 80, bf16, "contiguous"),
    ("onepass", 1, 1000, 4095, 2, 80, bf16, "contiguous"),
    ("onepass", 2, 1024, 1024, 8, 160, bf16, "fused_qkv"),  # the 1024px level
    ("onepass", 1, 1000, 1500, 2, 80, bf16, "heads_first"),
    ("onepass", 1, 1000, 1500, 2, 160, bf16, "heads_first"),
    ("onepass", 1, 1000, 777, 2, 36, bf16, "contiguous"),    # zero-padded to 40
    ("onepass", 1, 1000, 777, 2, 40, bf16, "odd_stride"),    # copied to 16-byte rows
    ("onepass", 2, 4096, 4096, 8, 40, bf16, "adversarial"),
    ("onepass", 2, 1024, 1024, 8, 80, bf16, "adversarial"),
    ("online", 1, 4096, 4096, 1, 512, bf16, "contiguous"),   # path B: the VAE mid-block
    ("online", 1, 1000, 1000, 1, 512, bf16, "contiguous"),   # path B, ragged q and KV tiles
    ("online", 1, 1024, 5000, 2, 40, bf16, "contiguous"),    # path A
    ("online", 1, 16384, 16384, 2, 40, bf16, "fused_qkv"),   # path A: the 1024px level 0
    ("online", 2, 16384, 16384, 8, 40, bf16, "fused_qkv"),   # path A at the level's shape
    ("online", 1, 16384, 16384, 1, 512, bf16, "contiguous"), # path B, the 1024px VAE: no KV split
    ("online", 1, 8192, 8192, 2, 40, bf16, "adversarial"),
    ("online", 1, 1000, 5000, 2, 80, bf16, "contiguous"),    # ragged q and KV tiles
    ("online", 1, 1000, 5000, 2, 160, bf16, "contiguous"),
    ("online", 1, 4096, 4096, 1, 512, bf16, "adversarial"),  # path B
    ("online", 1, 300, 1000, 1, 192, bf16, "contiguous"),    # zero-padded to 512
    ("online", 1, 1000, 5000, 2, 36, bf16, "contiguous"),    # zero-padded to 40
    ("online", 1, 1000, 5000, 2, 40, bf16, "odd_stride"),    # copied to 16-byte rows
]
# The shapes that batch 8 (TCD) and the two-call CFG path (one UNet call per
# context) give the kernels; the on-card tests run them too.
BATCH_CASES = [
    ("onepass", 16, 4096, 4096, 8, 40, bf16, "fused_qkv"),   # TCD at batch 8 under CFG
    ("onepass", 16, 1024, 1024, 8, 80, bf16, "fused_qkv"),
    ("onepass", 1, 4096, 4096, 8, 40, bf16, "fused_qkv"),    # the two-call CFG path
    ("onepass", 1, 1024, 1024, 8, 80, bf16, "fused_qkv"),
    ("onepass", 16, 4096, 4096, 8, 40, bf16, "adversarial"),
    ("online", 8, 4096, 4096, 1, 512, bf16, "contiguous"),   # path B at batch 8: no KV split
]
# The shapes that the server's merged batches of 2 and 4 images give the kernels
# (batch 8 is TCD's, above); the on-card tests run them too.
SERVE_CASES = [
    ("onepass", 4, 4096, 4096, 8, 40, bf16, "fused_qkv"),    # a merged batch of 2 under CFG
    ("onepass", 8, 4096, 4096, 8, 40, bf16, "fused_qkv"),    # a merged batch of 4
    ("onepass", 4, 1024, 1024, 8, 80, bf16, "fused_qkv"),
    ("onepass", 8, 1024, 1024, 8, 80, bf16, "fused_qkv"),
    ("online", 2, 4096, 4096, 1, 512, bf16, "contiguous"),   # path B: the decoder at batch 2
    ("online", 4, 4096, 4096, 1, 512, bf16, "contiguous"),
]
# The shapes that Megatron TP gives K1, each rank running 8 / model heads (phase
# 12b at model = 2; model = 4 for the record); the on-card tests run them too.
TP_CASES = [
    ("onepass", 2, 4096, 4096, 4, 40, bf16, "contiguous"),
    ("onepass", 2, 1024, 1024, 4, 80, bf16, "contiguous"),
    ("onepass", 2, 4096, 4096, 2, 40, bf16, "contiguous"),
    ("onepass", 2, 1024, 1024, 2, 80, bf16, "contiguous"),
    ("onepass", 2, 4096, 4096, 4, 40, bf16, "adversarial"),
]
# The fp32 kernels: the shapes of an fp32 512px image (the first of each kernel is
# the fp32 path's), ragged q and KV tiles, the padded copy, K2's fp32 body past
# 4096 keys and its d = 192 and d = 512 kernels.
F32_CASES = [
    ("onepass", 2, 4096, 4096, 8, 40, f32, "fused_qkv"),
    ("onepass", 2, 1024, 1024, 8, 80, f32, "fused_qkv"),
    ("onepass", 1, 1000, 777, 2, 40, f32, "contiguous"),     # ragged q and KV tiles
    ("onepass", 1, 1000, 4095, 2, 40, f32, "contiguous"),
    ("onepass", 1, 1000, 777, 2, 80, f32, "contiguous"),
    ("onepass", 1, 1000, 4095, 2, 80, f32, "contiguous"),
    ("onepass", 1, 1000, 777, 2, 160, f32, "contiguous"),
    ("onepass", 1, 1000, 4095, 2, 160, f32, "contiguous"),
    ("onepass", 2, 1024, 1024, 8, 160, f32, "fused_qkv"),   # the 1024px level
    ("onepass", 1, 1000, 777, 2, 36, f32, "contiguous"),     # zero-padded to 40
    ("onepass", 1, 1000, 777, 2, 40, f32, "odd_stride"),     # copied to 16-byte rows
    ("onepass", 2, 4096, 4096, 8, 40, f32, "adversarial"),
    ("onepass", 1, 100, 530, 1, 160, f32, "heads_first"),
    ("online", 1, 4096, 4096, 1, 512, f32, "fused_qkv"),     # the VAE mid-block's shape
    ("online", 1, 1000, 1000, 1, 512, f32, "contiguous"),    # ragged q and KV tiles
    ("online", 1, 512, 600, 1, 512, f32, "contiguous"),
    ("online", 1, 1024, 5000, 2, 40, f32, "contiguous"),     # the fp32 body past 4096 keys
    ("online", 1, 1000, 5000, 2, 80, f32, "contiguous"),
    ("online", 1, 1000, 5000, 2, 160, f32, "heads_first"),
    ("online", 1, 1000, 1000, 1, 192, f32, "contiguous"),    # the small VAE's width
    ("online", 1, 70, 513, 2, 192, f32, "heads_first"),
    ("online", 1, 1000, 5000, 2, 36, f32, "contiguous"),     # zero-padded to 40
    ("online", 1, 300, 1000, 1, 300, f32, "contiguous"),     # zero-padded to 512
    ("online", 1, 1000, 5000, 2, 40, f32, "odd_stride"),     # copied to 16-byte rows
    ("online", 1, 8192, 8192, 2, 40, f32, "adversarial"),
    ("online", 1, 4096, 4096, 1, 512, f32, "adversarial"),
]
CASES += BATCH_CASES + SERVE_CASES + TP_CASES + F32_CASES


def log(*args):
    print(*args, flush=True)


def synthetic_merges(directory: str) -> str:
    path = os.path.join(directory, "merges.txt.gz")
    with gzip.open(path, "wt") as f:
        f.write("#version: synthetic\n" + "\n".join(MERGES) + "\n")
    return path


def qkv(b, sq, sk, h, d, dtype, gen, layout):
    """q, k, v as (B, S, H, D) on ``gen``'s device. ``layout``: "contiguous";
    "fused_qkv", strided views of one (B, S, 3*H*D) tensor, as the UNet's fused
    to_qkv projection hands them over; "heads_first", (B, H, S, D) tensors seen
    through a transpose; "odd_stride", views of (B, S, H, D + 1) tensors whose rows
    do not start on 16 bytes; or "adversarial", contiguous inputs whose rows find
    their largest scores in the last KV tile (:func:`adversarial_qkv`)."""
    dev = gen.device
    if layout == "fused_qkv":
        x = torch.randn(b, sq, 3 * h * d, generator=gen, device=dev).to(dtype)
        return tuple(t.unflatten(-1, (h, d)) for t in x.chunk(3, dim=-1))
    if layout == "adversarial":
        return adversarial_qkv(b, sq, sk, h, d, dtype, gen)
    shapes = ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d))
    if layout == "heads_first":
        return tuple(torch.randn(s[0], s[2], s[1], s[3], generator=gen, device=dev)
                     .to(dtype).transpose(1, 2) for s in shapes)
    if layout == "odd_stride":
        return tuple(torch.randn(*s[:3], d + 1, generator=gen, device=dev)
                     .to(dtype)[..., :d] for s in shapes)
    return tuple(torch.randn(*s, generator=gen, device=dev).to(dtype) for s in shapes)


def adversarial_qkv(b, sq, sk, h, d, dtype, gen):
    """Every q row leans on one direction u (and q is scaled x4), and the keys are
    sorted by their score against u, so each row's largest scores lie in the last
    KV tile and its running max grows tile after tile: a missing or wrong online
    rescale, or a stale max, shows."""
    dev = gen.device
    u = torch.randn(d, generator=gen, device=dev)
    u = u / u.norm()
    k = torch.randn(b, sk, h, d, generator=gen, device=dev)
    order = (k @ u).argsort(dim=1)
    k = k.gather(1, order.unsqueeze(-1).expand(-1, -1, -1, d))
    q = 4 * (d ** 0.5 * u + 0.25 * torch.randn(b, sq, h, d, generator=gen, device=dev))
    v = torch.randn(b, sk, h, d, generator=gen, device=dev)
    return tuple(t.to(dtype) for t in (q, k, v))


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph, replayed
    once to warm up and once under CUDA events. The graph leaves out the host's
    cost of each call, which for a kernel of some 30 us is as long as the kernel."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_loop_ms(fn, iters: int, warmup: int = 2) -> float:
    """Time per call of a plain loop of ``iters`` calls under CUDA events: the
    device time, or the host's cost of each call where that is the longer."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(b, sq, sk, h, d, dtype):
    """Least time for the attention: 4*B*H*Sq*Sk*D operations at the peak for the
    type, or q, k, v read once and o written once at the memory rate."""
    flops = 4.0 * b * h * sq * sk * d
    nbytes = (2 * b * sq * h * d + 2 * b * sk * h * d) * torch.finfo(dtype).bits // 8
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def exp_floor(b, sq, sk, h):
    """Least time for the B*H*Sq*Sk exponentials on the special-function units: 16
    per clock per SM at the card's maximum SM clock."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True)
    clock_hz = float(smi.stdout.strip().splitlines()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return b * h * sq * sk / (16 * sms * clock_hz) * 1e3


def phase_card():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"phase 1 card: {kind} | nvidia-smi: {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card, kind


def phase_build():
    from minsdtf_tpu_torch import kernels

    t0 = time.perf_counter()
    built = kernels.build()
    log(f"phase 2 build: {time.perf_counter() - t0:.1f} s wall for {sorted(built) or 'cached'}")
    for name, (seconds, out) in built.items():
        log(f"  {name}: nvcc {seconds:.1f} s")
        for line in out.splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                log("   ", line.strip())


def _wrappers():
    from minsdtf_tpu_torch.ops import flash_attention as fa

    return {"onepass": (fa.onepass_attention, fa.onepass_attention_plain),
            "online": (fa.online_attention, fa.online_attention_plain)}


def case_generator(case, base_seed: int = 0) -> torch.Generator:
    """A generator of its own for each phase-3 case, seeded from the case and
    ``base_seed``: a case draws the same inputs whichever cases run before it."""
    seed = zlib.crc32(repr(case).encode()) + (base_seed << 32)
    return torch.Generator(device="cuda").manual_seed(seed)


def reference(name, q, k, v, scale):
    """The plain version's output and, in bf16, ``selfcheck.rounding_slack`` (the
    allowance for p's rounding), over groups of heads whose scores stay under
    ``REF_GROUP_SCORE_BYTES``. For fp32 inputs the plain version runs in fp64: its
    own fp32 rounding reaches the fp32 tolerance where q is scaled up (the
    adversarial d = 512 case: 2.5e-5 from fp64, where the kernel is 2.8e-6), so
    the kernel is held to the function itself."""
    from minsdtf_tpu_torch.tools.selfcheck import rounding_slack

    plain = _wrappers()[name][1]
    b, sq, h, _ = q.shape
    exact = q.dtype == torch.float32
    group = max(1, int(REF_GROUP_SCORE_BYTES // ((8 if exact else 4) * sq * k.shape[1])))
    want = torch.empty(q.shape, dtype=torch.float64 if exact else q.dtype, device=q.device)
    slack = torch.zeros(q.shape, device=q.device)
    for i in range(b):
        for h0 in range(0, h, group):
            part = (slice(i, i + 1), slice(None), slice(h0, h0 + group))
            args = [t[part].double() if exact else t[part] for t in (q, k, v)]
            want[part] = plain(*args, scale)
            if q.dtype == torch.bfloat16:
                slack[part] = rounding_slack(name, q[part], k[part], v[part], scale, want[part])
    return want, slack


def check_case(case, base_seed: int = 0):
    """One phase-3 case: the kernel against its plain version on the same inputs
    (:func:`reference`), drawn by :func:`case_generator`, within ``selfcheck.TOL``
    (the package's module says why) plus the allowance for p's rounding. Returns
    (passed, max abs error, log line)."""
    from minsdtf_tpu_torch.tools.selfcheck import TOL

    name, b, sq, sk, h, d, dtype, layout = case
    q, k, v = qkv(b, sq, sk, h, d, dtype, case_generator(case, base_seed), layout)
    scale = d ** -0.5
    out = _wrappers()[name][0](q, k, v, scale)
    torch.cuda.synchronize()
    want, slack = reference(name, q, k, v, scale)
    if dtype != torch.float32:
        want = want.float()
    rtol, atol = TOL[dtype]
    err = (out.to(want.dtype) - want).abs()
    limit = atol + rtol * want.abs()
    ok = bool(torch.isfinite(out).all()) and bool((err <= limit + slack).all())
    max_err = err.max().item()
    line = (f"{name} B{b} Sq{sq} Sk{sk} H{h} D{d} {str(dtype)[6:]} {layout}: max_abs_err "
            f"{'from the plain version in fp64 ' if dtype == torch.float32 else ''}"
            f"{max_err:.3e} (output rms {want.square().mean().sqrt().item():.3e}, max |out| "
            f"{want.abs().max().item():.3e}) rtol {rtol} atol {atol}, p-rounding slack up to "
            f"{slack.max().item():.3e}, {int((err > limit).sum())} of {err.numel()} elements "
            f"beyond rtol/atol alone {'ok' if ok else 'FAIL'}")
    return ok, max_err, line


def phase_check():
    """Each kernel against its plain version; returns {(kernel, dtype): max abs
    error at its first case (the main path's, the fp32 path's)}, or None if any
    case fails."""
    errors, failed = {}, []
    for case in CASES:
        ok, err, line = check_case(case)
        log(f"phase 3 {line}")
        errors.setdefault((case[0], case[6]), err)
        if not ok:
            failed.append(case[:6] + (str(case[6])[6:], case[7]))
    if failed:
        log(f"phase 3 FAILED: {failed}")
        return None
    return errors


def phase_time(gen):
    """Kernel, plain and SDPA times at the shapes of the 512px and 1024px paths, of
    TCD at batch 8, the two-call CFG path, the server's merged batches and TP, bf16,
    beside the roofline bound and the exponentials' floor: device times from a CUDA
    graph, and the kernel's per-call time in a plain loop of wrapper calls."""
    from minsdtf_tpu_torch.ops import flash_attention as fa

    timed = [  # kernel, B, S, H, D; the first of each kernel is the 512px main path's
        ("onepass", 2, 4096, 8, 40),    # UNet 64x64 (CFG pair) at 512px
        ("onepass", 2, 1024, 8, 80),    # UNet 32x32: 512px
        ("onepass", 2, 1024, 8, 160),   # UNet 32x32 at 1024px
        ("onepass", 2, 4096, 8, 80),    # UNet 64x64 at 1024px
        ("online", 1, 4096, 1, 512),    # path B: the VAE mid-block at 512px
        ("online", 2, 16384, 8, 40),    # path A: UNet 128x128 at 1024px
        ("online", 2, 4096, 8, 40),     # path A at K1's main shape: the same body
        ("online", 1, 16384, 1, 512),   # path B: the VAE mid-block at 1024px
        ("onepass", 16, 4096, 8, 40),   # TCD at batch 8: the CFG pair of 8
        ("onepass", 16, 1024, 8, 80),
        ("onepass", 1, 4096, 8, 40),    # the two-call CFG path (5j)
        ("onepass", 1, 1024, 8, 80),
        ("online", 8, 4096, 1, 512),    # path B: the decoder at batch 8
        ("onepass", 4, 4096, 8, 40),    # the server's merged batches of 2 and 4
        ("onepass", 8, 4096, 8, 40),
        ("onepass", 4, 1024, 8, 80),
        ("onepass", 8, 1024, 8, 80),
        ("online", 2, 4096, 1, 512),
        ("online", 4, 4096, 1, 512),
        ("onepass", 2, 4096, 4, 40),    # TP at model = 2 (12b), and at model = 4
        ("onepass", 2, 1024, 4, 80),
        ("onepass", 2, 4096, 2, 40),
        ("onepass", 2, 1024, 2, 80),
    ]
    wrappers = _wrappers()
    lib = fa._lib()
    blocks_per_sm = {"onepass": lib.minsdtf_onepass_bf16_blocks_per_sm,
                     "online": lib.minsdtf_online_bf16_blocks_per_sm}
    timings = {}
    for name, b, s, h, d in timed:
        layout = "fused_qkv" if d <= 160 and h == 8 else "contiguous"  # TP: unfused
        q, k, v = qkv(b, s, s, h, d, torch.bfloat16, gen, layout)
        kern, plain = wrappers[name]
        scale = d ** -0.5
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        kernel_ms = time_ms(lambda: kern(q, k, v, scale), 20)
        loop_ms = time_loop_ms(lambda: kern(q, k, v, scale), 20)
        score_bytes = 4.0 * b * h * s * s
        plain_ms = None
        if score_bytes <= PLAIN_MAX_SCORE_BYTES:
            plain_ms = time_ms(lambda: plain(q, k, v, scale), 5, warmup=1)
        else:
            log(f"phase 4 {name} B{b} S{s} H{h} D{d}: plain version not timed, its fp32 "
                f"scores alone are {score_bytes / 1e9:.1f} GB (> {PLAIN_MAX_SCORE_BYTES / 1e9:.0f} GB)")
        library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, scale=scale), 20)
        bound_ms, bound_by = bound(b, s, s, h, d, torch.bfloat16)
        exp_floor_ms = exp_floor(b, s, s, h)
        blocks = blocks_per_sm[name](d)
        timings.setdefault(name, []).append(dict(
            shape=[b, s, h, d], dtype="bfloat16", ms=kernel_ms, loop_ms=loop_ms,
            plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by))
        plain_txt = "not timed" if plain_ms is None else f"{plain_ms:.4f} ms"
        log(f"phase 4 {name} B{b} S{s} H{h} D{d} bf16: kernel {kernel_ms:.4f} ms (graph), "
            f"{loop_ms:.4f} ms per call in a loop, plain {plain_txt}, sdpa {library_ms:.4f} ms "
            f"(kernel / sdpa {kernel_ms / library_ms:.3f}), bound {bound_ms:.4f} ms "
            f"({bound_by}), share {bound_ms / kernel_ms:.4f}, exp floor {exp_floor_ms:.4f} ms "
            f"(share {exp_floor_ms / kernel_ms:.4f}), {blocks} blocks per SM (occupancy "
            f"calculator)")
    return timings


def sdpa_kernels(fn) -> list:
    """The device kernels one ``fn()`` call runs, by ``torch.profiler``, longest
    first: which backend ``scaled_dot_product_attention`` picked."""
    from torch.profiler import ProfilerActivity, profile

    from minsdtf_tpu_torch import profiling

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return list(profiling.op_report(prof, top=None))


# 4f: an fp32 512px image's shapes (the first of each kernel is the fp32 path's),
# then an fp32 1024px image's.
FP32_TIMED = [("onepass", 2, 4096, 8, 40), ("onepass", 2, 1024, 8, 80), ("online", 1, 4096, 1, 512),
              ("onepass", 2, 4096, 8, 80), ("onepass", 2, 1024, 8, 160),
              ("online", 2, 16384, 8, 40), ("online", 1, 16384, 1, 512)]


def phase_time_fp32(gen) -> dict:
    """4f: the fp32 kernels (K1's and K2's ``flash_*_f32_kernel``, K2's
    ``flash_online_f32_wide_kernel`` at d = 512) at the shapes of fp32 512px and
    1024px images, which the fp32 pipeline (phase 5m) and ``tools.golden --audit``
    run: device time (a CUDA graph of 20 calls), the plain version (not where its
    scores exceed ``PLAIN_MAX_SCORE_BYTES``), SDPA with TF32 off and the kernels it
    ran, and the bound at the fp32 FMA peak. Returns {kernel: [timings]}."""
    wrappers = _wrappers()
    timings = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for name, b, s, h, d in FP32_TIMED:
            layout = "fused_qkv" if d <= 160 else "contiguous"
            q, k, v = qkv(b, s, s, h, d, torch.float32, gen, layout)
            kern, plain = wrappers[name]
            scale = d ** -0.5
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

            def sdpa():
                return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, scale=scale)

            kernel_ms = time_ms(lambda: kern(q, k, v, scale), 20)
            plain_ms = None
            if 4.0 * b * h * s * s <= PLAIN_MAX_SCORE_BYTES:
                plain_ms = time_ms(lambda: plain(q, k, v, scale), 5, warmup=1)
            library_ms = time_ms(sdpa, 20)
            library_kernels = sdpa_kernels(sdpa)
            bound_ms, bound_by = bound(b, s, s, h, d, torch.float32)
            timings.setdefault(name, []).append(dict(
                shape=[b, s, h, d], dtype="float32", ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, library_kernels=library_kernels, bound_ms=bound_ms,
                bound_by=bound_by))
            plain_txt = "not timed" if plain_ms is None else f"{plain_ms:.4f} ms"
            log(f"phase 4f {name} B{b} S{s} H{h} D{d} fp32: kernel {kernel_ms:.4f} ms (graph), "
                f"plain {plain_txt}, sdpa (TF32 off) {library_ms:.4f} ms running "
                f"{[n[:90] for n in library_kernels]} (kernel / sdpa "
                f"{kernel_ms / library_ms:.3f}), bound {bound_ms:.4f} ms ({bound_by}, fp32 FMA "
                f"peak), share {bound_ms / kernel_ms:.4f}")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return timings


# ---- 4g: the NHWC GroupNorm kernel ----------------------------------------------

GN_EPS = 1e-5
# (C, latent // d) of every GroupNorm of the UNet, and (C, latent * u) of the VAE
# decoder's and encoder's, at a latent of latent x latent (64 at 512px, 128 at 1024px)
GN_UNET = ((320, 1), (320, 2), (640, 2), (640, 4), (1280, 4), (1280, 8), (2560, 8), (2560, 4),
           (1920, 4), (1920, 2), (1280, 2), (960, 2), (960, 1), (640, 1))
GN_VAE = ((512, 1), (512, 2), (512, 4), (256, 4), (256, 8), (128, 8), (128, 4), (256, 2))
# (B, H, W, C) of ragged calls: groups of one channel (C = 32) and of three, one
# position, odd extents
GN_RAGGED = [(3, 5, 7, 32), (2, 33, 17, 96), (1, 1, 1, 2560), (5, 1, 3, 160), (1, 9, 1000, 64)]
# (B, H, W, C): the shapes above at 512px and 1024px at batch 1 (the decode), 2 (the
# CFG pair) and 16 (TCD at batch 8), each once, then the ragged ones
GN_CASES = list(dict.fromkeys(
    (b, n, n, c) for latent in (64, 128)
    for c, n in ([(c, latent // d) for c, d in GN_UNET] + [(c, latent * u) for c, u in GN_VAE])
    for b in (1, 2, 16))) + GN_RAGGED
# 4g's timed shapes (B, H, W, C, silu): the UNet's heaviest and lightest calls at
# 512px, its level 0 at 1024px, the VAE decoder's heaviest at both, its attention's
GN_TIMED = [(2, 64, 64, 320, True), (2, 64, 64, 960, True), (2, 32, 32, 640, True),
            (2, 8, 8, 1280, True), (2, 128, 128, 320, True), (1, 64, 64, 512, False),
            (1, 512, 512, 128, True), (1, 256, 256, 512, True), (1, 1024, 1024, 128, True),
            (16, 64, 64, 320, True)]
# 4g's checked shapes: every one at batch 1 and 2, every timed one, the ragged ones
GN_CHECKED = list(dict.fromkeys([c for c in GN_CASES if c[0] <= 2]
                                + [t[:4] for t in GN_TIMED] + GN_RAGGED))


def gn_inputs(b, h, w, c, dtype, gen):
    """(B, C, H, W) channels-last x with a mean and a spread of its own for each
    channel (means up to 4 spreads away, so the statistics cancel), and fp32
    GroupNorm weight and bias."""
    dev = gen.device
    mean = (torch.rand(c, generator=gen, device=dev) - 0.5) * 8
    spread = torch.rand(c, generator=gen, device=dev) * 1.75 + 0.25
    x = torch.randn(b, h, w, c, generator=gen, device=dev) * spread + mean
    weight = torch.randn(c, generator=gen, device=dev) * 0.3 + 1.0
    bias = torch.randn(c, generator=gen, device=dev) * 0.3 + 0.1
    return x.to(dtype).permute(0, 3, 1, 2), weight, bias


GN_FP32_TOL = 2e-5  # rtol = atol: fp32 statistics summed in another order


def bf16_step(t: torch.Tensor) -> torch.Tensor:
    """One bf16 step (8 significant bits) at the magnitude of each element of ``t``."""
    _, exponent = torch.frexp(t)
    return torch.ldexp(torch.ones_like(t), exponent - 8)


def gn_check(case, dtype, silu: bool, gen) -> dict:
    """The kernel on ``case`` (B, H, W, C) against the plain composition, image by
    image. bf16: no element further from the fp64 answer than the plain path's by
    more than one bf16 step at its magnitude, plus the fp32 rounding of the affine's
    operands (2^-20 of |x * scale| + |shift|, scale = gamma * rstd and shift = beta -
    mean * scale), which both paths compute as one fp32 x * scale + shift, and which
    a step at an output near 0 is finer than. fp32: within ``GN_FP32_TOL`` of the
    plain path. ``worst`` holds the element furthest past the limit."""
    from minsdtf_tpu_torch.ops import basic
    from minsdtf_tpu_torch.ops.group_norm import group_norm_nhwc

    b, h, w, c = case
    x, weight, bias = gn_inputs(b, h, w, c, dtype, gen)
    got = group_norm_nhwc(x, weight, bias, GN_EPS, silu=silu)
    out = dict(case=list(case), dtype=str(dtype).split(".")[-1], silu=silu, bad=0,
               layout_ok=got.stride() == basic.nhwc_strides(got.shape), err=0.0, plain_err=0.0)
    for i in range(b):
        xi = x[i:i + 1]
        plain = basic.group_norm_plain(xi, weight, bias, 32, GN_EPS)
        plain = basic.silu(plain) if silu else plain
        xd = xi.double()
        groups = xd.reshape(1, 32, -1)
        mean = groups.mean(-1)
        rstd = torch.rsqrt(groups.var(-1, correction=0) + GN_EPS)
        scale = (weight.double().view(32, -1) * rstd.view(32, 1)).view(1, c, 1, 1)
        shift = bias.double().view(1, c, 1, 1) - mean.view(32, 1).expand(32, c // 32).reshape(
            1, c, 1, 1) * scale
        norm = xd * scale + shift
        ref = norm * torch.sigmoid(norm) if silu else norm
        gi = got[i:i + 1].double()
        if dtype == torch.bfloat16:
            operand = (xd * scale).abs() + shift.abs()
            excess = ((gi - ref).abs() - (plain.double() - ref).abs() - bf16_step(ref)
                      - 2.0 ** -20 * operand)
            n_bad = int((excess > 0).sum())
            if n_bad:
                at = int(excess.argmax())
                out["worst"] = {k: float(t.flatten()[at]) for k, t in (
                    ("excess", excess), ("ref", ref), ("got", gi), ("plain", plain.double()),
                    ("operand", operand.expand_as(ref)))}
            out["bad"] += n_bad
        else:
            plain = plain.double()
            out["bad"] += int(((gi - plain).abs() > GN_FP32_TOL * (1 + plain.abs())).sum())
        out["err"] = max(out["err"], float((gi - ref).abs().max()))
        out["plain_err"] = max(out["plain_err"], float((plain.double() - ref).abs().max()))
    out["ok"] = out["bad"] == 0 and out["layout_ok"]
    return out


def gn_bytes(b, h, w, c, dtype) -> float:
    """Bytes a GroupNorm has to move at the least: the input read once, the output
    written once."""
    return 2.0 * b * h * w * c * torch.finfo(dtype).bits / 8


def phase_group_norm(gen) -> dict:
    """4g: the NHWC GroupNorm kernel against the plain composition (:func:`gn_check`)
    at ``GN_CHECKED`` in bf16 and fp32, with and without SiLU; then at ``GN_TIMED``
    in bf16: device time (a CUDA graph of 20 calls), the bound from its bytes (one
    read and one write, :func:`gn_bytes`, at 3.35 TB/s) and the time of the bytes
    the kernels move (the input read twice, the output written once), the plain
    composition as the parent ran it (NCHW in memory: cast, GroupNorm, cast, SiLU),
    and ``F.group_norm`` + ``F.silu`` in bf16 as the library's yardstick. Returns
    the numbers, or None if a check failed."""
    import torch.nn.functional as F

    from minsdtf_tpu_torch.ops import basic
    from minsdtf_tpu_torch.ops import group_norm as gn

    checks = []
    for case in GN_CHECKED:
        for dtype in (torch.bfloat16, torch.float32):
            for silu in (False, True):
                checks.append(gn_check(case, dtype, silu, gen))
    failed = [r for r in checks if not r["ok"]]
    log(f"phase 4g GroupNorm checks: {len(checks) - len(failed)} of {len(checks)} passed; worst "
        f"bf16 |err| {max(r['err'] for r in checks if r['dtype'] == 'bfloat16'):.3e} (plain "
        f"{max(r['plain_err'] for r in checks if r['dtype'] == 'bfloat16'):.3e}), fp32 "
        f"{max(r['err'] for r in checks if r['dtype'] == 'float32'):.3e} (plain "
        f"{max(r['plain_err'] for r in checks if r['dtype'] == 'float32'):.3e})")
    for r in failed:
        log(f"phase 4g FAIL {r}")
    if failed:
        return None
    timings = []
    for b, h, w, c, silu in GN_TIMED:
        x, weight, bias = gn_inputs(b, h, w, c, torch.bfloat16, gen)
        nchw = x.contiguous()
        weight16, bias16 = weight.to(torch.bfloat16), bias.to(torch.bfloat16)

        def plain():
            out = basic.group_norm_plain(nchw, weight, bias, 32, GN_EPS)
            return basic.silu(out) if silu else out

        def library():
            out = F.group_norm(nchw, 32, weight16, bias16, GN_EPS)
            return F.silu(out) if silu else out

        kernel_ms = time_ms(lambda: gn.group_norm_nhwc(x, weight, bias, GN_EPS, silu), 20)
        plain_ms = time_ms(plain, 20)
        library_ms = time_ms(library, 20)
        bound_ms = gn_bytes(b, h, w, c, torch.bfloat16) / PEAK_BYTES * 1e3
        timings.append(dict(shape=[b, h * w, c], silu=silu, ms=kernel_ms, plain_ms=plain_ms,
                            library_ms=library_ms, bound_ms=bound_ms, two_reads_ms=1.5 * bound_ms))
        log(f"phase 4g group_norm_nhwc B{b} HW{h}x{w} C{c} silu={silu} bf16: kernel "
            f"{kernel_ms:.4f} ms (graph), plain {plain_ms:.4f} ms, F.group_norm{'+silu' * silu} "
            f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms (one read, one write at 3.35 TB/s; "
            f"share {bound_ms / kernel_ms:.4f}), the kernels' bytes (two reads, one write) "
            f"{1.5 * bound_ms:.4f} ms")
    return {"checks": len(checks), "timings": timings}


def zero_launches():
    from minsdtf_tpu_torch.ops import flash_attention as fa
    from minsdtf_tpu_torch.ops import group_norm as gn

    fa.onepass_attention.launches = 0
    fa.online_attention.launches = 0
    gn.group_norm_nhwc.launches = 0


def read_launches() -> dict:
    """The hand-written kernels' launch counters: K1's, K2's and the GroupNorm
    kernels' (three a call)."""
    from minsdtf_tpu_torch.ops import flash_attention as fa
    from minsdtf_tpu_torch.ops import group_norm as gn

    return {"onepass": fa.onepass_attention.launches, "online": fa.online_attention.launches,
            "group_norm": gn.group_norm_nhwc.launches}


def attention_launches(launches: dict) -> dict:
    """K1's and K2's counts of a :func:`read_launches` reading."""
    return {key: launches[key] for key in ("onepass", "online")}


def run_phase(label, generate, size, warm_images, expect, check=None, batch=1):
    """``generate(return_latent=...)`` once cold, then ``warm_images`` times warm;
    the launch counts are zeroed just before the first warm image and read just
    after it, and K1's and K2's must equal ``expect``; the layout counters' change over
    that image (:func:`read_layout`) is logged, and must equal ``expect``'s
    ``gn_kernel``, ``gn_plain`` and ``layout_misses`` where it names them, the
    GroupNorm kernels' launches three for each ``gn_kernel``. ``check(image)`` adds
    named checks. A call
    makes ``batch`` images; its seconds per image are its wall time / ``batch``.
    Returns (passed, launches, warm seconds per image, peak GB)."""
    from minsdtf_tpu_torch.ops import group_norm as gn

    t0 = time.perf_counter()
    cold = generate()
    torch.cuda.synchronize()
    log(f"{label} cold run: {time.perf_counter() - t0:.3f} s")

    zero_launches()
    layout0 = read_layout()
    torch.cuda.reset_peak_memory_stats()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    image, latent = generate(return_latent=True)
    torch.cuda.synchronize()
    samples = [(time.perf_counter() - t0) / batch]
    launches = read_launches()
    layout = {k: v - layout0[k] for k, v in read_layout().items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for _ in range(warm_images - 1):
        t0 = time.perf_counter()
        generate()
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) / batch)
    log(f"{label} warm {size}x{size}, batch {batch}: median {statistics.median(samples):.4f} "
        f"s/img of "
        f"{len(samples)} images {[round(t, 4) for t in samples]}, peak memory {peak_gb:.3f} GB "
        f"({resident_gb:.3f} GB allocated before it), launches in the first {launches}, layout "
        f"counters {layout}; the cold image against the first warm one: max |diff| "
        f"{pixel_diff(cold, image)[0]}")
    checks = {
        f"image ({batch}, {size}, {size}, 3) uint8": image.shape == (batch, size, size, 3)
        and str(image.dtype) == "uint8",
        "latent finite": bool(torch.isfinite(torch.from_numpy(latent)).all()),
        "image not constant": int(image.max()) > int(image.min()),
        f"K1 launches == {expect['onepass']}": launches["onepass"] == expect["onepass"],
        f"K2 launches == {expect['online']}": launches["online"] == expect["online"],
        **{f"{key} == {expect[key]}": layout[key] == expect[key]
           for key in ("gn_kernel", "gn_plain", "layout_misses") if key in expect},
        **({f"GroupNorm launches == {gn.KERNELS} x {expect['gn_kernel']}":
            launches["group_norm"] == gn.KERNELS * expect["gn_kernel"]}
           if "gn_kernel" in expect else {}),
        **(check(image) if check else {}),
    }
    log(f"{label} checks: {checks}")
    return all(checks.values()), launches, samples, peak_gb


# a 25-step CFG txt2img: 61 GroupNorms a UNet call and 30 in the decode, each on the
# kernel, and no convolution that transposes
NHWC_IMAGE = {"gn_kernel": 61 * 25 + 30, "gn_plain": 0, "layout_misses": 0}


def txt2img(pipe):
    """The 25-step CFG 7.5 txt2img call that the text-to-image phases time."""
    return lambda **kw: pipe.text_to_image(PROMPT, num_steps=25, unconditional_guidance_scale=7.5,
                                           seed=1234, **kw)


def phase_txt2img(bpe, size, warm_images, expect, label):
    """size x size, 25 steps, CFG 7.5, bf16 txt2img at full SD1.5 widths (the cold
    run includes the weights' init). Returns :func:`run_phase`'s results and the
    pipeline."""
    from minsdtf_tpu_torch import StableDiffusion

    pipe = StableDiffusion(size, size, bpe_path=bpe)
    return (*run_phase(label, txt2img(pipe), size, warm_images, expect), pipe)


# 5m: the fp32 UNet call with the kernels against the same call under
# plain_scope(), relative to its largest magnitude. The two differ by the order of
# fp32 sums in attention (~1e-7 relative a call), carried through 16 blocks.
FP32_UNET_TOL = 1e-4
FP32_WARM_IMAGES = 2


def phase_fp32(bpe: str):
    """5m: the fp32 path end to end. One full-width fp32 txt2img at 512x512 (25
    steps, CFG 7.5, batch 1, through the captured program; TF32 off), one cold image
    and ``FP32_WARM_IMAGES`` warm ones, K1 250 and K2 1 an image (the fp32
    kernels); then one full-width fp32 UNet call at that shape (batch 2 under CFG,
    64x64 latent, seeded inputs) with the kernels against the same call under
    ``plain_scope()``, within ``FP32_UNET_TOL`` of its largest magnitude, launching
    K1 10 times (the 4096- and 1024-token levels). Returns (passed, launches, warm
    s/img samples, peak GB, the UNet call's relative error), or None."""
    from minsdtf_tpu_torch import StableDiffusion
    from minsdtf_tpu_torch import scheduler
    from minsdtf_tpu_torch.ops import attention as attn

    pipe = StableDiffusion(512, 512, bpe_path=bpe, compute_dtype=torch.float32)
    ok, launches, samples, peak_gb = run_phase(
        "phase 5m fp32 txt2img", txt2img(pipe), 512, FP32_WARM_IMAGES, {"onepass": 250, "online": 1})
    gen = torch.Generator(device="cuda").manual_seed(12)
    latent = torch.randn(2, 64, 64, 4, generator=gen, device="cuda")
    context = torch.randn(2, 77, 768, generator=gen, device="cuda")
    t_emb = torch.from_numpy(scheduler.timestep_embedding(np.array([500, 500]))).cuda()
    with torch.no_grad():
        zero_launches()
        got = pipe.unet(latent, t_emb, context)
        torch.cuda.synchronize()
        unet_launches = read_launches()
        with attn.plain_scope():
            want = pipe.unet(latent, t_emb, context)
        torch.cuda.synchronize()
    err = ((got - want).abs().max() / want.abs().max()).item()
    checks = {"UNet output finite": bool(torch.isfinite(got).all()),
              f"UNet against plain_scope within {FP32_UNET_TOL} of its largest": err <= FP32_UNET_TOL,
              "UNet call launches K1 10, K2 0":
                  attention_launches(unet_launches) == {"onepass": 10, "online": 0}}
    log(f"phase 5m fp32 UNet call (2, 64, 64, 4) with the kernels against plain_scope(): max "
        f"|diff| / max |plain| {err:.3e} (tol {FP32_UNET_TOL}; max |plain| "
        f"{want.abs().max().item():.3e}), launches {unet_launches}; checks: {checks}")
    del pipe
    torch.cuda.empty_cache()
    return ok and all(checks.values()), launches, samples, peak_gb, err


def synthetic_inputs(size: int, seed: int = 5):
    """uint8 numpy inputs made from ``seed``: a reference image (colour gradients
    plus noise), a disc mask (255 inside) and an edge map like a canny output (a
    ring and a diagonal, white on black, 3 channels)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size] / size
    base = np.stack([yy, xx, 1.0 - (yy + xx) / 2], axis=-1) * 200.0
    reference = (base + rng.uniform(0, 55, (size, size, 3))).astype(np.uint8)
    radius = np.hypot(yy - 0.5, xx - 0.5)
    mask = np.where(radius < 0.25, 255, 0).astype(np.uint8)
    edges = (np.abs(radius - 0.3) < 1.5 / size) | (np.abs(yy - xx) < 1.0 / size)
    edges = np.repeat(np.where(edges, 255, 0).astype(np.uint8)[..., None], 3, axis=-1)
    return reference, mask, edges


def phase_new_paths(pipe, size: int):
    """img2img (5c), inpaint (5d) and ControlNet txt2img (5e) on ``pipe``'s weights,
    25 steps, CFG 7.5, bf16, strength 0.8 (20 steps), mask blur 5; the ControlNet
    is made from seed 3. Returns {path: run_phase results + (the generate call,)},
    or None if a phase failed."""
    from minsdtf_tpu_torch import imaging
    from minsdtf_tpu_torch.models import controlnet as controlnet_lib
    from minsdtf_tpu_torch.models import unet as unet_lib
    from minsdtf_tpu_torch.models.common import cast_weights_

    reference, mask, edges = synthetic_inputs(size)
    keep = imaging.preprocess_mask(mask, size, size, 5)[0][0, ..., 0] == 0

    def unmasked_pixels_kept(image):
        diff = np.abs(image[0].astype(int) - reference.astype(int))[keep]
        log(f"phase 5d: {keep.sum()} pixels outside the mask, max |image - reference| "
            f"{diff.max()} there")
        return {"pixels outside the mask within 1 of the reference": int(diff.max()) <= 1}

    common = dict(num_steps=25, unconditional_guidance_scale=7.5, seed=1234)
    runs = [
        ("img2img", "phase 5c img2img", lambda **kw: pipe.image_to_image(
            PROMPT, reference_image=reference, reference_image_strength=0.8, **common, **kw),
         {"onepass": 200, "online": 2}, None),
        ("inpaint", "phase 5d inpaint", lambda **kw: pipe.inpaint(
            PROMPT, reference_image=reference, reference_image_strength=0.8, inpaint_mask=mask,
            mask_blur_strength=5, **common, **kw), {"onepass": 200, "online": 2},
         unmasked_pixels_kept),
        ("controlnet", "phase 5e ControlNet txt2img", lambda **kw: pipe.text_to_image(
            PROMPT, control_net_image=edges, **common, **kw), {"onepass": 350, "online": 1}, None),
    ]
    results = {}
    for path, label, generate, expect, check in runs:
        if path == "controlnet":  # made here, so that the earlier peaks do not hold it
            pipe._controlnet = cast_weights_(unet_lib.fuse_attention_projections(
                controlnet_lib.init(pipe.device, seed=3)), pipe.compute_dtype).eval()
        results[path] = (*run_phase(label, generate, size, WARM_IMAGES_NEW, expect, check),
                         generate)
        if not results[path][0]:
            return None
    return results


def with_settings(pipe, **kw):
    """A pipeline made with the constructor arguments ``kw`` (``scheduler_type``,
    ``active_tcd``, ``prediction_type``) that holds ``pipe``'s modules."""
    from minsdtf_tpu_torch import StableDiffusion

    new = StableDiffusion(pipe.img_height, pipe.img_width, bpe_path=pipe.bpe_path,
                          compute_dtype=pipe.compute_dtype, device=pipe.device, **kw)
    for name in ("_unet", "_text_model", "_decoder", "_encoder", "_controlnet", "_tokenizer"):
        setattr(new, name, getattr(pipe, name))
    return new


def write_safetensors(path: str, tensors) -> str:
    """``{key: fp32 numpy array or tensor}`` as a .safetensors file: an 8-byte
    header length, the JSON header padded with spaces to 8 bytes (so the fp32 data
    is aligned, as the ``safetensors`` package writes it), the raw little-endian
    data. Written one tensor at a time: a tensor on the card is copied to the host
    alone."""
    header, offset = {}, 0
    for key, a in tensors.items():
        nbytes = 4 * int(np.prod(tuple(a.shape)))
        header[key] = {"dtype": "F32", "shape": list(a.shape),
                       "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little") + head)
        for a in tensors.values():
            if isinstance(a, torch.Tensor):
                a = a.detach().float().cpu().numpy()
            f.write(memoryview(np.ascontiguousarray(a, "<f4")).cast("B"))
    return path


def embedding_files(directory: str, seed: int = 6):
    """A 2-vector textual-inversion embedding as ``.safetensors`` (``emb_params``)
    and a 3-vector negative embedding as an A1111 ``.pt``, from ``seed``, at the
    token embeddings' scale."""
    rng = np.random.default_rng(seed)
    ti = write_safetensors(os.path.join(directory, "ti.safetensors"),
                           {"emb_params": rng.normal(0, 0.02, (2, 768)).astype(np.float32)})
    neg = os.path.join(directory, "negative.pt")
    torch.save({"string_to_param": {"*": torch.from_numpy(
        rng.normal(0, 0.02, (3, 768)).astype(np.float32))}}, neg)
    return ti, neg


def phase_samplers(pipe, size: int, directory: str):
    """The other samplers on ``pipe``'s modules at CFG 7.5, bf16: DPM++ 2M Karras
    (5f, 15 steps), Euler-a (5g, 25), TCD at batch 8 (5h, 4 steps, the default
    eta of 0.3), LCM (5i, 4), and a 25-step txt2img with a TI embedding from a
    .safetensors file, a .pt negative embedding and a prompt of two LPW chunks
    (5j), whose 154 tokens against the negative's 77 take two UNet calls a step.
    Returns {path: run_phase results + (the generate call,)}, or None if a phase
    failed."""
    ti, neg = embedding_files(directory)
    long_prompt = " ".join([PROMPT] * 3)
    context = pipe.encode_text(long_prompt, embedding_data=ti)
    plain = pipe.encode_text(long_prompt)
    uncond = pipe.encode_text("", embedding_data=neg)
    ti_diff = float(np.abs(context - plain).max())
    log(f"phase 5j: context {context.shape}, negative {uncond.shape}, max |context with the "
        f"embedding - without| {ti_diff:.4e}")
    ti_checks = {"context (1, 154, 768)": context.shape == (1, 154, 768),
                 "negative context (1, 77, 768)": uncond.shape == (1, 77, 768),
                 "the embedding changes the context": ti_diff > 0}

    def images_differ(image):
        return {"the 8 images differ": all(
            (image[i] != image[0]).any() for i in range(1, image.shape[0]))}

    runs = [  # path, label, pipeline settings, prompt, call arguments, launches, check
        ("dpm_karras", "phase 5f DPM++ 2M Karras", dict(scheduler_type="dpm_karras"), PROMPT,
         dict(num_steps=15), {"onepass": 150, "online": 1}, None),
        ("euler_a", "phase 5g Euler-a", dict(scheduler_type="euler_a"), PROMPT,
         dict(num_steps=25), {"onepass": 250, "online": 1}, None),
        ("tcd_b8", "phase 5h TCD batch 8", dict(active_tcd=True), PROMPT,
         dict(num_steps=4, batch_size=8), {"onepass": 40, "online": 1}, images_differ),
        ("lcm", "phase 5i LCM", dict(scheduler_type="lcm"), PROMPT,
         dict(num_steps=4), {"onepass": 40, "online": 1}, None),
        ("ti", "phase 5j textual inversion, two calls", {}, long_prompt,
         dict(num_steps=25, embedding=ti, negative_embedding=neg),
         {"onepass": 500, "online": 1}, lambda image: ti_checks),
    ]
    results = {}
    for path, label, settings, prompt, kw, expect, check in runs:
        sd = with_settings(pipe, **settings)
        generate = (lambda sd=sd, prompt=prompt, kw=kw, **extra: sd.text_to_image(
            prompt, unconditional_guidance_scale=7.5, seed=1234, **kw, **extra))
        generate.pipe = sd
        results[path] = (*run_phase(label, generate, size, WARM_IMAGES_SAMPLERS, expect, check,
                                    batch=kw.get("batch_size", 1)), generate)
        if not results[path][0]:
            return None
    return results


@contextlib.contextmanager
def step_loop():
    """In the body, the pipelines run the sampler's step loop
    (``sampler._generate_eager``, the reference the card's captured program is held
    against) in place of the program."""
    from minsdtf_tpu_torch import sampler

    program = sampler.generate
    sampler.generate = lambda *args, programs=None, **kw: sampler._generate_eager(*args, **kw)
    try:
        yield
    finally:
        sampler.generate = program


def program_against_loop(label: str, generate, **kw) -> dict:
    """One warm call of ``generate(return_latent=True, **kw)`` through the captured
    program and one through the step loop: their uint8 images and latents must be
    equal bit for bit and their launch counts equal."""
    runs = []
    for loop in (False, True):
        zero_launches()
        with step_loop() if loop else contextlib.nullcontext():
            image, latent = generate(return_latent=True, **kw)
        torch.cuda.synchronize()
        runs.append((image, latent, read_launches()))
    (img_p, lat_p, n_p), (img_l, lat_l, n_l) = runs
    out = dict(image_equal=bool(np.array_equal(img_p, img_l)),
               latent_equal=bool(np.array_equal(lat_p, lat_l)),
               image_max_diff=pixel_diff(img_p, img_l)[0],
               latent_max_diff=float(np.abs(lat_p - lat_l).max()), launches=n_p,
               launches_loop=n_l)
    out["ok"] = out["image_equal"] and out["latent_equal"] and n_p == n_l
    log(f"{label} program against the step loop: image equal {out['image_equal']} (max |diff| "
        f"{out['image_max_diff']}), latent equal {out['latent_equal']} (max |diff| "
        f"{out['latent_max_diff']:.3e}), launches {n_p} and {n_l} {'ok' if out['ok'] else 'FAIL'}")
    return out


def program_stats(label: str, pipe) -> dict:
    """``pipe``'s program cache: programs held and captured, the pool's bytes, each
    program's capture seconds and replays."""
    stats = pipe._programs.stats()
    pool = stats["pool_bytes"]
    log(f"{label} programs: {stats['programs']} held, {stats['builds']} captured, pool "
        f"{'not measured' if pool is None else f'{pool / 1e6:.1f} MB'}; each (capture s, "
        f"replays): {[(round(p['capture_s'], 3), p['replays']) for p in stats['each']]}")
    return stats


def phase_program(pipe, new_paths: dict, samplers: dict):
    """5k: the captured step program against the sampler's step loop at full
    width, 512x512, bf16, on phase 5's modules, bit for bit: txt2img (phase 5's
    settings), ControlNet, inpaint (strength 0.8), TCD at batch 8 (step noise) and
    DPM++ 2M Karras (the x0 carry); then CFG 5.0 after 7.5, which must reuse the
    program (no capture) and equal the loop at 5.0; then each pipeline's programs,
    capture seconds, replays and pool bytes, and five warm images through the
    loop, timed. Returns the numbers, or None if a check failed."""
    runs = {"txt2img": txt2img(pipe), "controlnet": new_paths["controlnet"][-1],
            "inpaint": new_paths["inpaint"][-1], "tcd_b8": samplers["tcd_b8"][-1],
            "dpm_karras": samplers["dpm_karras"][-1]}
    out = {path: program_against_loop(f"phase 5k {path}", generate)
           for path, generate in runs.items()}
    builds = pipe._programs.builds
    out["cfg5"] = program_against_loop("phase 5k txt2img at CFG 5.0", lambda **kw: pipe.text_to_image(
        PROMPT, num_steps=25, unconditional_guidance_scale=5.0, seed=1234, **kw))
    out["cfg5"]["captures"] = pipe._programs.builds - builds
    out["cfg5"]["ok"] &= out["cfg5"]["captures"] == 0
    log(f"phase 5k CFG 5.0 after 7.5: {out['cfg5']['captures']} new captures (want 0)")
    out["programs"] = {"phase 5": program_stats("phase 5k phase 5's pipeline", pipe),
                       **{path: program_stats(f"phase 5k {path}'s pipeline", r[-1].pipe)
                          for path, r in samplers.items()}}
    ok = all(r["ok"] for r in out.values() if "ok" in r)
    with step_loop():
        loop_ok, _, out["loop_samples"], _ = run_phase(
            "phase 5k step loop txt2img", txt2img(pipe), 512, WARM_IMAGES,
            {"onepass": 250, "online": 1})
    return out if ok and loop_ok else None


# each K1 or K2 wrapper call runs one of these kernels (K2's path B also its merge, not
# counted); each GroupNorm call runs the three of its pattern, and counts three
DEVICE_KERNELS = {
    "onepass": re.compile(r"flash_bf16_kernel<\d+, 0>|flash_onepass_f32_kernel<"),  # EXP2_ROUNDED_SUM
    "online": re.compile(r"flash_bf16_kernel<\d+, 1>|flash_online_d512_kernel\("
                         r"|flash_online_f32_kernel<|flash_online_f32_wide_kernel<"),
    "group_norm": re.compile(r"group_norm_nhwc_(stats|finalize|apply)_kernel"),
}


def read_counters() -> dict:
    """Every launch counter: K1's, K2's, the GroupNorm kernels', the int8 products."""
    from minsdtf_tpu_torch.ops import basic

    return {**read_launches(), "int8": basic.int8_matmul.calls}


def read_layout() -> dict:
    """The models' layout counters: GroupNorms on the kernel and on the plain
    composition, and convolutions whose input or weight was not channels-last."""
    from minsdtf_tpu_torch.ops import basic

    return {"gn_kernel": basic.group_norm.kernel_calls, "gn_plain": basic.group_norm.plain_calls,
            "layout_misses": basic.conv2d.layout_misses}


def device_launches(by_name: dict, groups: dict) -> dict:
    """The counters' launches as the device ran them in a profile: K1's, K2's and
    the GroupNorm kernels' by kernel name (``DEVICE_KERNELS``), the int8 products as the kernels of the
    "int8 gemm" group, one each."""
    out = {key: sum(n for name, (_, n) in by_name.items() if pattern.search(name))
           for key, pattern in DEVICE_KERNELS.items()}
    out["int8"] = groups.get("int8 gemm", (0.0, 0))[1]
    return out


PROFILE_MARGIN_S = 0.05  # idle seconds a profile's window holds before and after the image
# counters that a profile logs beside the device's records but does not hold to them:
# one img2img image of phase 7d ran one GroupNorm call fewer in the records than its
# counters give, the same in two profiles, where a new pipeline's img2img matched in
# twelve (PERF.md §7)
UNGATED = ("group_norm",)


def phase_profile(generate, s_per_img: float, label: str, filename: str,
                  details: dict = None):
    """One more warm image, ``generate()``, under torch.profiler: device time by
    kernel name and by group (``profiling.op_report``), and the device's busy share
    of the unprofiled wall time ``s_per_img``. Only CUDA activity is recorded: the
    host's events cost most of the profiler's processing time and no number here
    reads them. The launch counters' change over the image must equal the kernels
    the device ran (:func:`device_launches`): a replayed program adds its capture's
    counts, so this holds them to the graph's kernels; a difference raises, but for
    the counters in ``UNGATED``, which are logged. The profiler lost a few records
    of an image's ~36,000 kernels now and then, of whatever kinds ran near the edges
    of its window (PERF.md §6): the window opens ``PROFILE_MARGIN_S`` before
    the image and closes as long after it. Returns the busy share, or None where the
    profiler recorded no device time; ``details``, if given, gets ``busy_ms``,
    ``groups``, ``by_name`` ({key: (ms, launches)}) and ``launches``."""
    from torch.profiler import ProfilerActivity, profile

    from minsdtf_tpu_torch import profiling

    before = read_counters()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        t0 = time.perf_counter()
        generate()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(PROFILE_MARGIN_S)
    counted = {k: v - before[k] for k, v in read_counters().items()}
    by_name = profiling.op_report(prof, top=None)
    busy_ms = sum(t for t, _ in by_name.values())
    if busy_ms == 0:
        log(f"{label} profile: the profiler recorded no device time (not measured)")
        return None
    groups = profiling.op_report(prof, by="group", top=None)
    on_device = device_launches(by_name, groups)
    held = all(counted[k] == on_device[k] for k in counted if k not in UNGATED)
    log(f"{label} profile: launches counted {counted}, run on the device {on_device} "
        f"{'ok' if held else 'FAIL'}" + "".join(
            f"; {k} {'equal' if counted[k] == on_device[k] else 'NOT EQUAL'} (not held)"
            for k in UNGATED))
    with open(os.path.join(OUT_DIR, filename), "w") as f:  # kept for a failed check too
        f.write(f"device busy {busy_ms:.3f} ms, profiled wall {wall_ms:.3f} ms\n")
        for name, (t, n) in by_name.items():
            f.write(f"{t:10.3f} ms {n:6d}  {name}\n")
    if not held:
        raise RuntimeError(f"{label}: the launch counters {counted} differ from the kernels "
                           f"the device ran {on_device}")
    if details is not None:
        details.update(busy_ms=busy_ms, groups=groups, by_name=by_name, launches=on_device)
    share = busy_ms / (s_per_img * 1e3)
    log(f"{label} profile: device busy {busy_ms:.3f} ms in a profiled wall of {wall_ms:.3f} ms; "
        f"busy share of the unprofiled {s_per_img * 1e3:.3f} ms: {share:.4f}")
    for group, (t, n) in groups.items():
        log(f"  group {group}: {t:.3f} ms, {n} launches, {t / busy_ms:.4f} of device time")
    for name, (t, n) in list(by_name.items())[:15]:
        log(f"  {t:9.3f} ms {n:5d}  {name[:110]}")
    return share


# ---- phases 8a-8c: checkpoint and LoRA files ------------------------------------


def rss_gb() -> float:
    """This process's resident set (``VmRSS``), GB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024 / 1e9
    raise RuntimeError("no VmRSS in /proc/self/status")


class PeakRss:
    """The largest :func:`rss_gb` seen while the block runs, sampled every 5 ms by a
    thread: the process's own peak (``VmHWM``) may come from an earlier phase."""

    def __enter__(self):
        self.before = self.peak = rss_gb()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(0.005):
            self.peak = max(self.peak, rss_gb())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, rss_gb())


def ldm_state(state, kind: str):
    """The port's ``state_dict`` of ``kind`` under the public single-file names,
    by inverting the port's maps: ``model.diffusion_model.*`` (UNet),
    ``cond_stage_model.transformer.text_model.*`` (CLIP), ``first_stage_model.*``
    with the attention as (c, c, 1, 1) convs (VAE), ``control_model.*``
    (lllyasviel's ControlNet)."""
    from minsdtf_tpu_torch.weights import mapping

    maps = {"unet": (mapping.unet_ldm_to_diffusers(), ""),
            "controlnet": (mapping.controlnet_ldm_to_diffusers(), ""),
            "vae": (mapping.vae_ldm_to_diffusers(), mapping.VAE_LDM_PREFIX),
            "text_encoder": ({}, mapping.TEXT_ENCODER_LDM_PREFIX)}
    module_map, prefix = maps[kind]
    inverse = {v: k for k, v in module_map.items()}
    out = {}
    for key, value in state.items():
        module, _, leaf = key.rpartition(".")
        if kind == "vae" and value.dim() == 2:
            value = value[:, :, None, None]
        out[f"{prefix}{inverse.get(module, module)}.{leaf}"] = value
    return out


def seeded_fp32_modules(device):
    """The random pipeline's modules before fusion and the cast: fp32 on
    ``device``, from the same seeds."""
    from minsdtf_tpu_torch.models import clip as clip_lib
    from minsdtf_tpu_torch.models import unet as unet_lib
    from minsdtf_tpu_torch.models import vae as vae_lib

    return {"unet": unet_lib.init(device, seed=0), "text_encoder": clip_lib.init(device, seed=1),
            "decoder": vae_lib.init_decoder(device, seed=2),
            "encoder": vae_lib.init_encoder(device, seed=4)}


def checkpoint_pipeline(bpe: str, size: int, device, **kw):
    from minsdtf_tpu_torch import StableDiffusion

    return StableDiffusion(size, size, bpe_path=bpe, device=device, **kw)


def same_modules(got, want, names) -> dict:
    """``{name: every tensor of got.name equal to want.name's, bit for bit}``."""
    out = {}
    for name in names:
        a, b = getattr(got, name).state_dict(), getattr(want, name).state_dict()
        out[name] = a.keys() == b.keys() and all(
            a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)
    return out


MODULES = ("unet", "text_model", "decoder", "encoder")


def phase_checkpoint(pipe, bpe: str, directory: str):
    """8a: the seeded fp32 UNet, CLIP, decoder and encoder as one fp32 LDM
    single-file checkpoint; the cold conversion (caches deleted first), the load
    from the caches to the first image, every loaded tensor bit for bit against
    ``pipe``'s, and the 512px image against ``pipe``'s. Returns (passed,
    launches, the checkpoint's path, (the cached pipeline's first image,
    ``pipe``'s image), numbers): a pipeline's first image differs from its later
    ones where the first context does (see the log)."""
    from minsdtf_tpu_torch.weights import convert

    size, device = pipe.img_height, pipe.device
    usage = shutil.disk_usage(directory)
    log(f"phase 8a: {usage.free / 1e9:.3f} GB free of {usage.total / 1e9:.3f} GB on the disk "
        f"of {directory}; the group writes about 5.8 GB of checkpoints and 5.7 GB of caches")
    modules = seeded_fp32_modules(device)
    state = {**ldm_state(modules["unet"].state_dict(), "unet"),
             **ldm_state(modules["text_encoder"].state_dict(), "text_encoder"),
             **ldm_state({**modules["encoder"].state_dict(), **modules["decoder"].state_dict()},
                         "vae")}
    path = os.path.join(directory, "sd15-ldm-fp32.safetensors")
    t0 = time.perf_counter()
    write_safetensors(path, state)
    log(f"phase 8a: wrote {len(state)} tensors, {os.path.getsize(path) / 1e9:.3f} GB, in "
        f"{time.perf_counter() - t0:.3f} s")
    del state, modules
    torch.cuda.empty_cache()

    files = dict(unet_ckpt=path, text_encoder_ckpt=path, vae_ckpt=path)
    for kind in ("unet", "text_encoder", "vae"):
        if os.path.exists(convert.cache_path(path, kind)):
            os.remove(convert.cache_path(path, kind))
    torch.cuda.reset_peak_memory_stats()
    with PeakRss() as rss:
        t0 = time.perf_counter()
        cold = checkpoint_pipeline(bpe, size, device, **files)
        for name in MODULES:
            getattr(cold, name)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
    cold_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # a pipeline's first prompt is encoded with the unconditional row in the same
    # batch (B = 2), later ones alone (B = 1): the same rows, other GEMM shapes
    first_ctx, later_ctx = cold.encode_text(PROMPT), cold.encode_text(PROMPT)
    log(f"phase 8a: a pipeline's first context (encoded beside the unconditional row) equals "
        f"its second bit for bit: {bool(np.array_equal(first_ctx, later_ctx))}, max |diff| "
        f"{float(np.abs(first_ctx - later_ctx).max()):.3e}")
    log(f"phase 8a cold conversion: {cold_s:.3f} s for the UNet, CLIP, decoder and encoder "
        f"(caches written: {sum(os.path.exists(convert.cache_path(path, k)) for k in ('unet', 'text_encoder', 'vae'))} of 3); "
        f"host RSS {rss.before:.3f} GB before, peak {rss.peak:.3f} GB while loading; peak "
        f"device memory {cold_peak_gb:.3f} GB")
    del cold
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    loaded = checkpoint_pipeline(bpe, size, device, **files)
    first_image = txt2img(loaded)()
    torch.cuda.synchronize()
    first_image_s = time.perf_counter() - t0
    for name in MODULES:  # the encoder is loaded for the comparison, after the timing
        getattr(loaded, name)
    log(f"phase 8a from the caches: {first_image_s:.3f} s from the constructor to the first "
        f"{size}px image")

    want, again = txt2img(pipe)(), txt2img(pipe)()
    deterministic = bool(np.array_equal(want, again))
    log(f"phase 8a: two calls of the random pipeline give equal images: {deterministic}")
    equal = same_modules(loaded, pipe, MODULES)
    log(f"phase 8a: loaded tensors equal the random pipeline's bit for bit: {equal}")
    ok, launches, *_ = run_phase(
        "phase 8a checkpoint txt2img", txt2img(loaded), size, 1, {"onepass": 250, "online": 1},
        lambda image: {"two calls of the random pipeline equal": deterministic,
                       **{f"{name} bit-equal": v for name, v in equal.items()},
                       "image equals the random pipeline's": bool(np.array_equal(image, want))})
    numbers = {"cold_conversion_s": cold_s, "cached_first_image_s": first_image_s,
               "load_peak_rss_gb": rss.peak, "rss_before_load_gb": rss.before,
               "load_peak_device_gb": cold_peak_gb, "checkpoint_gb": os.path.getsize(path) / 1e9}
    return ok, launches, path, (first_image, want), numbers


def phase_controlnet_pth(pipe, bpe: str, directory: str, controlnet_generate):
    """8b: the seed-3 ControlNet as a fp32 ``.pth`` in lllyasviel's
    ``control_model.*`` layout with a few ``model.diffusion_model.*`` keys beside
    it, loaded through ``controlnet_path`` by a pipeline holding ``pipe``'s other
    modules; its weights and its ControlNet txt2img image against phase 5e's
    (``pipe`` with the ControlNet assigned). Returns (passed, launches, numbers)."""
    from minsdtf_tpu_torch.models import controlnet as controlnet_lib
    from minsdtf_tpu_torch.weights import convert

    size, device = pipe.img_height, pipe.device
    gen = torch.Generator().manual_seed(3)
    state = {k: v.cpu() for k, v in ldm_state(
        controlnet_lib.init(device, seed=3).state_dict(), "controlnet").items()}
    for name, shape in (("time_embed.0.weight", (1280, 320)), ("time_embed.0.bias", (1280,)),
                        ("input_blocks.0.0.weight", (320, 4, 3, 3)), ("out.2.bias", (4,))):
        state[f"model.diffusion_model.{name}"] = torch.randn(shape, generator=gen)
    path = os.path.join(directory, "control_sd15_seed3.pth")
    torch.save(state, path)
    del state
    log(f"phase 8b: wrote {path}, {os.path.getsize(path) / 1e9:.3f} GB")

    cpipe = checkpoint_pipeline(bpe, size, device, controlnet_path=path)
    for name in ("_unet", "_text_model", "_decoder", "_encoder", "_tokenizer"):
        setattr(cpipe, name, getattr(pipe, name))
    t0 = time.perf_counter()
    cpipe.controlnet
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    equal = same_modules(cpipe, pipe, ("controlnet",))["controlnet"]
    log(f"phase 8b: ControlNet converted and loaded in {load_s:.3f} s; its tensors equal the "
        f"assigned one's bit for bit: {equal}")
    want = controlnet_generate()
    _, _, edges = synthetic_inputs(size)
    ok, launches, *_ = run_phase(
        "phase 8b ControlNet .pth txt2img", lambda **kw: cpipe.text_to_image(
            PROMPT, control_net_image=edges, num_steps=25, unconditional_guidance_scale=7.5,
            seed=1234, **kw), size, 1, {"onepass": 350, "online": 1},
        lambda image: {"ControlNet bit-equal": equal,
                       "image equals phase 5e's": bool(np.array_equal(image, want))})
    os.remove(path)
    os.remove(convert.cache_path(path, "controlnet"))
    return ok, launches, {"controlnet_load_s": load_s}


LORA_RANK, LORA_ALPHA = 8, 4.0
# the module names that the kohya rewrite tables produce
LORA_UNET_TAILS = ("to_q", "to_k", "to_v", "to_out.0", "proj_in", "proj_out", "ff.net.0.proj",
                   "ff.net.2", "time_emb_proj", "conv1", "conv2", "conv_shortcut",
                   "downsamplers.0.conv", "upsamplers.0.conv")
LORA_TEXT_TAILS = ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")


def lora_factors(modules, device, seed: int = 9):
    """Kohya factors (rank 8, alpha 4) for every conv and dense module of the fp32
    ``modules`` that the rewrite tables reach, and the fp32 deltas the script
    builds from them on the card: ``{diffusers weight key: delta}`` per model,
    and the kohya ``state_dict``. The factors are multiples of 1/256 up to 1/32,
    so every product and sum in a delta is exact in fp32 whatever the order:
    the merged weights can be compared exactly."""
    gen = torch.Generator(device=device).manual_seed(seed)
    kohya, deltas = {}, {}
    for kind, prefix, tails in (("unet", "lora_unet_", LORA_UNET_TAILS),
                                ("text_encoder", "lora_te_", LORA_TEXT_TAILS)):
        deltas[kind] = {}
        for name, m in modules[kind].named_modules():
            if not isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)) or not name.endswith(tails):
                continue
            w = m.weight
            kernel = tuple(w.shape[2:])
            down = torch.randint(-8, 9, (LORA_RANK, w.shape[1], *kernel), generator=gen,
                                 device=device).float() / 256
            up = torch.randint(-8, 9, (w.shape[0], LORA_RANK, *((1, 1) if kernel else ())),
                               generator=gen, device=device).float() / 256
            if kernel:
                delta = torch.einsum("or,rihw->oihw", up[:, :, 0, 0], down)
            else:
                delta = up @ down
            deltas[kind][f"{name}.weight"] = delta * (LORA_ALPHA / LORA_RANK)
            key = prefix + name.replace(".", "_")
            kohya[f"{key}.lora_down.weight"] = down
            kohya[f"{key}.lora_up.weight"] = up
            kohya[f"{key}.alpha"] = torch.tensor([LORA_ALPHA])
    return kohya, deltas


def merged_weights_equal(model, base, deltas, scale: float, dtype) -> list:
    """The keys of ``model`` (fused, cast) that differ from ``base`` (fp32, unfused)
    with ``scale * deltas`` added in fp32 and its conv / dense / embedding weights
    cast to ``dtype``; a fused ``to_qkv`` / ``to_kv`` is compared third by third
    (half by half). Returns the keys that differ."""
    kernels = {f"{n}.weight" for n, m in base.named_modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear, torch.nn.Embedding))}
    want = dict(base.state_dict())
    for key, delta in deltas.items():
        want[key] = want[key] + scale * delta.reshape(want[key].shape)
    bad = []
    for key, value in model.state_dict().items():
        stem, _, proj = key.rpartition(".")[0].rpartition(".")
        parts = {"to_qkv": ("to_q", "to_k", "to_v"), "to_kv": ("to_k", "to_v")}.get(proj)
        names = [f"{stem}.{p}.weight" for p in parts] if parts else [key]
        for name, chunk in zip(names, value.chunk(len(names))):
            expect = want[name].to(dtype) if name in kernels else want[name]
            if chunk.dtype != expect.dtype or not torch.equal(chunk, expect):
                bad.append(name)
    return bad


def phase_lora(pipe, bpe: str, directory: str, path: str, want_images):
    """8c: a kohya LoRA over every module the rewrite tables reach, loaded with
    8a's checkpoint through ``lora_path``; every merged weight against the
    script's own fp32 merge, the image against 8a's, then ``set_lora(path, 0.5)``
    and ``set_lora(None)``, whose first and second images must equal 8a's
    (``want_images``: a fresh pipeline's first image and a later one). Returns
    (passed, launches, numbers)."""
    want_first, want_base = want_images
    size, device = pipe.img_height, pipe.device
    base = seeded_fp32_modules(device)
    kohya, deltas = lora_factors(base, device)
    lora_path = write_safetensors(os.path.join(directory, "lora-r8.safetensors"), kohya)
    log(f"phase 8c: wrote a rank-{LORA_RANK} LoRA over {len(deltas['unet'])} UNet and "
        f"{len(deltas['text_encoder'])} CLIP modules, {os.path.getsize(lora_path) / 1e6:.3f} MB")
    files = dict(unet_ckpt=path, text_encoder_ckpt=path, vae_ckpt=path)

    def check_weights(lpipe, scale):
        """``scale`` None: the base weights, no delta."""
        bad = {kind: merged_weights_equal(model, base[kind], deltas[kind] if scale else {},
                                          scale, lpipe.compute_dtype)
               for kind, model in (("unet", lpipe.unet), ("text_encoder", lpipe.text_model))}
        log(f"phase 8c: at scale {scale}, weights that differ from the script's merge: "
            f"{ {k: (len(v), v[:4]) for k, v in bad.items()} }")
        return not any(bad.values())

    t0 = time.perf_counter()
    lpipe = checkpoint_pipeline(bpe, size, device, lora_path=lora_path, **files)
    first = txt2img(lpipe)()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    log(f"phase 8c: {first_s:.3f} s from the constructor with lora_path to the first image")
    merged_ok = check_weights(lpipe, 1.0)
    ok, launches, *_ = run_phase(
        "phase 8c LoRA txt2img", txt2img(lpipe), size, 1, {"onepass": 250, "online": 1},
        lambda image: {"merged weights equal the script's": merged_ok,
                       "image differs from 8a's": bool((image != want_base).any())})
    numbers = {"lora_first_image_s": first_s}
    checks = {}
    for scale in (0.5, None):
        builds = lpipe._programs.builds
        t0 = time.perf_counter()
        lpipe.set_lora(None if scale is None else lora_path, **({} if scale is None
                                                               else {"scale": scale}))
        set_s = time.perf_counter() - t0
        held = len(lpipe._programs.programs)
        t0 = time.perf_counter()
        image = txt2img(lpipe)()
        torch.cuda.synchronize()
        image_s = time.perf_counter() - t0
        label = "none" if scale is None else str(scale)
        numbers[f"set_lora_{label}_s"], numbers[f"set_lora_{label}_first_image_s"] = set_s, image_s
        checks[f"set_lora({label}) drops the programs; the next image captures anew"] = (
            held == 0 and lpipe._programs.builds == builds + 1)
        log(f"phase 8c set_lora({'None' if scale is None else f'path, {scale}'}): {set_s:.3f} s, "
            f"then {image_s:.3f} s to the first image")
        if scale is None:
            checks["set_lora(None): the first image equals 8a's first"] = bool(
                np.array_equal(image, want_first))
            checks["set_lora(None): the second image equals 8a's"] = bool(
                np.array_equal(txt2img(lpipe)(), want_base))
            checks["set_lora(None) weights equal the base"] = check_weights(lpipe, None)
        else:
            checks["set_lora(0.5) weights equal base + 0.5 delta"] = check_weights(lpipe, scale)
            checks["set_lora(0.5) image differs from scale 1's"] = bool((image != first).any())
    log(f"phase 8c checks: {checks}")
    return ok and all(checks.values()), launches, numbers


def phase_checkpoints(pipe, bpe: str, directory: str, controlnet_generate):
    """Phases 8a-8c in ``directory``, which the caller removes. Returns ({path:
    launches}, numbers, the 8a checkpoint's path), or None if a phase failed."""
    ok, launches_ckpt, path, want_images, numbers = phase_checkpoint(pipe, bpe, directory)
    if not ok:
        return None
    ok, launches_pth, more = phase_controlnet_pth(pipe, bpe, directory, controlnet_generate)
    numbers.update(more)
    if not ok:
        return None
    ok, launches_lora, more = phase_lora(pipe, bpe, directory, path, want_images)
    numbers.update(more)
    if not ok:
        return None
    return ({"ckpt": launches_ckpt, "controlnet_pth": launches_pth, "lora": launches_lora},
            numbers, path)


# ---- phase group 9: the serving path -----------------------------------------------

SERVE_SETTINGS = dict(num_steps=25, unconditional_guidance_scale=7.5, guidance_rescale=0.7)


def pixel_diff(got: np.ndarray, want: np.ndarray) -> tuple:
    """(max |got - want| over the uint8 values, share of pixels where any channel
    differs)."""
    diff = np.abs(got.astype(int) - want.astype(int))
    return int(diff.max()), float((diff.max(axis=-1) > 0).mean())


def phase_generate_images(pipe) -> dict:
    """9a: four pre-encoded prompts with seeds as one ``generate_images`` call, each
    image against the same seed's ``generate_image`` at batch 1 (exactly), the
    queued call's wall against four sequential calls', and the launches of the
    queued call (K1 1000, K2 4)."""
    prompts = [f"{PROMPT} number {w}" for w in ("one", "two", "three", "four")]
    seeds = [21, 22, 23, 24]
    contexts = [pipe._encode_text_dev(p) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    singles = [pipe.generate_image(c, seed=s, **SERVE_SETTINGS) for c, s in zip(contexts, seeds)]
    sequential_s = time.perf_counter() - t0
    zero_launches()
    t0 = time.perf_counter()
    queued = pipe.generate_images(contexts, seeds=seeds, **SERVE_SETTINGS)
    queued_s = time.perf_counter() - t0
    launches = read_launches()
    size = pipe.img_height
    log(f"phase 9a generate_images: 4 images in {queued_s:.4f} s queued "
        f"({queued_s / 4:.4f} s/img) against {sequential_s:.4f} s as four generate_image "
        f"calls ({sequential_s / 4:.4f} s/img); launches of the queued call {launches}")
    checks = {
        f"four (1, {size}, {size}, 3) uint8 images": len(queued) == 4 and all(
            q.shape == (1, size, size, 3) and q.dtype == np.uint8 for q in queued),
        "each equals its seed's generate_image at batch 1": all(
            np.array_equal(q, s) for q, s in zip(queued, singles)),
        "images differ between seeds": not np.array_equal(queued[0], queued[1]),
        "K1 launches == 1000": launches["onepass"] == 1000,
        "K2 launches == 4": launches["online"] == 4,
    }
    log(f"phase 9a checks: {checks}")
    return {"ok": all(checks.values()), "launches": launches, "queued_s": queued_s,
            "sequential_s": sequential_s}


class RecordingPipe:
    """``pipe`` with each ``generate_image`` call's arguments and result kept in
    ``calls``; every other attribute is ``pipe``'s."""

    def __init__(self, pipe):
        self._pipe = pipe
        self.calls = []

    def __getattr__(self, name):
        return getattr(self._pipe, name)

    def generate_image(self, *args, **kwargs):
        out = self._pipe.generate_image(*args, **kwargs)
        self.calls.append((args, kwargs, out))
        return out


def post_burst(port: int, payloads) -> list:
    """Every payload posted to ``/generate`` at once, one client thread each;
    returns the ``(status, reply)`` of each, in order (None where none came)."""
    import urllib.request

    replies = [None] * len(payloads)

    def client(i):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate", data=json.dumps(payloads[i]).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=600) as r:
            replies[i] = (r.status, json.loads(r.read()))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    return replies


def get_json(port: int, path: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return json.loads(r.read())


def phase_serve(pipe) -> dict:
    """9b: ``tools.serve.serve(pipe, port=0)`` and 8 concurrent ``/generate``
    requests (six with the same settings, one with 15 steps, one at guidance 5),
    then ``/healthz`` and ``/stats``; every reply an (H, W, 3) uint8 image; the
    merged noise rows equal each seed's batch-1 noise exactly; each merged call
    replayed gives its images exactly; a request served alone equals its batch-1
    image exactly, and a merged one is measured against it (max |diff|, share of
    pixels that differ). The same burst is then timed warm and run once more under
    torch.profiler."""
    from minsdtf_tpu_torch import rng as rng_lib
    from minsdtf_tpu_torch.pipeline import fetch
    from minsdtf_tpu_torch.tools import serve as serve_mod

    payloads = [{"prompt": f"{PROMPT} request {i}", "seed": 100 + i} for i in range(8)]
    payloads[6]["steps"] = 15
    payloads[7]["guidance_scale"] = 5.0
    recorder = RecordingPipe(pipe)
    server, worker = serve_mod.serve(recorder, port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        replies = post_burst(port, payloads)
        cold_s = time.perf_counter() - t0
        launches = read_launches()
        healthz, stats = get_json(port, "/healthz"), get_json(port, "/stats")
        calls = list(recorder.calls)
        # the first burst is the first use of the batch sizes 2 and 4: time a second
        t0 = time.perf_counter()
        post_burst(port, payloads)
        burst_s = time.perf_counter() - t0
        busy_share = phase_profile(lambda: post_burst(port, payloads), burst_s,
                                   "phase 9b serve burst", "profile_serve.txt")
    finally:
        server.shutdown()
        server.server_close()
        worker.stop()
        thread.join(timeout=30)
    sizes = [kw.get("batch_size", 1) for _, kw, _ in calls]
    steps = [kw["num_steps"] for _, kw, _ in calls]
    log(f"phase 9b serve: 8 requests in {cold_s:.4f} s the first time ({cold_s / 8:.4f} s/img), "
        f"{burst_s:.4f} s the second ({burst_s / 8:.4f} s/img); the first burst's calls "
        f"dispatched at batch sizes {sizes} (steps {steps}), /healthz {healthz}, /stats "
        f"{stats}, launches {launches}")
    images = [serve_mod.decode_image(r[1]) if r and r[0] == 200 else None for r in replies]
    size = pipe.img_height

    # which seeds each call served: its own seed, or the rows of its noise
    h8 = pipe.img_height // 8
    noise_of = {p["seed"]: rng_lib.stateless_normal((1, h8, h8, 4), p["seed"]) for p in payloads}
    seeds_of, rows_ok = [], True
    for _, kw, _ in calls:
        if kw.get("seed") is not None:
            seeds_of.append([kw["seed"]])
            continue
        found = []
        for row in np.asarray(kw["diffusion_noise"]):
            match = [s for s, n in noise_of.items() if np.array_equal(row, n[0])]
            rows_ok &= len(match) == 1
            found += match
        seeds_of.append(found)
    served = sorted(s for found in seeds_of for s in found)
    replay_equal = True
    for (args, kw, handle), found in zip(calls, seeds_of):
        if len(found) > 1:
            again = pipe.generate_image(*args, **{k: v for k, v in kw.items()
                                                  if k != "_defer_fetch"})
            replay_equal &= bool(np.array_equal(again, fetch(handle)))
    alone_equal, merged_diffs = True, []
    for p, image in zip(payloads, images):
        if image is None:
            continue
        want = pipe.generate_image(
            pipe._encode_text_dev(p["prompt"]), seed=p["seed"],
            num_steps=p.get("steps", 25),
            unconditional_guidance_scale=p.get("guidance_scale", 7.5), guidance_rescale=0.7)[0]
        found = next(f for f in seeds_of if p["seed"] in f)
        if len(found) == 1:
            alone_equal &= bool(np.array_equal(image, want))
        else:
            merged_diffs.append((p["seed"], len(found), *pixel_diff(image, want)))
    for seed, batch, max_diff, share in merged_diffs:
        log(f"phase 9b: request seed {seed}, merged at batch {batch}, against its batch-1 image: "
            f"max |diff| {max_diff}, share of pixels that differ {share:.6f}")
    expect = {"onepass": sum(10 * n for n in steps), "online": len(calls)}
    checks = {
        "8 replies, 200": all(r is not None and r[0] == 200 for r in replies),
        f"each reply a ({size}, {size}, 3) uint8 image": all(
            i is not None and i.shape == (size, size, 3) and i.dtype == np.uint8 for i in images),
        "merged_batches >= 1": stats["merged_batches"] >= 1 and any(n > 1 for n in sizes),
        "/healthz ok": healthz.get("ok") is True,
        "/stats served 8": stats["served"] == 8,
        "each request served once": served == sorted(noise_of),
        "merged noise rows equal each seed's batch-1 noise": rows_ok,
        "merged calls replayed give their images exactly": replay_equal,
        "requests served alone equal their batch-1 images": alone_equal,
        f"K1 launches == {expect['onepass']} (10 a step a call)":
            launches["onepass"] == expect["onepass"],
        f"K2 launches == {expect['online']} (1 a call)": launches["online"] == expect["online"],
    }
    log(f"phase 9b checks: {checks}")
    return {"ok": all(checks.values()), "launches": launches, "cold_burst_s": cold_s,
            "burst_s": burst_s, "s_per_img": burst_s / 8, "batch_sizes": sizes,
            "busy_share": busy_share,
            "merged_vs_batch1": [dict(zip(("seed", "batch", "max_abs_diff", "share_differ"), d))
                                 for d in merged_diffs]}


def clip_lora(directory: str, seed: int = 10) -> str:
    """A rank-4 kohya LoRA on one CLIP projection, from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    key = "lora_te_text_model_encoder_layers_0_self_attn_q_proj"
    return write_safetensors(os.path.join(directory, "lora-clip.safetensors"), {
        f"{key}.lora_down.weight": torch.randn(4, 768, generator=gen) * 0.05,
        f"{key}.lora_up.weight": torch.randn(768, 4, generator=gen) * 0.05,
        f"{key}.alpha": torch.tensor([4.0])})


def phase_caches(pipe, bpe: str, directory: str, ckpt_path: str) -> dict:
    """9c: after ``warm_text`` the prompt cache is empty and the unconditional
    context set; a fresh prompt's repeat is a cache hit (no device operation under
    torch.profiler); ``set_lora`` empties the cache of a pipeline loaded from 8a's
    checkpoint, and the context after it differs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pipe.warm_text()
    checks = {"warm_text leaves the cache empty": len(pipe._prompt_cache) == 0,
              "warm_text sets the unconditional context": pipe._uncond is not None}
    fresh = f"{PROMPT} for the cache"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = pipe._encode_text_dev(fresh)
    torch.cuda.synchronize()
    fresh_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        again = pipe._encode_text_dev(fresh)
        torch.cuda.synchronize()
        hit_ms = (time.perf_counter() - t0) * 1e3
    device_ops = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    checks["a repeat is a cache hit: no device operation"] = again is first and not device_ops
    lpipe = checkpoint_pipeline(bpe, pipe.img_height, pipe.device, text_encoder_ckpt=ckpt_path)
    base = lpipe._encode_text_dev(fresh).clone()
    checks["the loaded pipeline caches its context"] = len(lpipe._prompt_cache) == 1
    lpipe.set_lora(clip_lora(directory))
    checks["set_lora empties the prompt cache"] = len(lpipe._prompt_cache) == 0
    checks["the context after set_lora differs"] = not torch.equal(
        lpipe._encode_text_dev(fresh), base)
    log(f"phase 9c caches: a fresh encode {fresh_ms:.3f} ms, its repeat {hit_ms:.3f} ms with "
        f"{len(device_ops)} device operations; checks: {checks}")
    return {"ok": all(checks.values()), "fresh_encode_ms": fresh_ms, "cache_hit_ms": hit_ms}


def phase_tools(bpe: str, directory: str, ckpt_path: str) -> dict:
    """9d: ``tools.golden`` twice on 8a's checkpoint (the first run creates the
    fixtures, the second compares them: rc 0 both) and ``tools.selfcheck``."""
    from minsdtf_tpu_torch.tools import golden, selfcheck

    fixtures = os.path.join(directory, "golden")
    t0 = time.perf_counter()
    rc_create = golden.run(ckpt_path, ckpt_path, ckpt_path, bpe, fixtures, device="cuda")
    rc_compare = golden.run(ckpt_path, ckpt_path, ckpt_path, bpe, fixtures, device="cuda")
    golden_s = time.perf_counter() - t0
    results = selfcheck.check_flash_attention()
    checks = {"golden creates the fixtures (rc 0)": rc_create == 0 and os.path.exists(
                  os.path.join(fixtures, f"golden_{golden.SEED}_latent.npy")),
              "golden matches them (rc 0)": rc_compare == 0,
              "selfcheck ran K1 and K2 at two shapes each": len(results) == 4}
    log(f"phase 9d tools: golden twice in {golden_s:.3f} s, selfcheck {results}; checks: {checks}")
    return {"ok": all(checks.values())}


TRAIN_BATCH = 4  # 10a: the 512x512 fine-tuning shape, 64x64 latents
TRAIN_TIMED_STEPS = 5  # after the first step, on the same batch
TRAIN_SMALL = dict(widths=(32, 64, 128, 128), temb_dim=128)
TRAIN_SMALL_LR = 1e-3  # 10b: large enough that two steps move the loss clearly
# 10b, fp32 card against fp32 CPU (TF32 off). The losses agree to ~1e-7
# relative. A gradient sums 1e3..1e5 products in another order on each device:
# within 1e-3 elementwise above 1e-4 of the tensor's largest element, and above a
# floor of 1e-6 of the model's largest gradient (some gradients are zero in exact
# arithmetic, a bias before a GroupNorm of one channel per group at width 32, and
# hold fp32 noise of ~1e-8).
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL, TRAIN_GRAD_ATOL_REL, TRAIN_GRAD_ATOL_MODEL = 1e-3, 1e-4, 1e-6
# Each device's AdamW, fed its own gradients of both steps, against optax.adamw's
# update in float64 numpy from the same initial weights: fp32 rounding of the
# weights (|p| < 1) and of the update (at most a few lr), a few ulps. Torch's
# default weight decay, 1e-2 where optax's is 1e-4, moves a weight by ~2e-5·|p|
# more over two steps; 10b runs it on the card as a control and fails unless this
# check rejects it.
TRAIN_OPT_RTOL, TRAIN_OPT_ATOL = 1e-6, 1e-8
# The weights after two steps, card against CPU: Adam's first step
# m̂/(√v̂+ε) = g/(|g|+ε) turns a gradient within rounding of zero into ±1 either
# way, so a few weights end up ~lr apart. At most TRAIN_PARAM_SHARE of them may
# be more than lr/100 apart: the card read 4.45e-4 to 4.69e-4 of them, and the
# JAX package on the CPU 4.4e-4.
TRAIN_PARAM_SHARE = 1e-3


def grads_finite_and_nonzero(model) -> list:
    """The names of the parameters whose ``.grad`` is missing, not finite, or all
    zero."""
    named = [(n, p.grad) for n, p in model.named_parameters()]
    missing = [n for n, g in named if g is None]
    present = [(n, g) for n, g in named if g is not None]
    ok = torch.stack([torch.isfinite(g).all() & (g != 0).any() for _, g in present]).tolist()
    return missing + [n for (n, _), good in zip(present, ok) if not good]


def refuses_gradient(block, x, context) -> tuple:
    """One forward and backward of ``block`` on the default route with grad
    enabled: (the wrappers' RuntimeError message or None, the launches it made)."""
    zero_launches()
    message = None
    try:
        block(x, context).sum().backward()
    except RuntimeError as e:
        message = str(e)
    return message, read_launches()


def train_step_flops(batch: int, latent_hw: int) -> float:
    """The floating-point operations of one forward and backward of the full-width
    fused UNet on the plain attention path, counted by
    ``torch.utils.flop_counter`` on meta tensors (matmuls, convolutions and their
    gradients; the elementwise work and AdamW are not counted)."""
    from torch.utils.flop_counter import FlopCounterMode

    from minsdtf_tpu_torch.models import unet as unet_lib
    from minsdtf_tpu_torch.ops import attention

    with torch.device("meta"):
        unet = unet_lib.fuse_attention_projections(unet_lib.UNet())
        latents = torch.zeros(batch, latent_hw, latent_hw, 4)
        t_emb = torch.zeros(batch, unet.time_embedding.linear_1.in_features)
        context = torch.zeros(batch, 77, 768)
    with attention.plain_scope(), FlopCounterMode(display=False) as counter:
        unet(latents, t_emb, context).square().mean().backward()
    return float(counter.get_total_flops())


def phase_train_full(card: str):
    """10a: the SD1.5 UNet at full width (seed 0, fp32, fused as the pipeline fuses
    it) takes one step and then TRAIN_TIMED_STEPS timed steps of the default
    AdamW on one batch of TRAIN_BATCH 64x64 latents. Every loss finite and the
    last below the first; after the first backward every gradient finite and not
    all zero; K1 and K2 launch 0 times; a TransformerBlock at (4, 4096, 320)
    on the default route with grad enabled is refused, with the counters
    unmoved."""
    from minsdtf_tpu_torch.models import unet as unet_lib
    from minsdtf_tpu_torch.training import train_step as ts

    torch.cuda.empty_cache()
    unet = unet_lib.fuse_attention_projections(unet_lib.init("cuda", seed=0))
    n_params = sum(p.numel() for p in unet.parameters())
    init_fn, step_fn = ts.make_train_step()
    opt = init_fn(unet)
    lr = opt.param_groups[0]["lr"]
    batch = ts.sample_batch(TRAIN_BATCH, latent_hw=64, device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    losses = [step_fn(unet, opt, batch)]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    bad_grads = grads_finite_and_nonzero(unet)
    qkv_names = [n for n, _ in unet.named_parameters() if n.endswith("attn1.to_qkv.weight")]
    samples = []
    for _ in range(TRAIN_TIMED_STEPS):
        t0 = time.perf_counter()
        losses.append(step_fn(unet, opt, batch))
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t0)
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [loss.item() for loss in losses]
    s_per_step = statistics.median(samples)
    flops = train_step_flops(TRAIN_BATCH, 64)
    bound_s = flops / PEAK_FLOPS[torch.float32]
    log(f"phase 10a full-width UNet training ({n_params} parameters, fp32, TF32 off, "
        f"AdamW lr {lr} betas {opt.param_groups[0]['betas']} eps {opt.param_groups[0]['eps']} "
        f"weight decay {opt.param_groups[0]['weight_decay']}), batch {TRAIN_BATCH} at 64x64: "
        f"first step {first_s:.4f} s, then median {s_per_step:.4f} s/step of "
        f"{[round(t, 4) for t in samples]}, {TRAIN_BATCH / s_per_step:.4f} samples/s, peak "
        f"memory {peak_gb:.3f} GB ({resident_gb:.3f} GB allocated before the first step), "
        f"losses {losses}, launches {launches} | {card}")
    log(f"phase 10a matmul and convolution operations of a step: {flops / 1e12:.4f} TFLOP "
        f"(flop counter); at the fp32 peak {PEAK_FLOPS[torch.float32] / 1e12:.0f} TFLOP/s "
        f"{bound_s:.4f} s, share {bound_s / s_per_step:.4f} of the median step")

    block = unet.down_blocks[0].attentions[0].transformer_blocks[0]
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(4, 4096, 320, generator=gen, device="cuda")
    context = torch.randn(4, 77, 768, generator=gen, device="cuda")
    refusal, refusal_launches = refuses_gradient(block, x, context)
    log(f"phase 10a a TransformerBlock at (4, 4096, 320) on the default route with grad: "
        f"{'RuntimeError: ' + refusal if refusal else 'no error'}; launches {refusal_launches}")
    checks = {
        "every loss finite": bool(np.isfinite(losses).all()),
        "the last loss below the first": losses[-1] < losses[0],
        "every gradient finite and not all zero": not bad_grads,
        f"the {len(qkv_names)} attn1.to_qkv among them": len(qkv_names) == 16
        and not set(qkv_names) & set(bad_grads),
        "K1 and K2 launched 0 times": attention_launches(launches) == {"onepass": 0, "online": 0},
        "the kernels refuse a gradient": refusal is not None and "no backward" in refusal,
        "the refused call launched nothing":
            attention_launches(refusal_launches) == {"onepass": 0, "online": 0},
    }
    log(f"phase 10a checks: {checks}" + (f"; bad gradients {bad_grads[:8]}" if bad_grads else ""))
    del unet, opt, batch, block, x, context
    torch.cuda.empty_cache()
    return all(checks.values()), dict(
        parameters=n_params, batch=TRAIN_BATCH, latent_hw=64, lr=lr, losses=losses,
        first_step_s=first_s, s_per_step=s_per_step, s_per_step_samples=samples,
        step_flops=flops, fp32_bound_s=bound_s,
        samples_per_s=TRAIN_BATCH / s_per_step, peak_gb=peak_gb, resident_gb=resident_gb,
        launches=launches)


def train_small(device: str, optimizer=None):
    """Two AdamW steps (lr TRAIN_SMALL_LR; ``optimizer`` replaces it for the
    control) of the small fused UNet (seed 0, made on the CPU and moved) on one
    batch of 2 at 32x32 (level 0's self-attention has 1024 tokens, which the
    default route sends to K1), drawn on the CPU. Returns, on the CPU: the
    losses, the initial weights, the gradients of each step, the weights after
    step 2, and the launches the steps made."""
    from minsdtf_tpu_torch.models import unet as unet_lib
    from minsdtf_tpu_torch.training import train_step as ts

    unet = unet_lib.fuse_attention_projections(unet_lib.init("cpu", seed=0, **TRAIN_SMALL))
    initial = {n: p.detach().clone() for n, p in unet.named_parameters()}
    unet.to(device)
    batch = ts.sample_batch(2, latent_hw=32, device="cpu",
                            generator=torch.Generator().manual_seed(1))
    batch = ts.TrainBatch(*(t.to(device) for t in batch))
    init_fn, step_fn = ts.make_train_step(
        optimizer or (lambda params: ts.adamw(params, lr=TRAIN_SMALL_LR)))
    opt = init_fn(unet)
    zero_launches()
    losses, grads = [], []
    for _ in range(2):
        losses.append(step_fn(unet, opt, batch).item())
        grads.append({n: p.grad.cpu() for n, p in unet.named_parameters()})
    params = {n: p.detach().cpu() for n, p in unet.named_parameters()}
    return dict(losses=losses, initial=initial, grads=grads, params=params,
                launches=read_launches())


def adamw_error(run: dict, lr: float = TRAIN_SMALL_LR) -> float:
    """The largest error of ``run``'s weights after its steps, over
    TRAIN_OPT_ATOL + TRAIN_OPT_RTOL·|want|, where ``want`` is optax.adamw(lr)
    (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4) applied in float64 numpy to
    the run's initial weights and its own gradients:
    p <- p - lr·(m̂/(√v̂+ε) + 1e-4·p)."""
    b1, b2, eps, decay = 0.9, 0.999, 1e-8, 1e-4
    worst = 0.0
    for name, p0 in run["initial"].items():
        p = p0.double().numpy()
        m, v = np.zeros_like(p), np.zeros_like(p)
        for t, grads in enumerate(run["grads"], 1):
            g = grads[name].double().numpy()
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            p = p - lr * ((m / (1 - b1 ** t)) / (np.sqrt(v / (1 - b2 ** t)) + eps) + decay * p)
        err = np.abs(run["params"][name].double().numpy() - p)
        worst = max(worst, float((err / (TRAIN_OPT_ATOL + TRAIN_OPT_RTOL * np.abs(p))).max()))
    return worst


def param_share(run: dict, cpu: dict) -> float:
    """The share of the weights after step 2 more than lr/100 apart from the CPU's."""
    diffs = torch.cat([(run["params"][n] - p).abs().flatten() for n, p in cpu["params"].items()])
    return float((diffs > TRAIN_SMALL_LR / 100).float().mean())


def compare_small_training() -> tuple:
    """10b: :func:`train_small` on the card against the CPU within the TRAIN_*
    tolerances, each device's AdamW against optax's update on its own gradients,
    and a control on the card, AdamW with torch's default weight decay, that the
    optimizer check must reject. Returns (passed, numbers)."""
    card, cpu = train_small("cuda"), train_small("cpu")
    control = train_small("cuda", lambda params: torch.optim.AdamW(
        params, lr=TRAIN_SMALL_LR, betas=(0.9, 0.999), eps=1e-8))
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card["losses"], cpu["losses"]))
    cpu_grads = cpu["grads"][0]
    floor = TRAIN_GRAD_ATOL_MODEL * max(float(g.abs().max()) for g in cpu_grads.values())
    grad_ratio = 0.0  # the largest error over its tolerance
    for name, want in cpu_grads.items():
        atol = max(TRAIN_GRAD_ATOL_REL * float(want.abs().max()), floor)
        limit = atol + TRAIN_GRAD_RTOL * want.abs()
        grad_ratio = max(grad_ratio, float(((card["grads"][0][name] - want).abs() / limit).max()))
    param_max = max(float((card["params"][n] - p).abs().max()) for n, p in cpu["params"].items())
    numbers = dict(
        card_losses=card["losses"], cpu_losses=cpu["losses"], loss_rel_err=loss_err,
        grad_err_over_tol=grad_ratio, adamw_err_over_tol_card=adamw_error(card),
        adamw_err_over_tol_cpu=adamw_error(cpu),
        adamw_err_over_tol_control=adamw_error(control), param_max_abs_err=param_max,
        param_share_beyond_lr_100=param_share(card, cpu),
        param_share_beyond_lr_100_control=param_share(control, cpu),
        parameters=sum(p.numel() for p in cpu["params"].values()), launches=card["launches"])
    checks = {
        f"losses within rtol {TRAIN_LOSS_RTOL}": loss_err <= TRAIN_LOSS_RTOL,
        "the loss falls": card["losses"][-1] < card["losses"][0],
        "every gradient within its tolerance": grad_ratio <= 1.0,
        "the card's AdamW is optax's": numbers["adamw_err_over_tol_card"] <= 1.0,
        "the CPU's AdamW is optax's": numbers["adamw_err_over_tol_cpu"] <= 1.0,
        "the control (weight decay 1e-2) is rejected": numbers["adamw_err_over_tol_control"] > 1.0,
        f"at most {TRAIN_PARAM_SHARE} of the weights beyond lr/100":
            numbers["param_share_beyond_lr_100"] <= TRAIN_PARAM_SHARE,
        "K1 and K2 launched 0 times on the card":
            attention_launches(card["launches"]) == {"onepass": 0, "online": 0},
    }
    return all(checks.values()), dict(numbers, checks=checks)


def phase_training(card: str):
    """Phase group 10: 10a and 10b. Returns the numbers for ``result.json``, or
    None if a check failed."""
    ok_full, full = phase_train_full(card)
    ok_small, small = compare_small_training()
    log(f"phase 10b small fp32 training (widths {TRAIN_SMALL['widths']}, batch 2 at 32x32, "
        f"lr {TRAIN_SMALL_LR}, 2 steps), card vs CPU: losses {small['card_losses']} against "
        f"{small['cpu_losses']} (max rel err {small['loss_rel_err']:.3e}, tol "
        f"{TRAIN_LOSS_RTOL}); gradients after step 1: largest error / tolerance "
        f"{small['grad_err_over_tol']:.3e}; AdamW against optax's on each run's own "
        f"gradients, largest error / tolerance (rtol {TRAIN_OPT_RTOL}, atol "
        f"{TRAIN_OPT_ATOL}): card {small['adamw_err_over_tol_card']:.3e}, CPU "
        f"{small['adamw_err_over_tol_cpu']:.3e}, control with weight decay 1e-2 on the card "
        f"{small['adamw_err_over_tol_control']:.3e}; weights after step 2, card against CPU: "
        f"max |diff| {small['param_max_abs_err']:.3e}, share beyond lr/100 "
        f"{small['param_share_beyond_lr_100']:.3e} of {small['parameters']} (tol "
        f"{TRAIN_PARAM_SHARE}; the control {small['param_share_beyond_lr_100_control']:.3e}); "
        f"launches {small['launches']}; checks {small['checks']}")
    if not (ok_full and ok_small):
        return None
    del small["checks"]
    return {"full_width": full, "small_card_vs_cpu": small}


# ---- phase group 11: int8 W8A8 and int8_hybrid ------------------------------------------

INT8_WARM_IMAGES = 3
INT8_SITES = 227  # the int8 sites of the full-width fused UNet, as in the JAX package
INT8_SMALL = dict(widths=(320, 64, 128, 128), temb_dim=128)
INT8_TIE_GAP = 1e-5  # a replayed tie's input difference, over the activation's amax
INT8_STATS_RTOL = 1e-4
INT8_CHECK_ROWS = 256  # 11b: the rows of each product held against the CPU
INT8_PEAK_OPS = 1979e12  # dense int8 tensor-core peak of the H100 SXM at 700 W


class RoundingReplay:
    """Holds one run's int8 roundings to another's. Where a rounding boundary of
    an int8 activation falls between two devices' fp32 values (1e-6 apart), the
    roundings differ by one step, every later int8 site then sees inputs a step
    apart and flips more of its own, and a 3-step CFG 7.5 int8 latent moves by
    orders of magnitude more than an fp32 one (the CPU tests measure it).
    ``recording()`` keeps each activation and
    its int8 values in call order; ``replaying()`` checks each of the second run's
    against them: every element that differs must be one step apart with inputs
    within ``INT8_TIE_GAP`` of the amax (a tie), and the run goes on with the
    recorded values. ``flips`` counts them."""

    def __init__(self):
        self.tape = []
        self.used = 0
        self.flips = 0

    @contextlib.contextmanager
    def _patched(self, fn):
        from minsdtf_tpu_torch.ops import basic

        original = basic._quantize_acts
        basic._quantize_acts = lambda x, site, dims, channel_dim: fn(
            original, x, site, dims, channel_dim)
        try:
            yield self
        finally:
            basic._quantize_acts = original

    def recording(self):
        def record(original, x, site, dims, channel_dim):
            xq, asc = original(x, site, dims, channel_dim)
            self.tape.append((x.float().cpu(), xq.cpu()))
            return xq, asc

        return self._patched(record)

    def replaying(self):
        def replay(original, x, site, dims, channel_dim):
            xq, asc = original(x, site, dims, channel_dim)
            want_x, want = self.tape[self.used]
            self.used += 1
            got = xq.cpu()
            differ = got != want
            if bool(differ.any()):
                steps = int((got[differ].int() - want[differ].int()).abs().max())
                gap = float((x.float().cpu()[differ] - want_x[differ]).abs().max())
                limit = INT8_TIE_GAP * float(want_x.abs().max())
                if steps != 1 or gap > limit:
                    raise AssertionError(f"{site.name}: {int(differ.sum())} int8 values differ "
                                         f"by up to {steps} with inputs {gap:.3e} apart "
                                         f"(a tie is 1 step within {limit:.3e})")
                self.flips += int(differ.sum())
                xq = want.to(xq.device)
            return xq, asc

        return self._patched(replay)


def counting_products(generate):
    """``generate`` that appends the int8 products each of its calls made to
    ``.counts`` (``basic.int8_matmul.calls``, counted on the host as they are
    issued)."""
    from minsdtf_tpu_torch.ops import basic

    def wrapped(**kw):
        before = basic.int8_matmul.calls
        out = generate(**kw)
        wrapped.counts.append(basic.int8_matmul.calls - before)
        return out

    wrapped.counts = []
    return wrapped


def psnr(got: np.ndarray, want: np.ndarray) -> float:
    mse = float(np.mean((got.astype(np.float64) - want.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


def products_check(generate, per_image: int, label: str):
    """A ``run_phase`` check: every call after the cold one made ``per_image``
    int8 products."""
    def check(image):
        log(f"{label}: int8 products per call {generate.counts}")
        return {f"int8 products per warm image == {per_image}":
                all(n == per_image for n in generate.counts[1:])}
    return check


def record_int8_shapes(generate) -> tuple:
    """One call of ``generate()`` with the int8 ops recorded: ({(M, K, N): count}
    of the products, {conv config: count} of the im2col convolutions, configs
    being (input shape, weight shape, stride, padding))."""
    from minsdtf_tpu_torch.ops import basic

    products, convs = {}, {}
    conv_acc, rescale = basic.int8_conv_acc, basic._rescale

    def conv(xq, weight_q, stride=1, padding=0):
        acc = conv_acc(xq, weight_q, stride, padding)
        key = (tuple(xq.shape), tuple(weight_q.shape), stride, basic._pads(padding))
        convs[key] = convs.get(key, 0) + 1
        b, ho, wo, o = acc.shape
        mkn = (b * ho * wo, weight_q[0].numel(), o)
        products[mkn] = products.get(mkn, 0) + 1
        return acc

    def rescale_dense(acc, asc, site, dtype):
        if not site.is_conv:
            mkn = (acc[..., 0].numel(), site.weight_q.shape[1], acc.shape[-1])
            products[mkn] = products.get(mkn, 0) + 1
        return rescale(acc, asc, site, dtype)

    basic.int8_conv_acc, basic._rescale = conv, rescale_dense
    try:
        with step_loop():  # a replay runs no Python to record
            generate()
        torch.cuda.synchronize()
    finally:
        basic.int8_conv_acc, basic._rescale = conv_acc, rescale
    return products, convs


def phase_int8_products(products: dict, convs: dict) -> tuple:
    """11b: each distinct (M, K, N) of the int8 products on random int8 inputs:
    the card's int32 result against the CPU's ``torch._int_mm`` on the same
    inputs (the first and last rows, ``INT8_CHECK_ROWS`` in all), bit for bit, and
    its device time against a bf16 product of the same shape; each distinct conv
    config's im2col product against an fp64 ``F.conv2d`` of the integer values on
    the card (exact: |sums| < 2^53). Returns (passed, numbers)."""
    from minsdtf_tpu_torch.ops import basic

    gen = torch.Generator(device="cuda").manual_seed(11)
    ok, rows, int8_ms_image, bf16_ms_image = True, [], 0.0, 0.0
    for (m, k, n), count in sorted(products.items()):
        a = torch.randint(-127, 128, (m, k), dtype=torch.int8, device="cuda", generator=gen)
        w = torch.randint(-127, 128, (n, k), dtype=torch.int8, device="cuda", generator=gen)
        got = basic.int8_matmul(a, w)
        half = min(m, INT8_CHECK_ROWS) // 2
        pick = torch.cat([torch.arange(half), torch.arange(m - (min(m, INT8_CHECK_ROWS) - half), m)])
        want = basic.int8_matmul(a.cpu()[pick], w.cpu())
        equal = bool(torch.equal(got.cpu()[pick], want))
        ab, wb = a.bfloat16(), w.bfloat16()
        int8_ms = time_ms(lambda: basic.int8_matmul(a, w), 20)
        bf16_ms = time_ms(lambda: ab @ wb.t(), 20)
        bound_ms = max(2 * m * k * n / INT8_PEAK_OPS, (m * k + n * k + 4 * m * n) / PEAK_BYTES) * 1e3
        int8_ms_image += count * int8_ms
        bf16_ms_image += count * bf16_ms
        ok &= equal
        rows.append({"mkn": [m, k, n], "per_image": count, "equal": equal, "int8_ms": int8_ms,
                     "bf16_ms": bf16_ms, "bound_ms": bound_ms})
        log(f"phase 11b int8 product (M,K,N)=({m},{k},{n}) x{count} an image: card == CPU on "
            f"{len(pick)} rows {'ok' if equal else 'FAIL'}; {int8_ms:.4f} ms (bf16 {bf16_ms:.4f} "
            f"ms, int8 bound {bound_ms:.4f} ms)")
    for (xshape, wshape, stride, pads), count in sorted(convs.items()):
        xq = torch.randint(-127, 128, xshape, dtype=torch.int8, device="cuda", generator=gen)
        wq = torch.randint(-127, 128, wshape, dtype=torch.int8, device="cuda", generator=gen)
        acc = basic.int8_conv_acc(xq, wq, stride, pads)
        (top, bottom), (left, right) = pads
        want = torch.nn.functional.conv2d(
            torch.nn.functional.pad(xq.double(), (left, right, top, bottom)), wq.double(),
            stride=stride)
        equal = bool(torch.equal(acc.permute(0, 3, 1, 2).double(), want))
        ok &= equal
        log(f"phase 11b im2col conv x{xshape} w{wshape} stride {stride} pad {pads} x{count} an "
            f"image == fp64 conv {'ok' if equal else 'FAIL'}")
    numbers = {"products": rows, "int8_gemm_ms_per_image": int8_ms_image,
               "bf16_gemm_ms_per_image_same_shapes": bf16_ms_image,
               "distinct_products": len(products), "distinct_convs": len(convs)}
    log(f"phase 11b: {len(products)} distinct products, {len(convs)} distinct convs, all equal: "
        f"{ok}; int8 GEMM device time an image at these shapes {int8_ms_image:.3f} ms (CUDA "
        f"graphs of 20), bf16 at the same shapes {bf16_ms_image:.3f} ms")
    return ok, numbers


def int8_pipeline(bpe: str, size: int = 512, **kw):
    from minsdtf_tpu_torch import StableDiffusion

    return StableDiffusion(size, size, bpe_path=bpe, **kw)


def phase_int8(bpe: str, bf16_image: np.ndarray, directory: str, phase7: dict):
    """Phase group 11 at full width, 512x512, 25 steps, CFG 7.5, bf16, random
    weights from the seeds of phase 5: 11a int8 with dynamic scales, 11b its int8
    products and convolutions, 11f a profile of one warm image, 11c
    ``calibrate_int8`` and the baked scales (then saved, and reloaded by a new
    pipeline that must give the same image), 11d int8_hybrid after calibration and
    ControlNet txt2img under int8. Returns (results, {phase: launches}), or None
    if a check failed."""
    from minsdtf_tpu_torch.models import controlnet as controlnet_lib
    from minsdtf_tpu_torch.models import unet as unet_lib
    from minsdtf_tpu_torch.models.common import cast_weights_
    from minsdtf_tpu_torch.weights import calibrate, quantize

    expect = {"onepass": 250, "online": 1}
    results, launches = {}, {}
    pipe = int8_pipeline(bpe, weight_dtype="int8")
    generate = counting_products(txt2img(pipe))
    per_image = INT8_SITES * 25
    ok, launches["int8"], samples, peak = run_phase(
        "phase 11a int8 txt2img", generate, 512, INT8_WARM_IMAGES, expect,
        products_check(generate, per_image, "phase 11a"))
    sites = quantize.int8_sites(pipe.unet)
    image = generate()
    quality = psnr(image, bf16_image)
    log(f"phase 11a: {len(sites)} int8 sites ({sum(s.is_conv for s in sites.values())} conv), "
        f"PSNR against phase 5's bf16 image {quality:.3f} dB (not a gate), max |diff| "
        f"{pixel_diff(image, bf16_image)[0]}")
    ok &= len(sites) == INT8_SITES
    results["int8"] = {"s_per_img": statistics.median(samples), "s_per_img_samples": samples,
                       "peak_gb": peak, "sites": len(sites), "products_per_image": per_image,
                       "psnr_vs_bf16_db": quality}
    if not ok:
        return None

    products, convs = record_int8_shapes(txt2img(pipe))
    ok, results["products"] = phase_int8_products(products, convs)
    ok &= sum(products.values()) == per_image
    if not ok:
        return None

    details = {}
    share = phase_profile(txt2img(pipe), statistics.median(samples), "phase 11f int8",
                          "profile_int8.txt", details=details)
    if share is not None:
        gemm_ms, gemm_n = details["groups"].get("int8 gemm", (0.0, 0))
        extra = (details["groups"].get("elementwise/other", (0.0, 0))[0]
                 - phase7.get("groups", {}).get("elementwise/other", (0.0, 0))[0])
        log(f"phase 11f: busy share {share:.4f}; int8 GEMM {gemm_ms:.3f} ms in {gemm_n} launches; "
            f"elementwise/other {extra:.3f} ms above phase 7's bf16 image (the activation "
            f"quantize and rescale)")
        for group in sorted(set(details["groups"]) | set(phase7.get("groups", {}))):
            t8, n8 = details["groups"].get(group, (0.0, 0))
            tb, nb = phase7.get("groups", {}).get(group, (0.0, 0))
            log(f"  group {group}: int8 {t8:.3f} ms, {n8} launches | bf16 (phase 7) {tb:.3f} ms, "
                f"{nb} launches")
        results["profile"] = {"busy_share": share, "busy_ms": details["busy_ms"],
                              "int8_gemm_ms": gemm_ms, "int8_gemm_launches": gemm_n,
                              "elementwise_ms_above_bf16": extra,
                              "groups": details["groups"]}

    t0 = time.perf_counter()
    stats = pipe.calibrate_int8()
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    sites = quantize.int8_sites(pipe.unet)
    baked = sum(s.act_scale is not None for s in sites.values())
    log(f"phase 11c calibrate_int8 (seeds 0 and 1, 25 steps): {calib_s:.3f} s, {len(stats)} "
        f"sites, {baked} baked")
    generate = counting_products(txt2img(pipe))
    ok, launches["int8_baked"], samples, peak = run_phase(
        "phase 11c int8 baked", generate, 512, INT8_WARM_IMAGES, expect,
        products_check(generate, per_image, "phase 11c"))
    path = os.path.join(directory, "int8_scales.npz")
    calibrate.save_scales(path, stats)
    reloaded = int8_pipeline(bpe, weight_dtype="int8", int8_act_scales=path)
    same = bool(np.array_equal(txt2img(reloaded)(), txt2img(pipe)()))
    del reloaded
    log(f"phase 11c: a new pipeline with int8_act_scales={os.path.basename(path)} gives the same "
        f"image bit for bit: {same}")
    ok &= same and len(stats) == INT8_SITES and 0 < baked < INT8_SITES
    results["int8_baked"] = {"calibrate_s": calib_s, "sites": len(stats), "baked": baked,
                             "s_per_img": statistics.median(samples), "s_per_img_samples": samples,
                             "peak_gb": peak, "reloaded_image_equal": same}
    if not ok:
        return None

    hybrid = int8_pipeline(bpe, weight_dtype="int8_hybrid")
    t0 = time.perf_counter()
    stats = hybrid.calibrate_int8()
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    sites = quantize.int8_sites(hybrid.unet)
    log(f"phase 11d int8_hybrid calibrate_int8: {calib_s:.3f} s, {len(stats)} conv sites "
        f"calibrated, {len(sites)} int8 sites")
    generate = counting_products(txt2img(hybrid))
    ok, launches["int8_hybrid"], samples, peak = run_phase(
        "phase 11d int8_hybrid", generate, 512, INT8_WARM_IMAGES, expect,
        products_check(generate, len(sites) * 25, "phase 11d"))
    ok &= 0 < len(sites) <= len(stats) and all(s.is_conv for s in sites.values())
    results["int8_hybrid"] = {"calibrate_s": calib_s, "calibrated": len(stats),
                              "sites": len(sites), "s_per_img": statistics.median(samples),
                              "s_per_img_samples": samples, "peak_gb": peak}
    del hybrid
    torch.cuda.empty_cache()
    if not ok:
        return None

    pipe._controlnet = cast_weights_(quantize.quantize_params(unet_lib.fuse_attention_projections(
        controlnet_lib.init(pipe.device, seed=3))), pipe.compute_dtype).eval()
    cn_sites = quantize.int8_sites(pipe._controlnet)
    hint = sum(n.startswith("controlnet_cond_embedding.") for n in cn_sites)
    _, _, edges = synthetic_inputs(512)
    generate = counting_products(lambda **kw: pipe.text_to_image(
        PROMPT, control_net_image=edges, num_steps=25, unconditional_guidance_scale=7.5,
        seed=1234, **kw))
    per_image = 25 * (INT8_SITES + len(cn_sites) - hint) + hint
    ok, launches["int8_controlnet"], samples, peak = run_phase(
        "phase 11d int8 ControlNet txt2img", generate, 512, 1, {"onepass": 350, "online": 1},
        products_check(generate, per_image, "phase 11d ControlNet"))
    log(f"phase 11d: the ControlNet has {len(cn_sites)} int8 sites, {hint} of them in the hint "
        f"branch (run once an image)")
    results["int8_controlnet"] = {"sites": len(cn_sites), "s_per_img": samples[0],
                                  "peak_gb": peak, "products_per_image": per_image}
    pipe._controlnet = None
    return (results, launches) if ok else None


def small_int8_pipeline(bpe: str, device: str, models: dict, weight_dtype: str, **kw):
    """A 64x64 fp32 pipeline on ``device`` with ``models``' text encoder and
    decoder (made on the CPU) and a small UNet built by the pipeline's own
    ``unet`` property from seed 0 on the CPU, quantized there as ``weight_dtype``
    says."""
    from minsdtf_tpu_torch import pipeline as pipeline_lib
    from minsdtf_tpu_torch.models import unet as unet_lib

    pipe = pipeline_lib.StableDiffusion(64, 64, bpe_path=bpe, compute_dtype=torch.float32,
                                        device=device, weight_dtype=weight_dtype, **kw)
    for name, model in models.items():
        setattr(pipe, name, copy.deepcopy(model).to(device).eval())
    build = pipeline_lib.build
    pipeline_lib.build = lambda factory, dev, seed: (
        unet_lib.init("cpu", seed=0, **INT8_SMALL).to(dev) if factory is unet_lib.UNet
        else build(factory, dev, seed))
    try:
        pipe.unet
    finally:
        pipeline_lib.build = build
    return pipe


def phase_int8_small(bpe: str) -> bool:
    """11e: the int8, baked and int8_hybrid paths at small widths, fp32 (TF32 off),
    64x64, 3 steps, on the card against the CPU, the card's int8 roundings held to
    the CPU's (:class:`RoundingReplay`): ``calibrate_int8`` (seed 0) amax per site
    within ``INT8_STATS_RTOL``, the latent within 1e-3 and the image within 1. The
    card's hybrid UNet is built from the CPU's statistics, as the CPU's is: each
    device's own would differ in the 7th digit, and a weight rounding could tie."""
    from minsdtf_tpu_torch.models import clip as clip_lib
    from minsdtf_tpu_torch.models import vae as vae_lib
    from minsdtf_tpu_torch.weights import quantize

    models = {"_text_model": clip_lib.init("cpu", seed=1),
              "_decoder": vae_lib.init_decoder("cpu", seed=2, dec_widths=(64, 64, 32, 32))}
    txt = dict(num_steps=3, seed=7, return_latent=True)
    all_ok = True

    def compare(label, cpu_run, card_run):
        replay = RoundingReplay()
        with replay.recording():
            want = cpu_run()
        # the replay reads each activation back to the host: the step loop's work
        with replay.replaying(), step_loop():
            got = card_run()
        return got, want, replay

    for mode in ("int8", "int8 baked", "int8_hybrid"):
        weight_dtype = mode.split()[0]
        cpu = small_int8_pipeline(bpe, "cpu", models, weight_dtype)
        card = small_int8_pipeline(bpe, "cuda", models, weight_dtype)
        checks = {}
        if mode != "int8":
            got, want, replay = compare(mode, lambda: cpu.calibrate_int8(num_steps=3, seeds=(0,)),
                                        lambda: card.calibrate_int8(num_steps=3, seeds=(0,)))
            worst = max(abs(got[k]["amax"] - want[k]["amax"]) / want[k]["amax"] for k in want)
            checks[f"calibration sites equal, amax within rtol {INT8_STATS_RTOL}"] = (
                set(got) == set(want) and worst <= INT8_STATS_RTOL)
            log(f"phase 11e {mode} calibrate_int8: {len(want)} sites, amax max rel diff "
                f"{worst:.3e}, {replay.flips} ties replayed")
            if mode == "int8_hybrid":
                card = small_int8_pipeline(bpe, "cuda", models, weight_dtype,
                                           int8_act_scales=want)
        (img_g, lat_g), (img_c, lat_c), replay = compare(
            mode, lambda: cpu.text_to_image("hello world", **txt),
            lambda: card.text_to_image("hello world", **txt))
        lat_err = float(abs(lat_g - lat_c).max())
        img_err = int(abs(img_g.astype(int) - img_c.astype(int)).max())
        sites = quantize.int8_sites(card.unet)
        checks.update({
            "every int8 call replayed": replay.used == len(replay.tape) > 0,
            "latent within 1e-3": lat_err <= 1e-3, "image within 1": img_err <= 1,
            "int8 sites on both devices alike": sorted(sites) == sorted(quantize.int8_sites(
                cpu.unet)) and len(sites) > 0})
        ok = all(checks.values())
        all_ok &= ok
        log(f"phase 11e {mode} small fp32, card vs CPU: latent max_abs_err {lat_err:.3e} (max "
            f"|latent| {float(abs(lat_c).max()):.3e}), image max |diff| {img_err}, {len(sites)} "
            f"int8 sites, {len(replay.tape)} int8 calls, {replay.flips} ties replayed; "
            f"{checks} {'ok' if ok else 'FAIL'}")
    return all_ok


# ---- phase 6e: the t = 999 samplers at CFG 7.5 against fp64 -----------------------

T999_SAMPLERS = ("tcd", "lcm", "dpm_karras")
T999_RATIO = 2.0  # the card's fp32 error may be at most twice the CPU's


def phase_t999(bpe: str) -> bool:
    """6e: TCD, LCM and DPM++ 2M Karras at phase 6c's small setting (256x256, UNet
    (320, 64, 128, 128), decoder (192, 64, 32, 32), 3 steps, seed 7) but at CFG
    7.5: fp64 on the CPU is the reference; fp32 on the CPU and fp32 on the card
    (TF32 off) are each held against it. The card's latent error must be at most
    T999_RATIO times the CPU's (``tests/test_torch_fp64_samplers.py`` holds the
    CPU's)."""
    from minsdtf_tpu_torch import StableDiffusion
    from minsdtf_tpu_torch.models import clip as clip_lib
    from minsdtf_tpu_torch.models import unet as unet_lib
    from minsdtf_tpu_torch.models import vae as vae_lib

    models = dict(
        _unet=unet_lib.fuse_attention_projections(unet_lib.init("cpu", seed=0, **MESH_SMALL)),
        _decoder=vae_lib.init_decoder("cpu", seed=2, dec_widths=(192, 64, 32, 32)),
        _text_model=clip_lib.init("cpu", seed=1))
    all_ok = True
    for sampler_type in T999_SAMPLERS:
        runs = {}
        for label, device, dtype in (("fp64 CPU", "cpu", torch.float64),
                                     ("fp32 CPU", "cpu", torch.float32),
                                     ("fp32 card", "cuda", torch.float32)):
            pipe = StableDiffusion(256, 256, bpe_path=bpe, compute_dtype=dtype, device=device,
                                   scheduler_type=sampler_type)
            for name, model in models.items():
                setattr(pipe, name, model.to(device).eval())
            runs[label] = pipe.text_to_image("hello world", num_steps=3, seed=7,
                                             return_latent=True, unconditional_guidance_scale=7.5)
        (img64, lat64) = runs["fp64 CPU"]
        errs = {label: float(np.abs(lat - lat64).max()) for label, (_, lat) in runs.items()
                if label != "fp64 CPU"}
        img_errs = {label: int(np.abs(img.astype(int) - img64.astype(int)).max())
                    for label, (img, _) in runs.items() if label != "fp64 CPU"}
        ratio = errs["fp32 card"] / errs["fp32 CPU"]
        ok = ratio <= T999_RATIO
        all_ok &= ok
        log(f"phase 6e {sampler_type} CFG 7.5 against fp64 on the CPU: latent max_abs_err "
            f"fp32 CPU {errs['fp32 CPU']:.4e}, fp32 card {errs['fp32 card']:.4e} (card / CPU "
            f"{ratio:.3f}, limit {T999_RATIO}); image max |diff| {img_errs}; max |latent| "
            f"{float(np.abs(lat64).max()):.3f} {'ok' if ok else 'FAIL'}")
    return all_ok


# ---- phase group 12: the (data, model) mesh ------------------------------------------

MESH_SMALL = dict(widths=(320, 64, 128, 128), temb_dim=128)
MESH_TRAIN_BATCH = 4  # 12e: two rows a data rank, at 32x32
# 12b's and 12c's depth, cut from phase 5's 25 steps so that the whole script
# stays within the time it took before 12d became spatial SP and 12c and 12g grew
MESH_CUT_STEPS = 10
MESH_SMALL_SP = dict(size=128, min_seq=256)  # 12g: the UNet's level 0 and every VAE level shard


def mesh_rank_setup() -> int:
    """What every rank of group 12 does first: TF32 off, as phase 1 sets it.
    Returns the rank."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.distributed.get_rank()


def small_mesh_run(bpe: str, device: str, mesh=None, img2img: bool = False, size: int = 256,
                   **kw):
    """txt2img (or, with ``img2img``, image_to_image of ``synthetic_inputs(size)``'s
    reference at strength 0.8) at ``size`` x ``size``, 3 steps, seed 7, CFG 7.5,
    fp32, on the small unfused modules (seeds 0, 2, 1, 4; made on the CPU and
    moved): ``(image, latent)``."""
    from minsdtf_tpu_torch import StableDiffusion
    from minsdtf_tpu_torch.models import clip as clip_lib
    from minsdtf_tpu_torch.models import unet as unet_lib
    from minsdtf_tpu_torch.models import vae as vae_lib

    pipe = StableDiffusion(size, size, bpe_path=bpe, compute_dtype=torch.float32, device=device,
                           mesh=mesh, **kw)
    pipe._unet = unet_lib.init("cpu", seed=0, **MESH_SMALL).to(device).eval()
    pipe._decoder = vae_lib.init_decoder("cpu", seed=2, dec_widths=(192, 64, 32, 32)).to(
        device).eval()
    pipe._text_model = clip_lib.init("cpu", seed=1).to(device).eval()
    common = dict(num_steps=3, seed=7, return_latent=True)
    if not img2img:
        return pipe.text_to_image("hello world", **common)
    pipe._encoder = vae_lib.init_encoder("cpu", seed=4, enc_widths=(32, 32, 64, 64)).to(
        device).eval()
    return pipe.image_to_image("hello world", reference_image=synthetic_inputs(size)[0],
                               **common)


def small_against(got, want) -> tuple:
    """(latent max abs error, image max |diff|, within 1e-3 and 1)."""
    (img, lat), (want_img, want_lat) = got, want
    lat_err = float(np.abs(lat - want_lat).max())
    img_err = int(np.abs(img.astype(int) - want_img.astype(int)).max())
    return lat_err, img_err, img.shape == want_img.shape and lat_err <= 1e-3 and img_err <= 1


class _ShapeRecorder:
    """Stands in for the ``flash_attention`` module that ``ops/attention.py`` calls:
    records the (B, S, H, D) shape of each wrapper call, by kernel, and passes
    every call and attribute on to the module."""

    def __init__(self, fa, shapes: dict):
        self._fa, self._shapes = fa, shapes

    def __getattr__(self, name):
        return getattr(self._fa, name)

    def onepass_attention(self, q, k, v, scale):
        self._shapes["onepass"].add(tuple(q.shape))
        return self._fa.onepass_attention(q, k, v, scale)

    def online_attention(self, q, k, v, scale):
        self._shapes["online"].add(tuple(q.shape))
        return self._fa.online_attention(q, k, v, scale)


@contextlib.contextmanager
def recording_kernel_shapes():
    """In the body, the (B, S, H, D) shapes each kernel wrapper is called at by
    the attention routing, by kernel (a set each); the wrappers and their counts
    are unchanged."""
    from minsdtf_tpu_torch.ops import attention

    shapes = {"onepass": set(), "online": set()}
    fa = attention.fa
    attention.fa = _ShapeRecorder(fa, shapes)
    try:
        yield shapes
    finally:
        attention.fa = fa


@contextlib.contextmanager
def recording_gathers():
    """In the body, ``{(local shape, dim): count}`` of the tensors that
    ``comm.all_gather`` gathers; the call itself is unchanged."""
    from minsdtf_tpu_torch.parallel import comm

    gathers, gather = {}, comm.all_gather

    def recorded(t, group, dim=0):
        key = (tuple(t.shape), dim)
        gathers[key] = gathers.get(key, 0) + 1
        return gather(t, group, dim)

    comm.all_gather = recorded
    try:
        yield gathers
    finally:
        comm.all_gather = gather


def mesh_timed(generate, images: int, warm: bool = True) -> dict:
    """``generate()`` once cold and, with ``warm``, once more timed; the timed call
    returns its latent and runs with the launch, ring, spatial and collective
    counts and the peak memory zeroed just before it and read just after, the
    kernels' shapes and the gathered tensors recorded."""
    from minsdtf_tpu_torch.ops import ring_attention
    from minsdtf_tpu_torch.parallel import comm, spatial

    cold_s = None
    if warm:
        t0 = time.perf_counter()
        generate()
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
    zero_launches()
    ring_attention.ring_multi_head_attention.calls = 0
    ring_attention.ring_attention_sharded.calls = 0
    comm.reset_stats()
    spatial.reset_calls()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with recording_kernel_shapes() as shapes, recording_gathers() as gathers:
        image, latent = generate(return_latent=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(cold_s=cold_s, s_per_img=wall / images, image=image, latent=latent,
                launches=read_launches(),
                ring_calls=ring_attention.ring_multi_head_attention.calls,
                ring_sharded=ring_attention.ring_attention_sharded.calls,
                spatial=dict(spatial.calls), gathers=gathers, comm=copy.deepcopy(comm.stats),
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                shapes={k: sorted(v) for k, v in shapes.items()})


def mesh_rank_pair(bpe: str) -> dict:
    """One of the two gloo ranks on the card: 12c (DP, mesh (2, 1), batch 2, and
    this rank's row at batch 1 on one device; then a batch of 3, which the data
    axis does not divide, against one device's batch of 3), 12d (spatial SP, mesh
    (1, 2), 1024x1024), 12g (small fp32 spatial SP, txt2img and img2img, at
    ``MESH_SMALL_SP``) and 12b (TP, mesh (1, 2), and the small fp32 TP run), on
    one set of full-width modules (seeds as phase 5, unfused): whole for 12c and
    12d, then sharded for 12b. 12c and 12b run ``MESH_CUT_STEPS`` steps."""
    from minsdtf_tpu_torch import StableDiffusion
    from minsdtf_tpu_torch import rng as rng_lib
    from minsdtf_tpu_torch.ops import ring_attention
    from minsdtf_tpu_torch.parallel import comm
    from minsdtf_tpu_torch.parallel.mesh import make_mesh

    rank = mesh_rank_setup()
    out = {}
    settings = dict(num_steps=25, unconditional_guidance_scale=7.5, seed=1234)
    cut = dict(settings, num_steps=MESH_CUT_STEPS)
    dp = StableDiffusion(512, 512, bpe_path=bpe, mesh=make_mesh(2, 1))
    out["dp"] = mesh_timed(lambda **kw: dp.text_to_image(PROMPT, batch_size=2, **cut, **kw),
                           images=2)
    single = StableDiffusion(512, 512, bpe_path=bpe)
    for name in ("_unet", "_decoder", "_text_model", "_tokenizer", "_uncond"):
        setattr(single, name, getattr(dp, name))
    noise = rng_lib.stateless_normal((2, 64, 64, 4), settings["seed"])[rank]
    out["dp_single"] = single.generate_image(
        dp._encode_text_dev(PROMPT), batch_size=1, diffusion_noise=noise, num_steps=MESH_CUT_STEPS,
        unconditional_guidance_scale=7.5, guidance_rescale=0.7, return_latent=True)
    # a batch of 3 on data = 2: each rank runs the whole batch and gathers nothing
    comm.reset_stats()
    t0 = time.perf_counter()
    out["dp3"] = dp.text_to_image(PROMPT, batch_size=3, **cut, return_latent=True)
    out["dp3_s"] = time.perf_counter() - t0
    out["dp3_gathers"] = comm.stats["all_gather"]["calls"]
    out["dp3_single"] = single.text_to_image(PROMPT, batch_size=3, **cut,
                                             return_latent=True)

    sp = StableDiffusion(1024, 1024, bpe_path=bpe, mesh=make_mesh(1, 2), sequence_parallel=True)
    for name in ("_unet", "_decoder", "_text_model", "_tokenizer"):
        setattr(sp, name, getattr(dp, name))
        getattr(sp, name.lstrip("_"))  # placed before the timed call
    out["sp"] = mesh_timed(lambda **kw: sp.text_to_image(PROMPT, **settings, **kw), images=1,
                           warm=False)
    os.environ["MINSDTF_SP_MIN_SEQ"] = str(MESH_SMALL_SP["min_seq"])  # read at construction
    try:
        before = ring_attention.ring_attention_sharded.calls
        comm.reset_stats()
        for key, img2img in (("sp_small", False), ("sp_small_i2i", True)):
            out[key] = small_mesh_run(bpe, "cuda", make_mesh(1, 2), img2img=img2img,
                                      size=MESH_SMALL_SP["size"], sequence_parallel=True)
        out["sp_small_ring_calls"] = ring_attention.ring_attention_sharded.calls - before
        out["sp_small_halos"] = comm.stats["halo"]["calls"]
    finally:
        del os.environ["MINSDTF_SP_MIN_SEQ"]

    out["tp_single"] = single.text_to_image(PROMPT, **cut)  # before TP shards the modules
    tp = StableDiffusion(512, 512, bpe_path=bpe, mesh=make_mesh(1, 2))
    with torch.inference_mode():  # the modules hold inference tensors by now
        for name in ("_unet", "_decoder", "_text_model", "_tokenizer"):
            setattr(tp, name, getattr(dp, name))
            getattr(tp, name.lstrip("_"))  # sharded before the timed call
    # one call: a first TP call takes as long as a second (3.402 and 3.436 s on an
    # H100 80GB HBM3 at 700 W)
    out["tp"] = mesh_timed(lambda **kw: tp.text_to_image(PROMPT, **cut, **kw), images=1,
                           warm=False)
    out["tp_heads"] = tp.unet.down_blocks[0].attentions[0].transformer_blocks[0].attn1.num_heads
    out["tp_small"] = small_mesh_run(bpe, "cuda", make_mesh(1, 2))
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def mesh_rank_train() -> dict:
    """12e on one of four gloo ranks, mesh (2, 2): two AdamW steps (lr
    TRAIN_SMALL_LR) of the small unfused UNet (seed 0) sharded over the model axis,
    on this rank's rows of one batch of MESH_TRAIN_BATCH at 32x32 drawn on the
    CPU (seed 1). Returns the losses, this rank's gradients after step 1 and
    weights after step 2 (on the CPU), its model rank, launches, collectives and
    the steps' seconds."""
    from minsdtf_tpu_torch.models import unet as unet_lib
    from minsdtf_tpu_torch.parallel import comm, sharding
    from minsdtf_tpu_torch.parallel.mesh import make_mesh
    from minsdtf_tpu_torch.training import train_step as ts

    mesh_rank_setup()
    mesh = make_mesh(2, 2)
    unet = sharding.shard_module(unet_lib.init("cpu", seed=0, **TRAIN_SMALL).to("cuda"), mesh)
    batch = ts.sample_batch(MESH_TRAIN_BATCH, latent_hw=32, device="cpu",
                            generator=torch.Generator().manual_seed(1))
    local = ts.TrainBatch(*(sharding.shard_batch(t, mesh).to("cuda") for t in batch))
    init_fn, step_fn = ts.make_train_step(lambda p: ts.adamw(p, lr=TRAIN_SMALL_LR), mesh=mesh)
    opt = init_fn(unet)
    zero_launches()
    comm.reset_stats()
    losses, seconds, grads = [], [], None
    for step in range(2):
        t0 = time.perf_counter()
        losses.append(step_fn(unet, opt, local).item())
        seconds.append(time.perf_counter() - t0)
        if step == 0:
            grads = {n: p.grad.cpu() for n, p in unet.named_parameters()}
    return dict(losses=losses, grads=grads, seconds=seconds, launches=read_launches(),
                params={n: p.detach().cpu() for n, p in unet.named_parameters()},
                model_rank=mesh.get_local_rank("model"), comm=copy.deepcopy(comm.stats))


def train_reference_cpu() -> dict:
    """12e's reference: the same two steps on one CPU process, unsharded, on the
    whole batch."""
    from minsdtf_tpu_torch.models import unet as unet_lib
    from minsdtf_tpu_torch.training import train_step as ts

    unet = unet_lib.init("cpu", seed=0, **TRAIN_SMALL)
    batch = ts.sample_batch(MESH_TRAIN_BATCH, latent_hw=32, device="cpu",
                            generator=torch.Generator().manual_seed(1))
    init_fn, step_fn = ts.make_train_step(lambda p: ts.adamw(p, lr=TRAIN_SMALL_LR))
    opt = init_fn(unet)
    losses, grads = [], None
    for step in range(2):
        losses.append(step_fn(unet, opt, batch).item())
        if step == 0:
            grads = {n: p.grad.clone() for n, p in unet.named_parameters()}
    return dict(losses=losses, grads=grads,
                params={n: p.detach().clone() for n, p in unet.named_parameters()})


def compare_mesh_training(ranks: list, cpu: dict) -> dict:
    """12e's checks: each rank's losses within TRAIN_LOSS_RTOL of the CPU's, its
    gradients after step 1 within 10b's tolerances of the matching slices of the
    CPU's, and at most TRAIN_PARAM_SHARE of its weights after step 2 beyond lr/100."""
    from minsdtf_tpu_torch.parallel.sharding import shard_tensor

    floor = TRAIN_GRAD_ATOL_MODEL * max(float(g.abs().max()) for g in cpu["grads"].values())
    numbers = {"loss_rel_err": 0.0, "grad_err_over_tol": 0.0, "param_share_beyond_lr_100": 0.0}
    for rank in ranks:
        r = rank["model_rank"]
        numbers["loss_rel_err"] = max(numbers["loss_rel_err"], max(
            abs(a - b) / abs(b) for a, b in zip(rank["losses"], cpu["losses"])))
        diffs = []
        for name, got in rank["grads"].items():
            want = shard_tensor(name, cpu["grads"][name], r, 2)
            atol = max(TRAIN_GRAD_ATOL_REL * float(want.abs().max()), floor)
            ratio = float(((got - want).abs() / (atol + TRAIN_GRAD_RTOL * want.abs())).max())
            numbers["grad_err_over_tol"] = max(numbers["grad_err_over_tol"], ratio)
            diffs.append((rank["params"][name] - shard_tensor(name, cpu["params"][name], r, 2))
                         .abs().flatten())
        share = float((torch.cat(diffs) > TRAIN_SMALL_LR / 100).float().mean())
        numbers["param_share_beyond_lr_100"] = max(numbers["param_share_beyond_lr_100"], share)
    checks = {
        f"losses within rtol {TRAIN_LOSS_RTOL}": numbers["loss_rel_err"] <= TRAIN_LOSS_RTOL,
        "every gradient within its tolerance": numbers["grad_err_over_tol"] <= 1.0,
        f"at most {TRAIN_PARAM_SHARE} of the weights beyond lr/100":
            numbers["param_share_beyond_lr_100"] <= TRAIN_PARAM_SHARE,
        "K1 and K2 launched 0 times": all(
            attention_launches(rank["launches"]) == {"onepass": 0, "online": 0} for rank in ranks),
    }
    return dict(numbers, checks=checks)


def comm_line(stats: dict) -> str:
    return ", ".join(f"{kind} {s['calls']} calls {s['bytes'] / 1e6:.3f} MB {s['seconds']:.4f} s"
                     for kind, s in stats.items() if s["calls"])


def image_against(image: np.ndarray, want: np.ndarray) -> str:
    diff = np.abs(image.astype(int) - want.astype(int))
    return (f"max |diff| {int(diff.max())}, mean {float(diff.mean()):.4f}, PSNR "
            f"{psnr(image, want):.3f} dB")


# 12d's gathers a rank, (local shape, dim): count. Per UNet call (CFG pair) the
# downsampler's output rows out of level 0 (128x128 -> 64x64) and conv_out's rows;
# the decoder's output rows once. Nothing else is gathered: no ring output.
SP_GATHERS = {((2, 320, 32, 64), 2): 25, ((2, 4, 64, 128), 2): 25, ((1, 3, 512, 1024), 2): 1}


def while_ranks_run(fn, world: int, args, cpu_work, threads: int = 4):
    """``run_ranks(fn, world, args)`` on the card, deadline 300 s, in a thread,
    while ``cpu_work()`` runs here on at most ``threads`` torch threads (the
    ranks' host work needs the other cores). Returns both results."""
    from minsdtf_tpu_torch.parallel import mesh as mesh_lib

    before = torch.get_num_threads()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        future = pool.submit(mesh_lib.run_ranks, fn, world, args, device="cuda",
                             timeout_s=300)
        torch.set_num_threads(min(threads, before))
        try:
            done = cpu_work()
        finally:
            torch.set_num_threads(before)
        return future.result(), done


def phase_mesh(card: str, bpe: str, image_512: np.ndarray, image_1024: np.ndarray,
               peak_gb_1024: float):
    """Phase group 12. Returns the numbers for ``result.json`` and each run's
    launches, or None if a check failed. The times are this one card's: gloo ranks
    share it and reach each other through host memory, which times the port's
    code, not a multi-GPU machine's interconnect."""
    import torch.distributed as dist

    from minsdtf_tpu_torch import StableDiffusion
    from minsdtf_tpu_torch.parallel import dryrun, mesh as mesh_lib

    out, launches, all_ok = {}, {}, True

    # 12a: NCCL at world size 1 in this process
    with tempfile.TemporaryDirectory(prefix="chip-smoke-nccl-") as tmp:
        mesh_lib.init_process(0, 1, "file://" + os.path.join(tmp, "store"), "nccl", "cuda")
        try:
            mesh = mesh_lib.make_mesh(1, 1)
            a = mesh_timed(txt2img(StableDiffusion(512, 512, bpe_path=bpe, mesh=mesh)), 1)
            a_small_run = small_mesh_run(bpe, "cuda", mesh)
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()

    # 12b, 12c, 12d, 12g: two gloo ranks on the card, the CPU references meanwhile
    def cpu_references():
        return small_mesh_run(bpe, "cpu"), {
            key: small_mesh_run(bpe, "cpu", img2img=img2img, size=MESH_SMALL_SP["size"])
            for key, img2img in (("sp_small", False), ("sp_small_i2i", True))}

    t0 = time.perf_counter()
    pair, (cpu_small, cpu_sp_small) = while_ranks_run(mesh_rank_pair, 2, (bpe,), cpu_references)
    pair_s = time.perf_counter() - t0
    a_small = small_against(a_small_run, cpu_small)
    checks = {"K1/K2 250/1":
              attention_launches(a["launches"]) == {"onepass": 250, "online": 1},
              "image (1, 512, 512, 3)": a["image"].shape == (1, 512, 512, 3),
              "small fp32 mesh (1, 1) on the card against the CPU": a_small[2]}
    log(f"phase 12a NCCL, world 1, mesh (1, 1): {a['s_per_img']:.4f} s/img (cold "
        f"{a['cold_s']:.3f} s), launches {a['launches']}, collectives {comm_line(a['comm'])}; "
        f"against phase 5's image (fused projections, no mesh): "
        f"{image_against(a['image'], image_512)}; small fp32 against the CPU: latent "
        f"{a_small[0]:.3e}, image {a_small[1]}; checks {checks} | {card}")
    all_ok &= all(checks.values())
    launches["nccl_world1"] = a["launches"]
    out["12a"] = dict(s_per_img=a["s_per_img"], launches=a["launches"], comm=a["comm"],
                      small_latent_err=a_small[0], psnr_vs_phase5=psnr(a["image"], image_512))

    for r, res in enumerate(pair):
        dp, sp, tp = res["dp"], res["sp"], res["tp"]
        img1, lat1 = res["dp_single"]
        equal = bool(np.array_equal(dp["image"][r:r + 1], img1)) and bool(
            np.array_equal(dp["latent"][r:r + 1], lat1))
        tp_small = small_against(res["tp_small"], cpu_small)
        sp_small, sp_i2i = (small_against(res[key], cpu_sp_small[key])
                            for key in ("sp_small", "sp_small_i2i"))
        img3, lat3 = res["dp3"]
        equal3 = bool(np.array_equal(img3, res["dp3_single"][0])) and bool(
            np.array_equal(lat3, res["dp3_single"][1]))
        checks = {
            f"12c K1/K2 {10 * MESH_CUT_STEPS}/1":
                attention_launches(dp["launches"])
                == {"onepass": 10 * MESH_CUT_STEPS, "online": 1},
            "12c image (2, 512, 512, 3), both rows on each rank": dp["image"].shape == (2, 512, 512, 3)
            and np.array_equal(dp["image"], pair[0]["dp"]["image"]),
            "12c this rank's row equals one device's batch-1 call, bit for bit": equal,
            "12c batch 3 on data = 2: the whole batch, nothing gathered, equal to one "
            "device's batch of 3 bit for bit": img3.shape == (3, 512, 512, 3)
            and res["dp3_gathers"] == 0 and equal3,
            "12d K1 250, K2 0": attention_launches(sp["launches"]) == {"onepass": 250, "online": 0},
            "12d sharded ring 126 (125 UNet level 0, 1 VAE), no whole-input ring":
                sp["ring_sharded"] == 126 and sp["ring_calls"] == 0,
            "12d gathers: the level-0 downsampler's and conv_out's rows 25 each, the "
            "decoder's output once": sp["gathers"] == SP_GATHERS,
            "12d halo exchanges and GroupNorm sums": sp["comm"]["halo"]["calls"] > 0
            and sp["comm"]["all_reduce"]["calls"] > 0,
            "12d image (1, 1024, 1024, 3)": sp["image"].shape == (1, 1024, 1024, 3),
            "12g small fp32 spatial SP txt2img against the CPU": sp_small[2]
            and res["sp_small_ring_calls"] > 0 and res["sp_small_halos"] > 0,
            "12g small fp32 spatial SP img2img (encoder sharded) against the CPU": sp_i2i[2],
            f"12b K1/K2 {10 * MESH_CUT_STEPS}/1":
                attention_launches(tp["launches"])
                == {"onepass": 10 * MESH_CUT_STEPS, "online": 1},
            "12b K1 at (2,4096,4,40) and (2,1024,4,80), K2 at (1,4096,1,512)":
                set(tp["shapes"]["onepass"]) == {(2, 4096, 4, 40), (2, 1024, 4, 80)}
                and tp["shapes"]["online"] == [(1, 4096, 1, 512)],
            "12b 4 heads a rank": res["tp_heads"] == 4,
            "12b small fp32 TP against the CPU": tp_small[2],
        }
        all_ok &= all(checks.values())
        log(f"phase 12c DP rank {r}, gloo, mesh (2, 1), batch 2, {MESH_CUT_STEPS} steps: "
            f"{dp['s_per_img']:.4f} s/img "
            f"(cold call {dp['cold_s']:.3f} s), launches {dp['launches']}, collectives "
            f"{comm_line(dp['comm'])}; row {r} against one device's batch-1 call: "
            f"{image_against(dp['image'][r:r + 1], img1)}, latent max |diff| "
            f"{float(np.abs(dp['latent'][r:r + 1] - lat1).max()):.3e}; batch 3 on data = 2 "
            f"in {res['dp3_s']:.3f} s, {res['dp3_gathers']} gathers, against one device's "
            f"batch of 3: {image_against(img3, res['dp3_single'][0])}, latent max |diff| "
            f"{float(np.abs(lat3 - res['dp3_single'][1]).max()):.3e}")
        log(f"phase 12d spatial SP rank {r}, gloo, mesh (1, 2), 1024x1024: "
            f"{sp['s_per_img']:.4f} s/img (one call, the first at 1024px), launches "
            f"{sp['launches']}, sharded ring calls {sp['ring_sharded']}, whole-input ring calls "
            f"{sp['ring_calls']}, K1 shapes {sp['shapes']['onepass']}, spatial calls "
            f"{sp['spatial']}, gathers {sp['gathers']}, collectives {comm_line(sp['comm'])}; "
            f"peak memory {sp['peak_gb']:.3f} GB (phase 5b, one device: {peak_gb_1024:.3f} GB); "
            f"against phase 5b's image: {image_against(sp['image'], image_1024)}")
        log(f"phase 12g small fp32 spatial SP rank {r}, gloo, mesh (1, 2), min_seq "
            f"{MESH_SMALL_SP['min_seq']}, {MESH_SMALL_SP['size']}px "
            f"({res['sp_small_ring_calls']} sharded ring calls, "
            f"{res['sp_small_halos']} halo exchanges), card against the CPU: txt2img latent "
            f"{sp_small[0]:.3e}, image {sp_small[1]}; img2img latent {sp_i2i[0]:.3e}, image "
            f"{sp_i2i[1]} (tol 1e-3, 1)")
        log(f"phase 12b TP rank {r}, gloo, mesh (1, 2), {MESH_CUT_STEPS} steps: "
            f"{tp['s_per_img']:.4f} s/img (one call), launches {tp['launches']}, shapes "
            f"{tp['shapes']}, collectives {comm_line(tp['comm'])}; against one device's "
            f"{MESH_CUT_STEPS}-step image: {image_against(tp['image'], res['tp_single'])}; "
            f"small fp32 TP against the CPU: latent "
            f"{tp_small[0]:.3e}, image {tp_small[1]}; peak memory {res['peak_gb']:.3f} GB; "
            f"checks {checks} | {card}")
        for key, run in (("dp", dp), ("sp", sp), ("tp", tp)):
            launches[f"{key}_rank{r}"] = run["launches"]
        out[f"rank{r}"] = {
            key: dict(s_per_img=run["s_per_img"], cold_s=run["cold_s"], launches=run["launches"],
                      ring_calls=run["ring_calls"], ring_sharded=run["ring_sharded"],
                      spatial=run["spatial"], comm=run["comm"], peak_gb=run["peak_gb"],
                      gathers={str(k): v for k, v in run["gathers"].items()})
            for key, run in (("12c_dp", dp), ("12d_sp", sp), ("12b_tp", tp))}
        out[f"rank{r}"].update(
            psnr_12b_vs_one_device=psnr(tp["image"], res["tp_single"]),
            psnr_12d_vs_phase5b=psnr(sp["image"], image_1024), dp_row_bit_equal=equal,
            dp_batch3_bit_equal=equal3, dp_batch3_s=res["dp3_s"],
            tp_small_latent_err=tp_small[0], sp_small_latent_err=sp_small[0],
            sp_small_img2img_latent_err=sp_i2i[0], peak_gb_1024_one_device=peak_gb_1024)
    log(f"phase 12b-12d, 12g: two ranks in {pair_s:.1f} s")

    # 12e: the train step under DP x TP on four gloo ranks, its CPU reference meanwhile
    train, cpu_train = while_ranks_run(mesh_rank_train, 4, (), train_reference_cpu)
    numbers = compare_mesh_training(train, cpu_train)
    all_ok &= all(numbers["checks"].values())
    log(f"phase 12e train step, gloo, mesh (2, 2), widths {TRAIN_SMALL['widths']}, batch "
        f"{MESH_TRAIN_BATCH} at 32x32, lr {TRAIN_SMALL_LR}, card against one CPU process: "
        f"losses {[t['losses'] for t in train]} against {cpu_train['losses']}, "
        f"{ {k: v for k, v in numbers.items() if k != 'checks'} }; step seconds "
        f"{[t['seconds'] for t in train]}; collectives rank 0 {comm_line(train[0]['comm'])}; "
        f"checks {numbers['checks']}")
    out["12e"] = dict(numbers, losses=[t["losses"] for t in train], cpu_losses=cpu_train["losses"],
                      seconds=[t["seconds"] for t in train])

    # 12f: the dry run on the card
    t0 = time.perf_counter()
    lines = dryrun.dryrun(4, "cuda", timeout_s=300)
    ok = lines[-1] == "dryrun_multichip OK" and len(lines) == 6
    all_ok &= ok
    log(f"phase 12f dryrun --n 4 on the card in {time.perf_counter() - t0:.1f} s: {lines} "
        f"{'ok' if ok else 'FAIL'}")
    out["12f"] = dict(lines=lines)
    return (out, launches) if all_ok else None


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    sys.path.insert(0, HERE)
    try:
        import minsdtf_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script: {e}", file=sys.stderr)
        return 1
    os.makedirs(OUT_DIR, exist_ok=True)

    def mark(done: str):
        log(f"chip_smoke: {done} done at {time.perf_counter() - t_start:.1f} s")

    card, kind = phase_card()
    phase_build()
    errors = phase_check()
    if errors is None:
        return 1
    timings = phase_time(torch.Generator(device="cuda").manual_seed(0))
    fp32_timings = phase_time_fp32(torch.Generator(device="cuda").manual_seed(0))
    group_norm = phase_group_norm(torch.Generator(device="cuda").manual_seed(0))
    if group_norm is None:
        return 1
    mark("phases 1-4")
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as tmp:
        bpe = synthetic_merges(tmp)
        ok, fp32_launches, fp32_samples, fp32_peak_gb, fp32_unet_err = phase_fp32(bpe)
        if not ok:
            return 1
        mark("phase 5m")
        # every GroupNorm on the kernel (61 a UNet call, 25 calls, 30 in the decode),
        # every convolution channels-last
        ok, launches, samples, peak_gb, pipe = phase_txt2img(
            bpe, 512, WARM_IMAGES, {"onepass": 250, "online": 1, **NHWC_IMAGE}, "phase 5")
        if not ok:
            return 1
        # 1024px: K1 at UNet levels 1 and 2, K2 at level 0 (125) and the VAE (1).
        ok, launches_1024, samples_1024, peak_gb_1024, pipe_1024 = phase_txt2img(
            bpe, 1024, WARM_IMAGES_1024, {"onepass": 250, "online": 126, **NHWC_IMAGE},
            "phase 5b")
        if not ok:
            return 1
        # 5l: the 1024px program against the step loop, and the loop timed
        program_1024 = program_against_loop("phase 5l 1024px", txt2img(pipe_1024))
        with step_loop():
            ok, _, loop_samples_1024, _ = run_phase(
                "phase 5l step loop 1024px", txt2img(pipe_1024), 1024, WARM_IMAGES_1024,
                {"onepass": 250, "online": 126})
        program_1024["stats"] = program_stats("phase 5l 1024px pipeline", pipe_1024)
        if not (ok and program_1024["ok"]):
            return 1
        phase_profile(txt2img(pipe_1024), statistics.median(samples_1024), "phase 7b 1024px",
                      "profile_1024.txt")
        with step_loop():
            phase_profile(txt2img(pipe_1024), statistics.median(loop_samples_1024),
                          "phase 7b step loop 1024px", "profile_1024_loop.txt")
        image_1024 = txt2img(pipe_1024)()  # 12d's single-device reference
        del pipe_1024  # the later phases' peak memory holds only the 512px pipeline
        torch.cuda.empty_cache()
        mark("phases 5, 5b and 7b")
        samplers = phase_samplers(pipe, 512, tmp)
        if samplers is None:
            return 1
        mark("phases 5f-5j")
        new_paths = phase_new_paths(pipe, 512)
        if new_paths is None:
            return 1
        mark("phases 5c-5e")
        program = phase_program(pipe, new_paths, samplers)
        if program is None:
            return 1
        program.update(samples_1024=loop_samples_1024, at_1024=program_1024)
        mark("phase 5k")
        if not small_reference_check(bpe, tmp):
            return 1
        if not phase_t999(bpe):
            return 1
        mark("phases 6-6e")
        s_per_img = statistics.median(samples)
        phase7 = {}
        phase_profile(txt2img(pipe), s_per_img, "phase 7", "profile.txt", details=phase7)
        with step_loop():
            phase_profile(txt2img(pipe), statistics.median(program["loop_samples"]),
                          "phase 7 step loop", "profile_loop.txt")
        for path, label in (("controlnet", "phase 7c ControlNet"), ("img2img", "phase 7d img2img")):
            _, _, warm, _, generate = new_paths[path]
            phase_profile(generate, statistics.median(warm), label, f"profile_{path}.txt")
        # one call makes 8 images: its unprofiled wall is 8 x the median s/img
        _, _, warm, _, generate = samplers["tcd_b8"]
        phase_profile(generate, 8 * statistics.median(warm), "phase 7e TCD batch 8",
                      "profile_tcd_b8.txt")
        mark("phases 7-7e")
        directory = os.path.join(HERE, "build", "chip_smoke_ckpt")  # gitignored
        os.makedirs(directory, exist_ok=True)
        try:
            checkpoints = phase_checkpoints(pipe, bpe, directory, new_paths["controlnet"][-1])
            if checkpoints is None:
                return 1
            ckpt_launches, ckpt_numbers, ckpt_path = checkpoints
            mark("phases 8a-8c")
            serving = {"generate_images": phase_generate_images(pipe), "serve": phase_serve(pipe),
                       "caches": phase_caches(pipe, bpe, directory, ckpt_path),
                       "tools": phase_tools(bpe, directory, ckpt_path)}
            if not all(r["ok"] for r in serving.values()):
                return 1
            mark("phases 9a-9d")
        finally:
            shutil.rmtree(directory)
    training = phase_training(card)
    if training is None:
        return 1
    mark("phases 10a-10b")
    with tempfile.TemporaryDirectory(prefix="chip-smoke-int8-") as tmp:
        bpe = synthetic_merges(tmp)
        image_512 = txt2img(pipe)()  # phase 5's image again, for 11a and group 12
        int8 = phase_int8(bpe, image_512, tmp, phase7)
        if int8 is None:
            return 1
        int8_results, int8_launches = int8
        del pipe
        torch.cuda.empty_cache()
        if not phase_int8_small(bpe):
            return 1
    mark("phases 11a-11f")
    with tempfile.TemporaryDirectory(prefix="chip-smoke-mesh-") as tmp:
        mesh = phase_mesh(card, synthetic_merges(tmp), image_512, image_1024, peak_gb_1024)
    if mesh is None:
        return 1
    mesh_results, mesh_launches = mesh
    mark("phases 12a-12f")
    new_paths.update(samplers)

    def path_launches(name: str) -> dict:
        """The kernel's launch counter as each path read it."""
        return {"launches": launches[name], "launches_1024px": launches_1024[name],
                **{f"launches_{path}": r[1][name] for path, r in new_paths.items()},
                **{f"launches_{path}": n[name] for path, n in ckpt_launches.items()},
                **{f"launches_{path}": serving[path]["launches"][name]
                   for path in ("generate_images", "serve")},
                "launches_training": training["full_width"]["launches"][name],
                **{f"launches_{path}": n[name] for path, n in int8_launches.items()},
                **{f"launches_{path}": n[name] for path, n in mesh_launches.items()}}

    rows = []
    for name, label, line in (("onepass", "flash_onepass (K1)", 153),
                              ("online", "flash_online (K2)", 181)):
        main_shape, *others = timings[name]
        rows.append({"name": label, "route": "cuda",
                     "source": "minsdtf_tpu_torch/csrc/flash_attention.cu",
                     "replaces": f"minsdtf_tpu/ops/flash_attention.py:{line}",
                     **path_launches(name), "max_abs_err": errors[name, torch.bfloat16],
                     **{k: main_shape[k] for k in ("ms", "loop_ms", "plain_ms", "bound_ms",
                                                   "bound_by", "library_ms", "shape")},
                     "other_shapes": others})
    # the fp32 kernels, on the fp32 path (phase 5m)
    for name, label, line in (("onepass", "flash_onepass_f32 (K1, fp32)", 153),
                              ("online", "flash_online_f32 (K2, fp32)", 181)):
        main_shape, *others = fp32_timings[name]
        rows.append({"name": label, "route": "cuda",
                     "source": "minsdtf_tpu_torch/csrc/flash_attention.cu",
                     "replaces": f"minsdtf_tpu/ops/flash_attention.py:{line}",
                     "launches": fp32_launches[name], "max_abs_err": errors[name, torch.float32],
                     **{k: main_shape[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                   "library_ms", "shape")},
                     "other_shapes": others})
    main_gn, *other_gn = group_norm["timings"]
    rows.append({"name": "group_norm_nhwc (no TPU counterpart)", "route": "cuda",
                 "source": "minsdtf_tpu_torch/csrc/group_norm.cu", "replaces": None,
                 **path_launches("group_norm"), "checks": group_norm["checks"],
                 **{k: main_gn[k] for k in ("ms", "plain_ms", "bound_ms", "two_reads_ms",
                                            "library_ms", "shape")},
                 "bound_by": "bytes", "other_shapes": other_gn})
    with open(os.path.join(OUT_DIR, "result.json"), "w") as f:
        json.dump({"card": card, "kind": kind, "s_per_img": s_per_img, "s_per_img_samples": samples,
                   "peak_gb": peak_gb, "s_per_img_1024": statistics.median(samples_1024),
                   "s_per_img_1024_samples": samples_1024, "peak_gb_1024": peak_gb_1024,
                   **{f"{key}_{path}": value for path, (_, _, warm, peak, _) in new_paths.items()
                      for key, value in (("s_per_img", statistics.median(warm)),
                                         ("s_per_img_samples", warm), ("peak_gb", peak))},
                   "checkpoints": ckpt_numbers, "serving": serving, "training": training,
                   "int8": int8_results, "mesh": mesh_results, "program": program,
                   "fp32": {"s_per_img": statistics.median(fp32_samples),
                            "s_per_img_samples": fp32_samples, "peak_gb": fp32_peak_gb,
                            "unet_rel_err": fp32_unet_err},
                   "kernels": rows}, f, indent=1)
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


def small_reference_check(bpe: str, directory: str) -> bool:
    """fp32 at 256x256 with small UNet / VAE / ControlNet widths, on the card and on
    the CPU with the same weights: txt2img (phase 6), then img2img, inpaint and
    ControlNet txt2img (phase 6b), then each other sampler, v-prediction, batch 2
    and a TI embedding with a negative embedding (phase 6c, at CFG 3; the
    samplers' step noise is drawn on the host, so both devices get the same), then
    two requests merged as the server merges them and the same two at batch 1
    (phase 6d), each also held against the other on each device. On the card they run
    K1 (1024 tokens, d=40) and K2 (the VAE's d=192), on the CPU the plain versions.
    Latent within 1e-3, uint8 image within 1."""
    from minsdtf_tpu_torch import StableDiffusion
    from minsdtf_tpu_torch import rng as rng_lib
    from minsdtf_tpu_torch.models import clip as clip_lib
    from minsdtf_tpu_torch.models import controlnet as controlnet_lib
    from minsdtf_tpu_torch.models import unet as unet_lib
    from minsdtf_tpu_torch.models import vae as vae_lib
    from minsdtf_tpu_torch.ops import flash_attention as fa

    small = dict(widths=(320, 64, 128, 128), temb_dim=128)
    models = dict(
        _unet=unet_lib.fuse_attention_projections(unet_lib.init("cpu", seed=0, **small)),
        _decoder=vae_lib.init_decoder("cpu", seed=2, dec_widths=(192, 64, 32, 32)),
        _encoder=vae_lib.init_encoder("cpu", seed=4, enc_widths=(32, 32, 64, 192)),
        _text_model=clip_lib.init("cpu", seed=1),
        _controlnet=unet_lib.fuse_attention_projections(
            controlnet_lib.init("cpu", seed=3, **small)),
    )
    reference, mask, edges = synthetic_inputs(256)
    ti, neg = embedding_files(directory)
    common = dict(num_steps=3, seed=7, return_latent=True)

    def txt(pipe, **kw):
        return pipe.text_to_image("hello world", **common, **kw)

    # 6c at CFG 3: TCD, LCM and the Karras spacing start at t = 999, where x0 =
    # (x - nr*eps) / sr multiplies eps by 1/sr = 14.7; at CFG 7.5 the random
    # weights make latents of +-70 there, and the two devices' fp32, 1.5e-5 apart
    # relative to that, differ by up to 1.5e-3 (PERF.md, run S1)
    def txt3(pipe, **kw):
        return txt(pipe, unconditional_guidance_scale=3.0, **kw)

    # 6d: two requests as the server merges them (stacked contexts, each seed's
    # noise row) and each at batch 1, at the server's settings
    pair = (("hello world", 7), ("the cat", 8))
    serve_kw = dict(num_steps=3, unconditional_guidance_scale=7.5, guidance_rescale=0.7,
                    return_latent=True)

    def merged(pipe):
        h8 = pipe.img_height // 8
        return pipe.generate_image(
            torch.cat([pipe._encode_text_dev(p) for p, _ in pair]), batch_size=2,
            diffusion_noise=np.concatenate([rng_lib.stateless_normal((1, h8, h8, 4), s)
                                            for _, s in pair]), **serve_kw)

    def batch1_pair(pipe):
        outs = [pipe.generate_image(pipe._encode_text_dev(p), seed=s, **serve_kw)
                for p, s in pair]
        return tuple(np.concatenate(parts) for parts in zip(*outs))

    runs = {  # label: (pipeline settings, the call)
        "phase 6 txt2img": ({}, txt),
        "phase 6b img2img": ({}, lambda pipe: pipe.image_to_image(
            "hello world", reference_image=reference, **common)),
        "phase 6b inpaint": ({}, lambda pipe: pipe.inpaint(
            "hello world", reference_image=reference, inpaint_mask=mask, mask_blur_strength=5,
            **common)),
        "phase 6b ControlNet txt2img": ({}, lambda pipe: pipe.text_to_image(
            "hello world", control_net_image=edges, **common)),
        "phase 6c DPM++ 2M": (dict(scheduler_type="dpm"), txt3),
        "phase 6c DPM++ 2M Karras": (dict(scheduler_type="dpm_karras"), txt3),
        "phase 6c Euler-a": (dict(scheduler_type="euler_a"), txt3),
        "phase 6c TCD": (dict(active_tcd=True), txt3),
        "phase 6c LCM": (dict(scheduler_type="lcm"), txt3),
        "phase 6c v-prediction": (dict(prediction_type="v"), txt3),
        "phase 6c batch 2": ({}, lambda pipe: txt3(pipe, batch_size=2)),
        "phase 6c TI + negative embedding": ({}, lambda pipe: txt3(
            pipe, embedding=ti, negative_embedding=neg)),
        "phase 6d merged batch of 2": ({}, merged),
        "phase 6d the same two at batch 1": ({}, batch1_pair),
    }
    results = {}
    for device in ("cuda", "cpu"):
        base = StableDiffusion(256, 256, bpe_path=bpe, compute_dtype=torch.float32,
                               device=device)
        for name, model in models.items():
            setattr(base, name, model.to(device).eval())
        for label, (settings, run) in runs.items():
            pipe = with_settings(base, **settings) if settings else base
            before = fa.onepass_attention.launches + fa.online_attention.launches
            out = run(pipe)
            results[label, device] = out, (fa.onepass_attention.launches
                                           + fa.online_attention.launches - before)
    all_ok = True
    for label in runs:
        ((img_g, lat_g), n_g), ((img_c, lat_c), n_c) = results[label, "cuda"], results[label, "cpu"]
        lat_err = float(abs(lat_g - lat_c).max())
        img_err = int(abs(img_g.astype(int) - img_c.astype(int)).max())
        ok = (img_g.shape == img_c.shape and lat_err <= 1e-3 and img_err <= 1 and n_g > 0
              and n_c == 0)
        all_ok &= ok
        log(f"{label} small fp32, card vs CPU: latent max_abs_err {lat_err:.3e} (tol 1e-3; max "
            f"|latent| {float(abs(lat_c).max()):.3e}), image max |diff| {img_err} (tol 1), "
            f"images {img_g.shape}, kernel launches {n_g} on the card, {n_c} on the CPU "
            f"{'ok' if ok else 'FAIL'}")
    for device in ("cuda", "cpu"):
        (img_m, lat_m), _ = results["phase 6d merged batch of 2", device]
        (img_1, lat_1), _ = results["phase 6d the same two at batch 1", device]
        lat_err = float(abs(lat_m - lat_1).max())
        img_err = int(abs(img_m.astype(int) - img_1.astype(int)).max())
        ok = img_m.shape == img_1.shape == (2, 256, 256, 3) and lat_err <= 1e-3 and img_err <= 1
        all_ok &= ok
        log(f"phase 6d small fp32 on {device}, merged batch of 2 vs the same at batch 1: latent "
            f"max_abs_err {lat_err:.3e} (tol 1e-3), image max |diff| {img_err} (tol 1) "
            f"{'ok' if ok else 'FAIL'}")
    return all_ok


if __name__ == "__main__":
    sys.exit(main())
