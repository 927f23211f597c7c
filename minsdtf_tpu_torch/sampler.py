"""The classifier-free-guidance denoising loop: one step's body on static
buffers, captured once a signature and replayed on the card, driven as a Python
step loop elsewhere.

Per step: the UNet (after the ControlNet, when one is given) on the batched CFG
pair (batch 2B; two calls when the cond and uncond context lengths differ), the
CFG combine and std-matching rescale (arXiv:2305.08891 §3.4), for v-prediction
the conversion of v to (x0, eps), the update of the schedule's mode (DDIM, TCD,
LCM, DPM-Solver++(2M) or Euler-a) from the rows of
:class:`minsdtf_tpu_torch.scheduler.DenoiseSchedule`, and for inpaint the latent
blend. Then the VAE decode, the inpaint pixel blend and
``(x + 1) / 2 -> clip -> uint8``.

The stochastic updates (LCM, Euler-a, TCD with eta > 0) take their per-step
noise from ``step_noise``, drawn by the caller before the loop.

The body (:meth:`_Program.body`) reads everything from static buffers, as the
JAX package's ``lax.scan`` body (``minsdtf_tpu/sampler.py``) reads its inputs:
the step's row of the schedule (an (n, k) tensor on the device, fp32 values in
the update's dtype), its timestep embedding and its noise are copied into them
before each step, and the latent and DPM's x0 carry stay in them between steps.
The guidance scale and rescale are 0-d tensors in the buffers, so a new value
reuses the program, as JAX traces them; the last step selects its update with
``torch.where``.

On the card (:func:`generate` with CUDA tensors) the body is captured once as a
CUDA graph and replayed once a step, with no host work inside a step, and the
decode, the pixel blend and the uint8 conversion are a second graph. The first
call of a signature runs step 0 and the decode eagerly on the capture stream
(this builds the kernels and initializes cuBLAS and cuDNN before the capture),
captures each, and replays steps 1 to n - 1; a later call replays every step.
``callback(step)`` is called after each step. Elsewhere, and on the card when
called by its name, :func:`_generate_eager` drives the same body with nothing
captured: the CPU path, a mesh's (whose gloo collectives stage through host
memory and cannot be captured), and the reference the card's program is held
against.

:func:`program_key` names what fixes the captured work: the shapes and dtypes of
the static buffers (B, h, w, the context lengths, the compute dtype), the mode
and flags, the attention route in force (:func:`ops.attention.route_key`), the
TF32 switches, and the identity and the weights' addresses of the UNet, the
decoder and the ControlNet, which each program holds. n_steps is not part of it,
nor is ``trace_latents``: the trajectory is copied out after each step. A
:class:`ProgramCache` holds up to ``MAX_PROGRAMS`` programs, the least recently
used out first; the pipeline holds one and empties it when a module is replaced.
Its programs share one memory pool, so the cache holds the largest program's
activations, not their sum: every tensor that lives from one replay to another is
a static buffer outside the pool or a graph's output, which is copied out before
any other replay. A cache serves one image at a time: :func:`generate` holds its
lock from the program's lookup to the copy of the outputs, so threads that share
a pipeline (the Streamlit app's sessions) take turns, and a ``callback`` must not
call into the same cache. The capture's error mode is ``thread_local``: a thread
that touches the card while another captures does not break the capture.

The kernels' launch counters (``onepass_attention.launches``,
``online_attention.launches``, ``int8_matmul.calls``, ``group_norm_nhwc.launches``,
``group_norm.kernel_calls``) and the models' layout counters (``group_norm.plain_calls``,
``conv2d.layout_misses``) count in Python, which a replay never runs: a capture's
change to them is taken back and added once for each replay, so they read what the
loop reads.

A capture that fails raises and its program is dropped; an exception from a
replay or a ``callback`` leaves the program for the next call. Nothing falls back
to the uncaptured loop.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Callable, Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch

from minsdtf_tpu_torch import profiling
from minsdtf_tpu_torch.ops import attention as attention_ops
from minsdtf_tpu_torch.ops import basic
from minsdtf_tpu_torch.ops import flash_attention as fa
from minsdtf_tpu_torch.ops import group_norm as gn_kernel
from minsdtf_tpu_torch.ops.basic import stats_dtype
from minsdtf_tpu_torch.scheduler import MODES

MAX_PROGRAMS = 8  # a pipeline's signatures: the server's merged batches 4, 2, 1 and more
# the counters a replay must advance: (function, attribute)
COUNTERS = ((fa.onepass_attention, "launches"), (fa.online_attention, "launches"),
            (basic.int8_matmul, "calls"), (basic.group_norm, "kernel_calls"),
            (basic.group_norm, "plain_calls"), (basic.conv2d, "layout_misses"),
            (gn_kernel.group_norm_nhwc, "launches"))


def rescale_noise_cfg(noise_cfg, noise_pred_text, guidance_rescale: torch.Tensor,
                      one_minus_rescale: torch.Tensor, epsilon: float = 1e-5):
    """Std-matching CFG rescale; the identity when ``guidance_rescale == 0``.
    ``guidance_rescale`` is a 0-d tensor of the compute dtype and
    ``one_minus_rescale`` 1 - guidance_rescale as a 0-d tensor of the update's dtype,
    which a 0-d tensor of a half dtype would round."""
    dims = tuple(range(1, noise_cfg.dim()))
    wide = stats_dtype(noise_cfg.dtype)
    std_text = noise_pred_text.to(wide).std(dim=dims, keepdim=True, correction=0)
    std_cfg = noise_cfg.to(wide).std(dim=dims, keepdim=True, correction=0) + epsilon
    rescaled = noise_cfg * (std_text / std_cfg).to(noise_cfg.dtype)
    kept = (noise_cfg.to(wide) * one_minus_rescale).to(noise_cfg.dtype)
    return guidance_rescale * rescaled + kept


class Inpaint(NamedTuple):
    """What the inpaint blends take; each tensor fp32 and NHWC, batch 1 or B."""
    init_latent: torch.Tensor   # (1|B, h, w, 4), the encoded reference image
    noise: torch.Tensor         # (B, h, w, 4), the initial noise, reused every step
    latent_mask: torch.Tensor   # (1, h, w, 1), 1 = generate
    image01: torch.Tensor       # (1, H, W, 3), the reference image in [0, 1]
    pixel_mask: torch.Tensor    # (1, H, W, 1)


NOISY_MODES = ("lcm", "euler_a")  # modes that need step_noise; TCD takes it optionally


def generate(
    unet,
    decoder,
    latent0: torch.Tensor,                   # (B, h, w, 4) in the compute dtype
    context: torch.Tensor,                   # (B or 1, S, 768)
    uncond_context: Optional[torch.Tensor],  # (B or 1, S', 768); None = no CFG
    t_embs: torch.Tensor,                    # (n, 320) timestep embeddings
    rows: Mapping[str, np.ndarray],          # DenoiseSchedule rows, each (n,)
    guidance_scale: float,
    guidance_rescale: float,
    controlnet=None,
    hint: Optional[torch.Tensor] = None,     # (B, 320, h, w) HintNet output, with controlnet
    inpaint: Optional[Inpaint] = None,
    callback: Optional[Callable[[int], None]] = None,
    mode: str = "ddim",                      # DenoiseSchedule.mode
    step_noise: Optional[torch.Tensor] = None,  # (n, B, h, w, 4) fp32 z per step
    v_prediction: bool = False,
    trace_latents: bool = False,
    programs: Optional["ProgramCache"] = None,
):
    """Returns ``(image uint8 (B, 8h, 8w, 3), latent (B, h, w, 4))``, and with
    ``trace_latents`` a third element, the ``(n, B, h, w, 4)`` latent after each
    step in the update's dtype (fp32; fp64 in fp64); the image is None when
    ``decoder`` is None. With ``controlnet``, each UNet call takes its residuals
    for the same inputs and ``hint``. With ``inpaint``, each step's new latent
    outside the mask is the reference latent noised to the step's t, and the
    decoded image outside the pixel mask is the reference image.
    ``callback(step)`` is called after each step, from 1.

    ``mode`` must be one of ``scheduler.MODES``; "lcm" and "euler_a" need
    ``step_noise``, and "tcd" re-noises only when it is given. With
    ``v_prediction`` the model predicts v = sr*eps - nr*x0; CFG acts on the raw
    v.

    CUDA tensors run the captured program of ``programs``; without a cache the
    call captures a program for itself alone, so a caller that makes more than
    one image passes one. Other tensors run the step loop."""
    if latent0.device.type == "cuda":
        return _generate_program(
            unet, decoder, latent0, context, uncond_context, t_embs, rows, guidance_scale,
            guidance_rescale, controlnet, hint, inpaint, callback, mode, step_noise,
            v_prediction, trace_latents, programs)
    return _generate_eager(
        unet, decoder, latent0, context, uncond_context, t_embs, rows, guidance_scale,
        guidance_rescale, controlnet, hint, inpaint, callback, mode, step_noise, v_prediction,
        trace_latents)


@torch.inference_mode()
def _generate_eager(
    unet, decoder, latent0, context, uncond_context, t_embs, rows, guidance_scale,
    guidance_rescale, controlnet=None, hint=None, inpaint=None, callback=None, mode="ddim",
    step_noise=None, v_prediction=False, trace_latents=False,
):
    """:func:`generate` as a Python step loop over the program's body, with nothing
    captured: the CPU path, a mesh's, and the reference the card's program is
    held against."""
    return _run(unet, decoder, latent0, context, uncond_context, t_embs, rows, guidance_scale,
                guidance_rescale, controlnet, hint, inpaint, callback, mode, step_noise,
                v_prediction, trace_latents, None)


@torch.inference_mode()
def _generate_program(
    unet, decoder, latent0, context, uncond_context, t_embs, rows, guidance_scale,
    guidance_rescale, controlnet=None, hint=None, inpaint=None, callback=None, mode="ddim",
    step_noise=None, v_prediction=False, trace_latents=False,
    programs: Optional["ProgramCache"] = None,
):
    """:func:`generate` through a program of ``programs`` (see the module's doc); on
    the CPU, where there are no graphs, the program runs its body and decode on its
    static buffers as they are, which the CPU tests drive."""
    return _run(unet, decoder, latent0, context, uncond_context, t_embs, rows, guidance_scale,
                guidance_rescale, controlnet, hint, inpaint, callback, mode, step_noise,
                v_prediction, trace_latents, ProgramCache(size=1) if programs is None else programs)


def _check_args(mode: str, step_noise, latent0, t_embs) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown sampler mode {mode!r}; one of {MODES}")
    if mode in NOISY_MODES and step_noise is None:
        raise ValueError(f"mode {mode!r} needs step_noise")
    n_steps = t_embs.shape[0]
    if step_noise is not None and tuple(step_noise.shape) != (n_steps, *latent0.shape):
        raise ValueError(f"step_noise is {tuple(step_noise.shape)}, not "
                         f"{(n_steps, *latent0.shape)}")


def _dense(latent0, inpaint: Optional[Inpaint], step_noise):
    """The latent-shaped inputs in the NHWC order in memory. Each step's
    elementwise ops lay their output out as their first operand, so an input laid
    out otherwise (the VAE encoder's latent is a slice of its 8 channels) would carry
    its layout into the latent, and the decoder's and the UNet's convolutions would run
    in another memory format, with other kernels, than on a program's buffers."""
    if inpaint is not None:
        inpaint = Inpaint(*(t.contiguous() for t in inpaint))
    return (latent0.contiguous(), inpaint,
            None if step_noise is None else step_noise.contiguous())


def _prepare(latent0, context, uncond_context, controlnet, hint) -> Dict[str, torch.Tensor]:
    """The contexts and hints that the step's UNet calls take: in the compute
    dtype and broadcast over the batch; for the batched CFG pair (the two context
    lengths equal) concatenated as ``ctx_pair`` and ``hint_pair``, else
    ``context``, ``uncond_context`` (with CFG) and ``hint`` (with a ControlNet)."""
    dtype = latent0.dtype
    batch = latent0.shape[0]
    context = context.to(dtype).expand(batch, -1, -1)
    if uncond_context is not None:
        uncond_context = uncond_context.to(dtype).expand(batch, -1, -1)
    if controlnet is not None:
        hint = hint.to(dtype)
    if uncond_context is not None and uncond_context.shape[1] == context.shape[1]:
        out = {"ctx_pair": torch.cat([uncond_context, context])}
        if controlnet is not None:
            out["hint_pair"] = torch.cat([hint, hint])
        return out
    out = {"context": context}
    if uncond_context is not None:
        out["uncond_context"] = uncond_context
    if controlnet is not None:
        out["hint"] = hint
    return out


def _decode_image(decoder, latent, image01=None, pixel_mask=None):
    """The decode, the inpaint pixel blend (with ``image01``) and the uint8
    conversion."""
    image = (decoder(latent).to(stats_dtype(latent.dtype)) + 1.0) * 0.5
    if image01 is not None:
        image = image01 * (1.0 - pixel_mask) + image * pixel_mask
    return (image * 255.0).clamp(0.0, 255.0).to(torch.uint8)


def row_table(rows: Mapping[str, np.ndarray]):
    """``(keys, (n, k) float64 array)``: the schedule's rows as the body reads
    them, each rounded to fp32 as the JAX sampler takes them; the device holds them
    in the update's dtype, so fp64 keeps them exact."""
    keys = tuple(sorted(rows))
    table = np.stack([np.asarray(rows[k], np.float32) for k in keys], axis=1)
    return keys, table.astype(np.float64)


def _run(unet, decoder, latent0, context, uncond_context, t_embs, rows, guidance_scale,
         guidance_rescale, controlnet, hint, inpaint, callback, mode, step_noise, v_prediction,
         trace_latents, programs: Optional["ProgramCache"]):
    """The setup of one call, then the body's steps and the decode on a program:
    one made for this call and run uncaptured when ``programs`` is None, else the
    cache's program of the call's signature, under the cache's lock; all of it the
    span ``program.run``, with the batch."""
    with profiling.span("program.run", n=latent0.shape[0]):
        _check_args(mode, step_noise, latent0, t_embs)
        latent0, inpaint, step_noise = _dense(latent0, inpaint, step_noise)
        device = latent0.device
        dtype = latent0.dtype
        wide = stats_dtype(dtype)  # the update's dtype: fp32, fp64 in fp64
        use_cfg = uncond_context is not None
        statics = dict(_prepare(latent0, context, uncond_context, controlnet, hint), latent=latent0)
        row_keys, table = row_table(rows)
        # the CFG scalars rounded to the compute dtype, as the JAX sampler casts them,
        # and 1 - g in double; one copy to the device with the rows, then the update's dtype
        gs, g = (torch.tensor(float(s), dtype=dtype).item() for s in (guidance_scale, guidance_rescale))
        flat = _upload(np.concatenate([table.reshape(-1), [gs, g, 1.0 - g]]), device).to(wide)
        rows_dev = flat[:table.size].view(table.shape)
        if use_cfg:
            statics.update(guidance_scale=flat[-3].to(dtype), guidance_rescale=flat[-2].to(dtype),
                           one_minus_rescale=flat[-1])
        if inpaint is not None:
            statics.update(init_latent=inpaint.init_latent, blend_noise=inpaint.noise,
                           latent_mask=inpaint.latent_mask)
            if decoder is not None:
                statics.update(image01=inpaint.image01, pixel_mask=inpaint.pixel_mask)
        t_embs = t_embs.to(dtype)
        fed = {"row": rows_dev[0], "t_emb": t_embs[:1]}
        if step_noise is not None:
            fed["z"] = step_noise[0]
        if mode == "dpm":
            fed["x0_prev"] = torch.zeros(latent0.shape, dtype=wide, device=device)
        flags = _Flags(mode, bool(v_prediction), use_cfg, "ctx_pair" in statics, inpaint is not None,
                       row_keys)
        buffers = {**statics, **fed}
        steps = (statics, rows_dev, t_embs, step_noise, trace_latents, callback)
        if programs is None:
            return _Program(flags, buffers, unet, decoder, controlnet, capture=False).run(*steps, None)
        key = program_key(flags, buffers, (unet, decoder, controlnet))
        with programs.lock:
            program = programs.get(key, lambda: _Program(flags, buffers, unet, decoder, controlnet,
                                                          capture=True))
            return program.run(*steps, programs)


# ---- the program -------------------------------------------------------------------


def _counts() -> list:
    return [getattr(fn, name) for fn, name in COUNTERS]


def _set_counts(values) -> None:
    for (fn, name), v in zip(COUNTERS, values):
        setattr(fn, name, v)


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; bound for the card through pinned memory without
    waiting, as a pageable copy would wait for every queued kernel."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _weights_key(module) -> Optional[tuple]:
    """The module's identity and the addresses of its parameters and buffers: a
    graph replays the addresses it captured, so a module whose tensors were
    replaced gives another key."""
    if module is None:
        return None
    return (id(module), tuple(t.data_ptr() for m in module.modules()
                              for t in itertools.chain(m._parameters.values(),
                                                       m._buffers.values())
                              if t is not None))


class _Flags(NamedTuple):
    """The static structure of the step body (the buffers' names, in the key
    too, say whether a ControlNet's hint and step noise are read)."""
    mode: str
    v_prediction: bool
    use_cfg: bool
    cfg_batched: bool
    use_inpaint: bool
    row_keys: tuple


def program_key(flags: _Flags, statics: Mapping[str, torch.Tensor], modules) -> tuple:
    """Everything that fixes a program's captured work (see the module's doc)."""
    cuda = torch.backends.cuda.matmul
    return (flags,
            tuple((name, tuple(_base(t).shape), tuple(t.shape), t.dtype, str(t.device))
                  for name, t in statics.items()),
            attention_ops.route_key(),
            (cuda.allow_tf32, cuda.allow_bf16_reduced_precision_reduction,
             torch.backends.cudnn.allow_tf32, torch.backends.cudnn.enabled),
            tuple(_weights_key(m) for m in modules))


def _base(t: torch.Tensor) -> torch.Tensor:
    """The tensor a static buffer holds for ``t``: a batch broadcast from one row
    keeps that one row."""
    if t.dim() and t.shape[0] > 1 and t.stride(0) == 0:
        return t[:1]
    return t


class _Program:
    """One signature's static buffers, its step body and its decode, and with
    ``capture`` on the card their CUDA graphs, captured at the first use."""

    def __init__(self, flags: _Flags, statics: Dict[str, torch.Tensor], unet, decoder,
                 controlnet, capture: bool):
        self.flags = flags
        self.capture = capture and statics["latent"].device.type == "cuda"
        self.unet, self.decoder, self.controlnet = unet, decoder, controlnet  # held alive
        self.bufs = {name: torch.empty_like(_base(t)) for name, t in statics.items()}
        # what the body reads: a broadcast batch stays broadcast
        self.views = {name: self.bufs[name].expand(t.shape) for name, t in statics.items()}
        self.step_graph = self.decode_graph = None
        self.step_counts = self.decode_counts = None
        self.image = None  # the decode graph's output
        self.capture_s = 0.0
        self.replays = 0

    def run(self, statics, rows, t_embs, step_noise, trace_latents, callback, cache):
        """The image, the latent and the trajectory of one call: ``statics`` into
        the buffers, then each step's row, embedding and noise and a step, then the
        decode; the outputs are copies of the buffers'."""
        for name, t in statics.items():
            self.bufs[name].copy_(_base(t))
        if "x0_prev" in self.bufs:
            self.bufs["x0_prev"].zero_()
        latent = self.views["latent"]
        n_steps = rows.shape[0]
        trajectory = (torch.empty((n_steps, *latent.shape), dtype=rows.dtype, device=latent.device)
                      if trace_latents else None)
        for i in range(n_steps):
            self.bufs["row"].copy_(rows[i])
            self.bufs["t_emb"].copy_(t_embs[i:i + 1])
            if step_noise is not None:
                self.bufs["z"].copy_(step_noise[i])
            self.step(cache)
            if trajectory is not None:
                trajectory[i].copy_(latent)
            if callback is not None:
                callback(i + 1)
        image = None if self.decoder is None else self.decoded(cache)
        return (image, latent.clone(), *((trajectory,) if trace_latents else ()))

    # ---- the work the graphs hold ----

    def _one_pass(self, lat, t_emb, ctx, hint_in):
        controls = None if self.controlnet is None else self.controlnet(lat, t_emb, ctx, hint_in)
        return self.unet(lat, t_emb, ctx, controls)

    def body(self) -> None:
        """One step on the static buffers: the latent (and DPM's x0) in place."""
        f, v = self.flags, self.views
        latent = v["latent"]
        wide = stats_dtype(latent.dtype)
        batch = latent.shape[0]
        t_emb = v["t_emb"]
        if not f.use_cfg:
            out = self._one_pass(latent, t_emb.expand(batch, -1), v["context"], v.get("hint"))
        else:
            if f.cfg_batched:
                pair = self._one_pass(torch.cat([latent, latent]), t_emb.expand(2 * batch, -1),
                                      v["ctx_pair"], v.get("hint_pair"))
                uncond, cond = pair.chunk(2)
            else:
                uncond = self._one_pass(latent, t_emb.expand(batch, -1), v["uncond_context"],
                                        v.get("hint"))
                cond = self._one_pass(latent, t_emb.expand(batch, -1), v["context"],
                                      v.get("hint"))
            merged = uncond + v["guidance_scale"] * (cond - uncond)
            out = rescale_noise_cfg(merged, cond, v["guidance_rescale"], v["one_minus_rescale"])
        out = out.to(wide)
        lat32 = latent.to(wide)
        r = dict(zip(f.row_keys, v["row"].unbind()))
        if f.v_prediction:
            # v = sr*eps - nr*x0  =>  x0 = sr*x - nr*v, eps = nr*x + sr*v
            x0 = r["sr_t"] * lat32 - r["nr_t"] * out
            eps = r["nr_t"] * lat32 + r["sr_t"] * out
        else:
            eps = out
            x0 = (lat32 - r["nr_t"] * eps) / r["sr_t"]
        last = r["is_last"] > 0
        z = v.get("z")
        if f.mode == "dpm":
            # the 2M combine with the x0 of the step before, taken before the
            # inpaint blend; w = 0 on the first and last steps
            d = (1.0 + r["w"]) * x0 - r["w"] * v["x0_prev"]
            new = r["c_x"] * lat32 + r["c_d"] * d
            v["x0_prev"].copy_(x0)
        elif f.mode == "lcm":
            denoised = r["c_out"] * x0 + r["c_skip"] * lat32
            new = torch.where(last, denoised, r["sr_prev"] * denoised + r["nr_prev"] * z)
        elif f.mode == "euler_a":
            new = torch.where(last, x0, r["c_x"] * lat32 + r["c_d"] * eps + r["c_noise"] * z)
        elif f.mode == "tcd":
            denoised = r["sr_s"] * x0 + r["nr_s"] * eps
            new = denoised if z is None else torch.where(
                last, denoised, r["c_denoised"] * denoised + r["c_noise"] * z)
        else:
            new = torch.where(last, x0, r["sr_prev"] * x0 + r["nr_prev"] * eps)
        if f.use_inpaint:
            # the reference latent noised to the *current* t with the same noise
            # every step, blended in the update's dtype before the cast
            origin = r["sr_t"] * v["init_latent"] + r["nr_t"] * v["blend_noise"]
            m = v["latent_mask"]
            new = origin * (1.0 - m) + new * m
        latent.copy_(new)

    def decode(self) -> torch.Tensor:
        v = self.views
        return _decode_image(self.decoder, v["latent"], v.get("image01"), v.get("pixel_mask"))

    # ---- running it ----

    def step(self, cache: Optional["ProgramCache"]) -> None:
        if not self.capture:
            self.body()
        elif self.step_graph is None:
            cache.warm(self.body)
            self.step_graph, self.step_counts, _ = self._capture(cache, self.body)
        else:
            self._replay(self.step_graph, self.step_counts)

    def decoded(self, cache: Optional["ProgramCache"]) -> torch.Tensor:
        """The image of the latent in the buffer, as a tensor of its own."""
        if not self.capture:
            return self.decode()
        if self.decode_graph is None:
            image = cache.warm(self.decode)
            image.record_stream(torch.cuda.current_stream())
            self.decode_graph, self.decode_counts, self.image = self._capture(cache, self.decode)
            return image
        self._replay(self.decode_graph, self.decode_counts)
        return self.image.clone()

    def _capture(self, cache: "ProgramCache", fn):
        try:
            graph, counts, out, seconds = cache.capture_graph(fn)
        except BaseException:
            cache.drop(self)  # a program whose capture failed is not kept
            raise
        self.capture_s += seconds
        return graph, counts, out

    def _replay(self, graph, counts) -> None:
        graph.replay()
        _set_counts(a + b for a, b in zip(_counts(), counts))
        self.replays += 1


class ProgramCache:
    """The programs of one caller, keyed by :func:`program_key`, at most ``size``,
    the least recently used out first, sharing one memory pool. ``lock`` is held
    while an image runs on one of them."""

    def __init__(self, size: int = MAX_PROGRAMS):
        self.size = int(size)
        self.programs: "collections.OrderedDict[tuple, _Program]" = collections.OrderedDict()
        self.builds = 0  # programs made
        self.lock = threading.Lock()
        self._pool = None
        self._stream = None

    def clear(self) -> None:
        """Drops every program (their graphs, buffers and pool go with the last),
        after the image that runs, if one does."""
        with self.lock:
            self.programs.clear()
            self._pool = None

    def get(self, key: tuple, make: Callable[[], _Program]) -> _Program:
        program = self.programs.pop(key, None)
        if program is None:
            while len(self.programs) >= self.size:
                self.programs.popitem(last=False)
            program = make()
            self.builds += 1
        self.programs[key] = program
        return program

    def drop(self, program: _Program) -> None:
        for key in [k for k, held in self.programs.items() if held is program]:
            del self.programs[key]

    def _capture_stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        return self._stream

    def warm(self, fn):
        """``fn()`` eagerly on the capture stream, ordered after the current
        stream's work and before its later work."""
        current, stream = torch.cuda.current_stream(), self._capture_stream()
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            out = fn()
        current.wait_stream(stream)
        return out

    def capture_graph(self, fn):
        """``(graph, counter changes, fn's output, seconds)`` of ``fn`` captured
        into this cache's pool, in the span ``program.capture``; the counters read
        as they did before."""
        with profiling.span("program.capture"):
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            pool = self._pool
            graph = torch.cuda.CUDAGraph()
            before = _counts()
            t0 = time.perf_counter()
            torch.cuda.synchronize()
            try:
                with torch.cuda.stream(self._capture_stream()):
                    graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                    try:
                        out = fn()
                    finally:
                        try:
                            graph.capture_end()
                        except BaseException:
                            # PyTorch's capture_end raises before it stops the allocator
                            # recording into the pool: stop it and give back the
                            # capture's hold on the pool, as cudagraph_trees does; the
                            # pool may be gone then, so later captures take a new one
                            device = torch.cuda.current_device()
                            torch._C._cuda_endAllocateToPool(device, pool)
                            torch._C._cuda_releasePool(device, pool)
                            self._pool = None
                            raise
                changes = [a - b for a, b in zip(_counts(), before)]
            finally:
                _set_counts(before)
            return graph, changes, out, time.perf_counter() - t0

    def pool_bytes(self) -> Optional[int]:
        """The bytes of device memory the pool holds (None before a capture)."""
        if self._pool is None:
            return None
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s["segment_pool_id"]) == tuple(self._pool))

    def stats(self) -> dict:
        """Programs held and made, the pool's bytes, and each program's capture
        seconds and replays (in the cache's order, oldest first)."""
        return {"programs": len(self.programs), "builds": self.builds,
                "pool_bytes": self.pool_bytes(),
                "each": [{"capture_s": p.capture_s, "replays": p.replays}
                         for p in self.programs.values()]}
