"""The public StableDiffusion pipeline: txt2img, img2img, inpaint and ControlNet
with classifier-free guidance, on the card.

``StableDiffusion(...).text_to_image(prompt, ...)`` tokenizes and parses the prompt
on the host, encodes it with the CLIP text stack (the unconditional row rides in
the first encode and is cached), draws the initial noise with the TF-Philox
generator (the same seed gives the same noise as the JAX package and the
reference), runs the step loop (:mod:`minsdtf_tpu_torch.sampler`) and decodes.
``scheduler_type`` picks the sampler: "ddim" (the default; "euler" is the same
update), "tcd" (or ``active_tcd=True``), "lcm", "dpm", "dpm_karras" or
"euler_a"; ``prediction_type="v"`` takes a v-predicting UNet. The stochastic
samplers' per-step noise is drawn on the host before the loop
(:func:`draw_step_noise`), so a seed gives the same image on the card and on the
CPU. A textual-inversion ``embedding`` (a ``.pt`` or ``.safetensors`` path, an
array, or a list of them) is spliced in front of the prompt's tokens, and a
``negative_embedding`` in front of the negative prompt's.
``image_to_image`` encodes the reference image with the VAE encoder and starts
from it noised to the truncated schedule's first t; ``inpaint`` also blends the
reference back outside the mask, in the latent each step and in the image at the
end. ``control_net_image`` runs the ControlNet before each UNet call. Images and
masks are numpy arrays (a path string needs PIL). ``generate_images`` queues
several requests before it fetches any (``_defer_fetch``, :func:`fetch`); prompt
contexts and schedules are cached per pipeline. While a ``torch.profiler``
profile runs, the host's work records spans (:mod:`profiling`): ``encode`` and
``encode.clip``, ``prep.noise``, ``prep.schedule``, ``prep.reference``,
``prep.upload``, ``prep.hint``, the sampler's ``program.run`` and ``fetch``.

Weights: ``unet_ckpt``, ``text_encoder_ckpt``, ``vae_ckpt`` and ``controlnet_path``
take a checkpoint file (LDM single-file or diffusers layout, ``.safetensors`` or a
torch pickle; lllyasviel's ``control_model.*`` ``.pth`` for the ControlNet), a URL
or ``"default"`` (:mod:`weights.fetch`). Each converts once into a cache beside the
file (:func:`weights.convert.convert_cached`). ``lora_path`` merges a kohya LoRA
into the UNet and the text encoder, and :meth:`StableDiffusion.set_lora` switches
it at run time. Without a checkpoint a module is random, made on the target
device from a fixed seed; without ``controlnet_path`` a ControlNet may be assigned
to ``_controlnet``. Two differences from the JAX pipeline change what raises and
never a result: a ``lora_path`` that does not exist raises ``FileNotFoundError``,
and a LoRA whose deltas reach a module without a checkpoint raises
``ValueError``. ``compute_dtype`` is bf16 on CUDA unless fp32 is asked for.

``weight_dtype="int8"`` makes every eligible UNet and ControlNet conv and dense
site W8A8 (:mod:`weights.quantize`), with dynamic activation scales or, from
``int8_act_scales`` (a dict or an ``.npz`` path) or :meth:`calibrate_int8`,
calibrated static ones (:mod:`weights.calibrate`); ``"int8_hybrid"`` makes only
the calibration-stable conv sites int8, equalized and bias-corrected, and needs
the scales. The weights are quantized from fp32, after the LoRA merge and the
projections' fusion and before the cast; the text encoder and the VAE stay in
the compute dtype.

``mesh`` (a ``(data, model)`` mesh, :mod:`parallel.mesh`) runs the pipeline as one
rank of an SPMD world: every rank makes the same calls. The UNet, ControlNet and
CLIP are Megatron-sharded over the model axis (:func:`parallel.sharding.shard_module`;
the projections are not fused under a mesh, as in the JAX pipeline), the batch is
split over the data axis: every rank builds the whole batch's host inputs from the
seed (noise, step noise, contexts, inpaint and control inputs), runs the sampler on
its rows, and the images and latents are all-gathered, so every rank returns what
one device would. Where the data axis does not divide ``batch_size``, every data
rank runs the whole batch and nothing is gathered, as the JAX pipeline's
replicated batch does. ``sequence_parallel=True`` keeps the weights whole and
runs spatial sequence parallelism over the model axis
(:func:`ops.attention.sequence_parallel_scope`, entered per generation call and
per encode): every UNet, ControlNet and VAE level of ``MINSDTF_SP_MIN_SEQ``
tokens or more (read at construction, default 16384: the 1024px latent) stays
H-sharded (:mod:`parallel.spatial`), with its self-attentions on the ring.
``weight_dtype`` and ``mesh`` together raise ``ValueError``, as in the JAX pipeline.

On the card the step loop runs as captured programs (:mod:`sampler`), held in
``_programs``, one for each static signature (batch, context lengths, mode, flags,
modules): a signature's first image captures it, later images replay it. Replacing
a module (:meth:`set_lora`, :meth:`calibrate_int8`, a lazy load after either)
empties the cache, since a graph replays the weights it captured. Under ``mesh`` or
``sequence_parallel`` the sampler runs its step loop (``sampler._generate_eager``):
gloo stages each collective through host memory, which a graph cannot hold. That
route is the configuration's, not a fallback.

The reference-compatible handles (``diffusion_model``, ``text_clip_embedding``,
``text_encoder``, ``image_encoder``, ``image_decoder``, ``hint_net``,
``control_net``) take and return numpy arrays in the JAX package's layouts (NHWC
latents, images, hints and ControlNet residuals) through ``predict_on_batch`` or a
call, and run on the pipeline's device.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import os
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from minsdtf_tpu_torch import imaging, profiling
from minsdtf_tpu_torch import rng as rng_lib
from minsdtf_tpu_torch import sampler
from minsdtf_tpu_torch import scheduler as sched_lib
from minsdtf_tpu_torch.models import clip as clip_lib
from minsdtf_tpu_torch.models import controlnet as controlnet_lib
from minsdtf_tpu_torch.models import unet as unet_lib
from minsdtf_tpu_torch.models import vae as vae_lib
from minsdtf_tpu_torch.models.common import build, cast_weights_
from minsdtf_tpu_torch.ops import attention as attention_ops
from minsdtf_tpu_torch.parallel import sharding
from minsdtf_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_size
from minsdtf_tpu_torch.text import prompt_weighting as lpw
from minsdtf_tpu_torch.text.tokenizer import ClipTokenizer
from minsdtf_tpu_torch.weights import calibrate, convert, quantize, textual_inversion
from minsdtf_tpu_torch.weights import fetch as fetch_lib
from minsdtf_tpu_torch.weights import lora as lora_lib

MAX_PROMPT_LENGTH = 77
PAD_TOKEN_ID = 49407
PROMPT_CACHE_SIZE = 8
SCHEDULE_CACHE_SIZE = 16
WEIGHT_DTYPES = (None, "int8", "int8_hybrid")


def _env_float(name: str, default: str) -> Optional[float]:
    """The environment variable ``name`` (else ``default``) as a float; "none"
    gives None."""
    value = os.environ.get(name, default)
    return None if value.lower() == "none" else float(value)


def draw_step_noise(seed: int, shape: Sequence[int]) -> torch.Tensor:
    """The stochastic samplers' per-step noise z, (n, B, h, w, 4) fp32 on the CPU,
    from a CPU generator seeded with ``seed``: the same on every device."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32)


def to_device(a, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``a`` (numpy, a number or a tensor) as a tensor on ``device``. A host array
    bound for the card is staged in pinned memory and copied without waiting: a
    copy from pageable memory waits for every kernel queued before it, which would
    hold the host until the card is idle."""
    t = torch.as_tensor(a, dtype=dtype)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def fetch(handle) -> np.ndarray:
    """A result of ``generate_image(..., _defer_fetch=True)`` as numpy: a tensor is
    copied to the host, which waits for every kernel queued on the card's stream
    before the copy; anything else goes through ``np.asarray``."""
    with profiling.span("fetch"):
        if isinstance(handle, torch.Tensor):
            return handle.cpu().numpy()
        return np.asarray(handle)


def _existing(path, kind: str) -> str:
    """``path`` as a string; ``FileNotFoundError`` where no file is there."""
    if not os.path.exists(str(path)):
        raise FileNotFoundError(f"{kind}: no such file: {path}")
    return str(path)


def resolve_device(device) -> torch.device:
    """``None`` means CUDA; raise rather than fall back to the CPU quietly."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device


class StableDiffusion:
    """Stable Diffusion 1.5 txt2img / img2img / inpaint / ControlNet with CFG, on
    any of the JAX package's schedulers, in PyTorch."""

    def __init__(
        self,
        img_height: int = 512,
        img_width: int = 512,
        jit_compile: bool = True,  # accepted for parity with the JAX pipeline; no effect
        clip_skip: int = -1,
        unet_ckpt: Optional[str] = None,
        text_encoder_ckpt: Optional[str] = None,
        vae_ckpt: Optional[str] = None,
        lora_path: Optional[str] = None,
        controlnet_path: Optional[str] = None,
        active_tcd: bool = False,
        bpe_path: Optional[str] = None,
        compute_dtype: Optional[torch.dtype] = None,
        device=None,
        scheduler_type: Optional[str] = None,
        prediction_type: str = "epsilon",
        weight_dtype: Optional[str] = None,
        int8_act_scales=None,
        mesh=None,
        sequence_parallel: bool = False,
    ):
        self.img_height = int(img_height)
        self.img_width = int(img_width)
        for name, v in (("img_height", self.img_height), ("img_width", self.img_width)):
            if v <= 0 or v % 64:
                raise ValueError(
                    f"{name}={v} is not a positive multiple of 64; the UNet's "
                    "downsampling stack requires image sides divisible by 64")
        self.clip_skip = int(clip_skip)
        if prediction_type not in ("epsilon", "v"):
            raise ValueError(
                f"prediction_type must be 'epsilon' or 'v', got {prediction_type!r}")
        self.prediction_type = prediction_type
        if weight_dtype not in WEIGHT_DTYPES:
            raise ValueError(
                f"weight_dtype must be None, 'int8' or 'int8_hybrid', got {weight_dtype!r}")
        if weight_dtype is not None and mesh is not None:
            raise ValueError(
                "weight_dtype='int8' is single-device only for now (the TP sharding "
                "rules operate on float kernels)")
        self.weight_dtype = weight_dtype
        self.mesh = mesh
        self.sequence_parallel = bool(sequence_parallel) and mesh is not None
        self._sp_min_seq = int(os.environ.get("MINSDTF_SP_MIN_SEQ", 16384))
        if isinstance(int8_act_scales, (str, os.PathLike)):
            int8_act_scales = calibrate.load_scales(str(int8_act_scales))
        self._int8_act_scales = int8_act_scales
        # the int8_hybrid settings, read once here under the JAX package's names
        # and defaults, so that a later calibrate_int8 builds what the
        # constructor would
        self._hybrid_dense = os.environ.get("MINSDTF_HYBRID_DENSE", "0") == "1"
        self._hybrid_cfg = {
            "equalize_alpha": _env_float("MINSDTF_HYBRID_ALPHA", "0.5"),
            "clip_sigmas": _env_float("MINSDTF_HYBRID_CLIP", "none"),
            "bias_correct": os.environ.get("MINSDTF_HYBRID_BIASCORR", "1") == "1",
            "max_site_rel_mse": _env_float("MINSDTF_HYBRID_MAX_ERR", "none"),
        }
        self.device = resolve_device(device)
        if compute_dtype is None:
            compute_dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.compute_dtype = compute_dtype
        self.bpe_path = bpe_path
        self.scheduler = sched_lib.make_scheduler(scheduler_type, active_tcd)
        self.scheduler_type = scheduler_type or ("tcd" if active_tcd else "ddim")
        self.active_tcd = self.scheduler.active_tcd
        self.unet_ckpt = unet_ckpt
        self.text_encoder_ckpt = text_encoder_ckpt
        self.vae_ckpt = vae_ckpt
        self.controlnet_path = controlnet_path
        self.text_encoder_lora = None
        self.unet_lora = None
        self._unet = None
        self._text_model = None
        self._decoder = None
        self._encoder = None
        self._controlnet = None
        self._tokenizer = None
        self._uncond = None
        # (prompt, unconditional row encoded yet?) -> context on the device, up to
        # PROMPT_CACHE_SIZE entries, oldest out first
        self._prompt_cache = {}
        # (num_steps, strength, eta) -> (DenoiseSchedule, t_embs on the device)
        self._schedule_cache = {}
        self._programs = sampler.ProgramCache()  # the card's captured step loops
        if lora_path is not None:
            self.set_lora(lora_path)

    def set_lora(self, lora_path: Optional[str], scale: float = 1.0) -> None:
        """Switch the active LoRA at run time: the UNet, the text encoder, the
        cached unconditional context and the prompt cache are dropped, and the next
        use re-derives them from the cached base checkpoints with the new deltas,
        times ``scale``, merged. ``None`` removes the LoRA."""
        te = unet = None
        if lora_path is not None:
            te, unet = lora_lib.load_lora(_existing(lora_path, "lora"))
            te, unet = lora_lib.scale_lora(te, scale), lora_lib.scale_lora(unet, scale)
            for deltas, ckpt, kind in ((te, self.text_encoder_ckpt, "text_encoder"),
                                       (unet, self.unet_ckpt, "unet")):
                if deltas and ckpt is None:
                    raise ValueError(f"the LoRA has {len(deltas)} {kind} deltas but there is "
                                     f"no {kind} checkpoint to merge them into")
        self.text_encoder_lora, self.unet_lora = te or None, unet or None  # {} merges nothing
        self._unet = None
        self._programs.clear()
        self._text_model = None
        self._uncond = None
        self._prompt_cache.clear()

    # ---- lazy models ------------------------------------------------------------

    def _checkpoint(self, path, kind: str, lora=None):
        """The converted fp32 ``state_dict`` (a pair for the VAE) of the checkpoint
        at ``path`` with ``lora`` merged; a URL or "default" is fetched first."""
        if not os.path.exists(str(path)):
            try:
                path = fetch_lib.resolve(path, kind)
            except Exception as e:
                raise FileNotFoundError(f"{kind}: cannot fetch {path}: {e}") from e
        return convert.convert_cached(kind, _existing(path, kind), lora=lora)

    def _load_or_init(self, path, kind: str, factory: Callable[[], nn.Module], seed: int,
                      lora=None, part: Optional[int] = None, fuse: bool = False,
                      quantize_fn: Optional[Callable[[nn.Module], nn.Module]] = None
                      ) -> nn.Module:
        """``factory()`` on the device, in eval mode, holding the weights of the
        checkpoint at ``path`` (``part`` of the VAE's pair, ``lora`` merged), or
        without a path random ones from ``seed`` (:func:`models.common.build`):
        fp32 first, then the attention projections fused when ``fuse``, then
        ``quantize_fn`` (int8 sites from the fp32 weights), then cast to the
        compute dtype."""
        if path is None:
            model = build(factory, self.device, seed)
        else:
            state = self._checkpoint(path, kind, lora)
            with torch.device("meta"):
                model = factory()
            model.load_state_dict(state if part is None else state[part], assign=True)
            model = model.to(self.device)
        if fuse:
            model = unet_lib.fuse_attention_projections(model)
        if quantize_fn is not None:
            model = quantize_fn(model)
        return cast_weights_(model, self.compute_dtype).eval()

    def _quantize_unet(self, model: nn.Module) -> nn.Module:
        """The fp32 UNet made int8 as ``weight_dtype`` says: every eligible site
        ("int8", with the constructor's scales baked), or the stable conv sites
        ("int8_hybrid" with scales; the dense sites too, dynamic, with
        ``MINSDTF_HYBRID_DENSE=1``; without either the UNet stays float until
        :meth:`calibrate_int8`)."""
        if self.weight_dtype == "int8":
            model = quantize.quantize_params(model)
            if self._int8_act_scales:
                model = calibrate.bake_act_scales(model, self._int8_act_scales)
        elif self.weight_dtype == "int8_hybrid" and (self._int8_act_scales or self._hybrid_dense):
            model = quantize.hybridize_params(model, self._int8_act_scales or {},
                                              dense_dynamic=self._hybrid_dense,
                                              **self._hybrid_cfg)
        return model

    def _placed(self, attr: str) -> Optional[nn.Module]:
        """The module held in ``attr``, placed on the mesh at its first use: sharded
        over the model axis, or whole under sequence parallelism (every rank's
        weights checked equal either way). Without a mesh, as it is. A module
        assigned to ``attr`` is placed the same way, and a whole module placed by
        another pipeline is placed again for this one."""
        model = getattr(self, attr)
        if model is None or self.mesh is None:
            return model
        want = 1 if self.sequence_parallel else axis_size(self.mesh, MODEL_AXIS)
        if getattr(model, "placed_over", None) == want:
            return model
        if want == 1:
            sharding.replicate_module(model, self.mesh)
        else:
            sharding.shard_module(model, self.mesh)
        model.placed_over = want  # the model axis it was placed over
        return model

    @property
    def unet(self) -> unet_lib.UNet:
        if self._unet is None:
            self._programs.clear()
            self._unet = self._load_or_init(self.unet_ckpt, "unet", unet_lib.UNet, 0,
                                            lora=self.unet_lora, fuse=self.mesh is None,
                                            quantize_fn=self._quantize_unet)
        return self._placed("_unet")

    @property
    def text_model(self) -> clip_lib.CLIPTextModel:
        if self._text_model is None:
            self._text_model = self._load_or_init(self.text_encoder_ckpt, "text_encoder",
                                                  clip_lib.CLIPTextModel, 1,
                                                  lora=self.text_encoder_lora)
        return self._placed("_text_model")

    @property
    def decoder(self) -> vae_lib.VAEDecoder:
        if self._decoder is None:
            self._programs.clear()
            self._decoder = self._load_or_init(self.vae_ckpt, "vae", vae_lib.VAEDecoder, 2, part=1)
        return self._placed("_decoder")

    @property
    def encoder(self) -> vae_lib.VAEEncoder:
        if self._encoder is None:
            self._encoder = self._load_or_init(self.vae_ckpt, "vae", vae_lib.VAEEncoder, 4, part=0)
        return self._placed("_encoder")

    @property
    def controlnet(self) -> Optional[controlnet_lib.ControlNet]:
        """The ControlNet of ``controlnet_path`` (fused and cast as the UNet is, and
        under ``weight_dtype="int8"`` made int8 at every eligible site), or the one
        assigned to ``_controlnet``, or None."""
        if self._controlnet is None and self.controlnet_path is not None:
            self._programs.clear()
            self._controlnet = self._load_or_init(
                self.controlnet_path, "controlnet", controlnet_lib.ControlNet, 3,
                fuse=self.mesh is None,
                quantize_fn=quantize.quantize_params if self.weight_dtype == "int8" else None)
        return self._placed("_controlnet")

    @property
    def tokenizer(self) -> ClipTokenizer:
        if self._tokenizer is None:
            if not self.bpe_path:
                raise ValueError("bpe_path is required (CLIP merges file, e.g. "
                                 "bpe_simple_vocab_16e6.txt.gz)")
            self._tokenizer = ClipTokenizer(self.bpe_path)
        return self._tokenizer

    # ---- text encoding ----------------------------------------------------------

    def _encode_text_dev(self, prompt: Union[str, List[str]], embedding_data=None) -> torch.Tensor:
        """Prompt -> (B, 77*m, 768) fp32 context on the device, via A1111 LPW, with
        the textual-inversion vectors of ``embedding_data`` spliced in front.
        Without ``embedding_data`` the context is cached under the prompt and
        whether the unconditional row had been encoded yet: the first encode
        carries that row as one more batch row, which on the card changes the
        context's last bits. The cached tensor is returned as it is; no caller
        writes into it. Its span ``encode`` counts the context's 77-token chunks
        (0 for a cache hit)."""
        with profiling.span("encode", n=0) as sp:
            key = None
            if embedding_data is None:
                key = (prompt if isinstance(prompt, str) else tuple(prompt), self._uncond is not None)
                hit = self._prompt_cache.get(key)
                if hit is not None:
                    return hit
            embedding = textual_inversion.embedding_matrix(embedding_data)
            context = lpw.get_weighted_text_embeddings(
                self.tokenizer, self._fused_text_call, prompt,
                model_max_length=MAX_PROMPT_LENGTH, pad_token_id=PAD_TOKEN_ID,
                embedding=None if embedding is None else embedding[None],
                embedding_tokens_count=0 if embedding is None else embedding.shape[0])
            sp.n = context.shape[1] // MAX_PROMPT_LENGTH
            if key is not None:
                if len(self._prompt_cache) >= PROMPT_CACHE_SIZE:
                    self._prompt_cache.pop(next(iter(self._prompt_cache)))
                self._prompt_cache[key] = context
            return context

    @torch.inference_mode()
    def _fused_text_call(self, token_array, weight_array, embedding, splice_n,
                         no_boseos_middle):
        """LPW ``fused_fn`` hook -> :func:`clip.fused_lpw_encode`. While the
        unconditional context is unset it is encoded as one more batch row."""
        want_uncond = self._uncond is None
        tok = self.tokenizer
        with profiling.span("encode.clip"):
            context, uncond = clip_lib.fused_lpw_encode(
                self.text_model,
                to_device(token_array, self.device, torch.long),
                None if weight_array is None else to_device(weight_array, self.device),
                None if embedding is None else to_device(embedding, self.device),
                m=(token_array.shape[1] - 2) // (MAX_PROMPT_LENGTH - 2),
                splice_n=int(splice_n),
                with_uncond=want_uncond,
                no_boseos_middle=bool(no_boseos_middle),
                clip_skip=self.clip_skip,
                bos=int(tok.start_of_text),
                eot=int(tok.end_of_text),
            )
        if want_uncond:
            self._uncond = uncond
        return context

    def encode_text(self, prompt: Union[str, List[str]], embedding_data=None) -> np.ndarray:
        """Prompt -> (B, 77*m, 768) fp32 context via A1111 LPW. ``embedding_data``:
        a textual-inversion file (``.pt`` or ``.safetensors``), an (n, 768) array,
        or a list of them, concatenated along the token axis. The array is a copy:
        writing into it leaves the prompt cache as it was."""
        return self._encode_text_dev(prompt, embedding_data).to("cpu", copy=True).numpy()

    def warm_text(self) -> None:
        """Encode a one-chunk prompt with the unconditional row and then without it
        (where the row is unset yet), emptying the prompt cache after each: a
        serving daemon's first fresh prompt then finds CLIP's weights loaded and
        its kernels loaded and chosen."""
        self._encode_text_dev("warmup prompt")
        self._prompt_cache.clear()
        self._encode_text_dev("warmup prompt")
        self._prompt_cache.clear()

    @torch.inference_mode()
    def _unconditional_context(self) -> torch.Tensor:
        """[BOS] + [EOT]*76 through embed + encode, bypassing LPW; cached."""
        if self._uncond is None:
            with profiling.span("encode.clip"):
                tokens = to_device(clip_lib.uncond_tokens(), self.device)
                self._uncond = clip_lib.encode_tokens(self.text_model, tokens, self.clip_skip)
        return self._uncond

    def _device_schedule(self, num_steps: int, strength: Optional[float], eta: float):
        """``(DenoiseSchedule, t_embs (n, 320) fp32 on the device)`` for the
        pipeline's scheduler, cached under ``(num_steps, strength, eta)``, up to
        SCHEDULE_CACHE_SIZE entries, oldest out first."""
        key = (int(num_steps), None if strength is None else round(float(strength), 6),
               round(float(eta), 6))
        hit = self._schedule_cache.get(key)
        if hit is None:
            schedule = sched_lib.build_denoise_schedule(self.scheduler, num_steps,
                                                        strength=strength, eta=eta)
            t_embs = to_device(sched_lib.timestep_embedding(schedule.timesteps), self.device)
            if len(self._schedule_cache) >= SCHEDULE_CACHE_SIZE:
                self._schedule_cache.pop(next(iter(self._schedule_cache)))
            hit = self._schedule_cache[key] = (schedule, t_embs)
        return hit

    # ---- generation -------------------------------------------------------------

    def _sp_scope(self):
        """Sequence parallelism over the model axis for the body of a ``with``
        block, when the pipeline runs it; else nothing."""
        if not self.sequence_parallel:
            return contextlib.nullcontext()
        return attention_ops.sequence_parallel_scope(self.mesh, MODEL_AXIS, self._sp_min_seq)

    def _splits_batch(self, batch: int) -> bool:
        """Whether the mesh's data axis splits a batch of ``batch``: it has more
        than one rank and divides ``batch``. Otherwise every data rank runs the
        whole batch, as the JAX pipeline's replicated batch does."""
        n = 1 if self.mesh is None else axis_size(self.mesh, DATA_AXIS)
        return n > 1 and batch % n == 0

    def _data_rows(self, batch: int) -> Callable:
        """``rows(t, dim=0)``: this data rank's rows of ``t`` where its ``dim`` holds
        the whole batch of ``batch`` and the data axis splits it, else ``t``."""
        if not self._splits_batch(batch):
            return lambda t, dim=0: t
        return lambda t, dim=0: (t if t.shape[dim] != batch
                                 else sharding.shard_batch(t, self.mesh, dim))

    def text_to_image(
        self,
        prompt,
        negative_prompt=None,
        batch_size=1,
        num_steps=50,
        unconditional_guidance_scale=7.5,
        embedding=None,
        negative_embedding=None,
        seed=None,
        control_net_image=None,
        guidance_rescale=0.7,
        callback=None,
        return_latent=False,
    ):
        return self.generate_image(
            self._encode_text_dev(prompt, embedding),
            negative_prompt=negative_prompt,
            batch_size=batch_size,
            num_steps=num_steps,
            unconditional_guidance_scale=unconditional_guidance_scale,
            seed=seed,
            negative_embedding=negative_embedding,
            control_net_image=control_net_image,
            guidance_rescale=guidance_rescale,
            callback=callback,
            return_latent=return_latent,
        )

    def image_to_image(
        self,
        prompt,
        negative_prompt=None,
        batch_size=1,
        num_steps=50,
        unconditional_guidance_scale=7.5,
        embedding=None,
        negative_embedding=None,
        seed=None,
        control_net_image=None,
        reference_image=None,
        reference_image_strength=0.8,
        guidance_rescale=0.7,
        callback=None,
        return_latent=False,
    ):
        return self.generate_image(
            self._encode_text_dev(prompt, embedding),
            negative_prompt=negative_prompt,
            batch_size=batch_size,
            num_steps=num_steps,
            unconditional_guidance_scale=unconditional_guidance_scale,
            seed=seed,
            negative_embedding=negative_embedding,
            control_net_image=control_net_image,
            reference_image=reference_image,
            reference_image_strength=reference_image_strength,
            guidance_rescale=guidance_rescale,
            callback=callback,
            return_latent=return_latent,
        )

    def inpaint(
        self,
        prompt,
        negative_prompt=None,
        batch_size=1,
        num_steps=50,
        unconditional_guidance_scale=7.5,
        embedding=None,
        negative_embedding=None,
        seed=None,
        control_net_image=None,
        reference_image=None,
        reference_image_strength=0.8,
        inpaint_mask=None,
        mask_blur_strength=None,
        guidance_rescale=0.7,
        callback=None,
        return_latent=False,
    ):
        return self.generate_image(
            self._encode_text_dev(prompt, embedding),
            negative_prompt=negative_prompt,
            batch_size=batch_size,
            num_steps=num_steps,
            unconditional_guidance_scale=unconditional_guidance_scale,
            seed=seed,
            negative_embedding=negative_embedding,
            control_net_image=control_net_image,
            reference_image=reference_image,
            reference_image_strength=reference_image_strength,
            inpaint_mask=inpaint_mask,
            mask_blur_strength=mask_blur_strength,
            guidance_rescale=guidance_rescale,
            callback=callback,
            return_latent=return_latent,
        )

    def generate_image(
        self,
        encoded_text,
        negative_prompt=None,
        batch_size=1,
        num_steps=50,
        unconditional_guidance_scale=7.5,
        diffusion_noise=None,
        seed=None,
        negative_embedding=None,
        control_net_image=None,
        inpaint_mask=None,
        mask_blur_strength=None,
        reference_image=None,
        reference_image_strength=0.8,
        guidance_rescale=0.0,
        callback=None,
        eta=0.3,
        return_latent=False,
        return_trajectory=False,
        _defer_fetch=False,
    ):
        """``encoded_text``: a (S, 768) or (B, S, 768) context (numpy or tensor),
        broadcast over ``batch_size`` when its batch is 1. img2img runs only when
        ``0 < reference_image_strength < 1``; the inpaint blends only with img2img
        (an ``inpaint_mask`` alone gives txt2img). ``negative_embedding`` is encoded
        with ``negative_prompt or ""``. ``eta`` is TCD's gamma. Returns the uint8
        (B, H, W, 3) image as numpy, then the fp32 latent when ``return_latent``,
        then the fp32 (n, B, h, w, 4) latent after each step when
        ``return_trajectory``.

        With ``_defer_fetch`` the same results are returned as tensors on the
        device, and nothing waits for the card: the caller turns them into numpy
        with :func:`fetch`, so the host can queue the next request meanwhile
        (:meth:`generate_images`). img2img and inpaint still wait once, for the
        encoded reference latent (:meth:`_encode_image`).

        Under a mesh whose data axis of n divides ``batch_size``, each rank samples
        its rows and the results are gathered; otherwise each runs the whole batch."""
        if diffusion_noise is not None and seed is not None:
            raise ValueError("`diffusion_noise` and `seed` should not both be passed to "
                             "`generate_image`.")
        if control_net_image is not None and self.controlnet is None:
            raise ValueError("`control_net_image` needs a ControlNet; none is loaded")
        h8, w8 = self.img_height // 8, self.img_width // 8
        rows = self._data_rows(batch_size)
        with profiling.span("prep.upload"):
            context = to_device(encoded_text, self.device, torch.float32)
        if context.dim() == 2:
            context = context[None]
        uncond = None
        if unconditional_guidance_scale > 0.0:
            uncond = (self._unconditional_context()
                      if negative_prompt is None and negative_embedding is None
                      else self._encode_text_dev(negative_prompt or "", negative_embedding))

        with profiling.span("prep.noise", n=batch_size):
            if diffusion_noise is not None:
                noise = np.squeeze(np.asarray(diffusion_noise, np.float32))
                if noise.ndim == 3:
                    noise = np.repeat(noise[None], batch_size, axis=0)
            else:
                if seed is None:
                    seed = int(np.random.randint(0, 2**31 - 1))
                noise = rng_lib.stateless_normal((batch_size, h8, w8, 4), seed)
        # the stochastic samplers' step noise: from the seed, or from a fresh seed
        # when the caller gives the initial noise
        key_seed = seed if seed is not None else int(np.random.randint(0, 2**31 - 1))

        use_img2img = reference_image is not None and 0.0 < reference_image_strength < 1.0
        strength = float(reference_image_strength) if use_img2img else None
        with profiling.span("prep.schedule"):
            schedule, t_embs = self._device_schedule(num_steps, strength, eta)
        inpaint = None
        if use_img2img:
            with profiling.span("prep.reference", n=batch_size):
                image01, image_tensor = imaging.preprocess_image(
                    reference_image, self.img_height, self.img_width)
                init_latent = self._encode_image(image_tensor)
                # fp32 on the host, rounded as the JAX pipeline rounds it: the signal
                # term in float64, the noise term in fp32
                t0 = schedule.init_timestep
                latent0 = ((self.scheduler.signal_rates[t0]
                            * np.repeat(init_latent, batch_size, axis=0)).astype(np.float32)
                           + np.float32(self.scheduler.noise_rates[t0]) * noise)
                if inpaint_mask is not None:
                    pixel_mask, latent_mask = imaging.preprocess_mask(
                        inpaint_mask, self.img_height, self.img_width, mask_blur_strength)
                    inpaint = sampler.Inpaint(*(
                        rows(to_device(a, self.device))
                        for a in (init_latent, noise, latent_mask, image01, pixel_mask)))
        else:
            latent0 = noise
        with profiling.span("prep.upload"):
            latent0 = to_device(latent0, self.device).to(self.compute_dtype)

        hint = None
        if control_net_image is not None:
            with profiling.span("prep.hint", n=batch_size):
                arr = imaging.bilinear_resize(imaging.load_image(control_net_image, "RGB"),
                                              self.img_height, self.img_width)
                cn_img = np.tile((np.asarray(arr, np.float32) / 255.0)[None], (batch_size, 1, 1, 1))
                hint = rows(self._hint(cn_img))

        step_noise = None
        if schedule.mode in sampler.NOISY_MODES or (schedule.mode == "tcd" and eta > 0.0):
            with profiling.span("prep.noise", n=batch_size):
                step_noise = draw_step_noise(key_seed, (schedule.num_steps, *latent0.shape))
                step_noise = rows(to_device(step_noise, self.device), 1)
        # a mesh's collectives cannot be captured: it runs the step loop
        loop = (functools.partial(sampler.generate, programs=self._programs)
                if self.mesh is None else sampler._generate_eager)
        with self._sp_scope():
            image, latent, *trajectory = loop(
                self.unet, self.decoder, rows(latent0), rows(context),
                None if uncond is None else rows(uncond), t_embs, schedule.rows,
                unconditional_guidance_scale, guidance_rescale,
                controlnet=self.controlnet if hint is not None else None, hint=hint,
                inpaint=inpaint, callback=callback, mode=schedule.mode,
                step_noise=step_noise, v_prediction=self.prediction_type == "v",
                trace_latents=return_trajectory)
        if self._splits_batch(batch_size):
            image, latent = (sharding.gather_batch(t, self.mesh) for t in (image, latent))
            trajectory = [sharding.gather_batch(t, self.mesh, 1) for t in trajectory]
        out = [image]
        if return_latent:
            out.append(latent.float())
        if return_trajectory:
            out.append(trajectory[0])
        if not _defer_fetch:
            out = [fetch(t) for t in out]
        return out[0] if len(out) == 1 else tuple(out)

    def calibrate_int8(
        self,
        encoded_text=None,
        num_steps: int = 25,
        seeds=(0, 1),
        unconditional_guidance_scale: float = 7.5,
        guidance_rescale: float = 0.7,
        margin: float = 1.05,
        include_dense: bool = False,
        save_path: Optional[str] = None,
    ) -> dict:
        """Calibrate static int8 activation scales on real denoising trajectories
        (CFG, the rescale and DDIM from each seed's noise, with ``encoded_text``
        or the unconditional context as the prompt) and bake them into the live
        UNet (:mod:`weights.calibrate`). Returns the ``{site: statistics}`` dict;
        pass it, or ``save_path``, to ``StableDiffusion(int8_act_scales=...)`` to
        skip calibrating in a later process. A later :meth:`set_lora` rebuilds the
        UNet with the constructor's scales only.

        Under ``weight_dtype="int8_hybrid"`` the trajectories run on a temporary
        copy of the UNet with every eligible conv site int8 and dynamic; then the
        live UNet becomes the hybrid form (:func:`weights.quantize.hybridize_params`)."""
        if self.weight_dtype not in ("int8", "int8_hybrid"):
            raise ValueError("calibrate_int8 requires weight_dtype='int8' or 'int8_hybrid'")
        h8, w8 = self.img_height // 8, self.img_width // 8
        uncond = self._unconditional_context()
        context = uncond if encoded_text is None else to_device(encoded_text, self.device,
                                                                 torch.float32)
        if context.dim() == 2:
            context = context[None]
        schedule = sched_lib.build_denoise_schedule(self.scheduler, num_steps, eta=0.3)
        t_embs = sched_lib.timestep_embedding(schedule.timesteps)
        rows = {k: np.asarray(getattr(schedule, k), np.float32)
                for k in ("sr_t", "nr_t", "sr_prev", "nr_prev", "is_last")}
        calib_unet = self.unet
        if self.weight_dtype == "int8_hybrid":
            # the tape records int8 sites only, so the copy carries one at every
            # candidate conv site
            calib_unet = quantize.quantize_params(copy.deepcopy(self.unet), conv_only=True)
        amax: dict = {}
        for seed in seeds:
            latent0 = rng_lib.stateless_normal((1, h8, w8, 4), seed).astype(np.float32)
            got = calibrate.collect_unet_amax(
                calib_unet, to_device(latent0, self.device).to(self.compute_dtype), context,
                uncond, t_embs, rows, guidance_scale=unconditional_guidance_scale,
                guidance_rescale=guidance_rescale)
            calibrate.merge_stats(amax, got)
        del calib_unet
        self._programs.clear()  # the sites' scales change in place, or the UNet is new
        if self.weight_dtype == "int8_hybrid":
            self._unet = quantize.hybridize_params(
                self.unet, amax, margin=margin, dense_dynamic=self._hybrid_dense,
                **self._hybrid_cfg)
        else:
            self._unet = calibrate.bake_act_scales(self.unet, amax, margin=margin,
                                                   include_dense=include_dense)
        if save_path:
            calibrate.save_scales(save_path, amax)
        return amax

    def generate_images(self, encoded_texts, seeds=None, **kwargs):
        """Queued dispatch: every request of ``encoded_texts`` (contexts as
        :meth:`generate_image` takes them, with ``seeds`` an optional list beside
        them) is dispatched with ``_defer_fetch`` before any result is fetched, so
        the host prepares and queues request i + 1 while the card computes request
        i. The other keyword arguments go to :meth:`generate_image`; ``callback``
        and ``return_latent`` are refused. Returns the uint8 image batches in
        order."""
        if kwargs.get("callback") is not None:
            raise ValueError("generate_images does not support per-step callbacks")
        if kwargs.get("return_latent"):
            raise ValueError("generate_images returns images only")
        handles = [self.generate_image(enc, seed=None if seeds is None else seeds[i],
                                       _defer_fetch=True, **kwargs)
                   for i, enc in enumerate(encoded_texts)]
        return [fetch(h) for h in handles]

    @torch.inference_mode()
    def _encode_image(self, image_tensor: np.ndarray) -> np.ndarray:
        """(1, H, W, 3) in [-1, 1] -> the fp32 (1, H/8, W/8, 4) latent on the host;
        the encoder runs in the compute dtype. Bringing the latent to the host
        waits for the card: the start latent is formed there, in the JAX
        pipeline's rounding."""
        x = to_device(image_tensor, self.device).to(self.compute_dtype)
        with self._sp_scope():
            return self.encoder(x).float().cpu().numpy()

    @torch.inference_mode()
    def _hint(self, cn_img: np.ndarray) -> torch.Tensor:
        """(B, H, W, 3) in [0, 1] -> the HintNet's (B, 320, H/8, W/8), compute dtype."""
        x = to_device(cn_img, self.device).to(self.compute_dtype)
        return self.controlnet.controlnet_cond_embedding(x)

    # ---- reference-compatible sub-model handles -----------------------------------
    # The JAX package exposes each sub-model as a handle with ``predict_on_batch``
    # over numpy arrays in its layouts; these do the same on the port's modules.

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device).to(self.compute_dtype)

    @property
    def diffusion_model(self) -> "_CompatModel":
        """``[latent (B, h, w, 4), t_emb (B, 320), context (B, S, 768), *controls]``
        -> the UNet's output (B, h, w, 4); the 13 ControlNet residuals, if given,
        are NHWC."""
        unet = self.unet

        @torch.inference_mode()
        def fn(inputs):
            latent, t_emb, context, *controls = inputs
            controls = [self._tensor(c).permute(0, 3, 1, 2) for c in controls] or None
            out = unet(self._tensor(latent), self._tensor(t_emb), self._tensor(context),
                       controls=controls)
            return out.float().cpu().numpy()

        return _CompatModel(fn)

    @property
    def text_clip_embedding(self) -> "_CompatModel":
        """``[tokens (B, S), positions]`` (positions broadcast to the tokens' shape)
        -> the token + position embedding (B, S, 768)."""
        model = self.text_model

        @torch.inference_mode()
        def fn(inputs):
            tokens, positions = (torch.as_tensor(np.asarray(a, np.int64), device=self.device)
                                 for a in inputs)
            emb = clip_lib.clip_embedding(model, tokens, positions.expand(tokens.shape))
            return emb.float().cpu().numpy()

        return _CompatModel(fn)

    @property
    def text_encoder(self) -> "_CompatModel":
        """The (B, S, 768) embedding -> the encoder's (B, S, 768) output at
        ``clip_skip``, in fp32."""
        model = self.text_model

        @torch.inference_mode()
        def fn(emb):
            x = torch.as_tensor(np.asarray(emb, np.float32), device=self.device)
            return clip_lib.text_encoder(model, x, self.clip_skip).cpu().numpy()

        return _CompatModel(fn)

    @property
    def image_encoder(self) -> "_CompatModel":
        """(B, H, W, 3) in [-1, 1] -> the fp32 (B, H/8, W/8, 4) latent."""
        return _CompatModel(lambda img: self._encode_image(np.asarray(img, np.float32)))

    @property
    def image_decoder(self) -> "_CompatModel":
        """(B, h, w, 4) latent -> the (B, 8h, 8w, 3) image in [-1, 1], fp32."""
        decoder = self.decoder

        @torch.inference_mode()
        def fn(latent):
            return decoder(self._tensor(latent)).float().cpu().numpy()

        return _CompatModel(fn)

    @property
    def hint_net(self) -> "_CompatModel":
        """(B, H, W, 3) in [0, 1] -> the HintNet's (B, H/8, W/8, 320) output."""
        return _CompatModel(lambda img: self._hint(np.asarray(img, np.float32))
                            .permute(0, 2, 3, 1).float().cpu().numpy())

    @property
    def control_net(self) -> "_CompatModel":
        """``[latent, t_emb, context, hint (B, h, w, 320)]`` -> the 13 NHWC
        residuals (12 skips and the mid block)."""
        controlnet = self.controlnet

        @torch.inference_mode()
        def fn(inputs):
            latent, t_emb, context, hint = inputs
            outs = controlnet(self._tensor(latent), self._tensor(t_emb), self._tensor(context),
                              self._tensor(hint).permute(0, 3, 1, 2))
            return [o.permute(0, 2, 3, 1).float().cpu().numpy() for o in outs]

        return _CompatModel(fn)


class _CompatModel:
    """A stand-in for a Keras model handle: ``predict_on_batch`` and ``__call__``."""

    def __init__(self, fn):
        self._fn = fn

    def predict_on_batch(self, inputs):
        return self._fn(inputs)

    def __call__(self, inputs):
        return self._fn(inputs)
