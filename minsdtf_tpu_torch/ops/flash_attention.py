"""Flash attention on the H100: two hand-written CUDA kernels, their plain PyTorch
versions, and the routing contract.

  - K1, :func:`onepass_attention` (``csrc/flash_attention.cu``
    ``minsdtf_flash_onepass``), replaces ``minsdtf_tpu/ops/flash_attention.py``
    ``_onepass_kernel``: the softmax in the exp2 domain, with the row sum taken
    over the rounded p. In bf16 it is FlashAttention on ``wgmma``: Q held in
    registers as the A operand, K/V tiles in a ``cp.async`` ring, the scores and
    p never leaving registers, one online sweep, and the row sum from a ones
    column on the tensor cores. At the UNet self-attention shape (16, 4096, 40)
    the 2.7e8 exponentials, not the 42.9 GFLOP of products, set the floor, so the
    design keeps every other per-score instruction off the issue slots.
  - K2, :func:`online_attention` (``minsdtf_flash_online``), replaces
    ``_kernel``: blockwise online softmax in the natural-exp domain, with the
    running (m, l, acc) carried over KV tiles and l summing the fp32 p. In bf16 it
    has two kernels. Path A (head widths 40, 80, 160; the 1024px UNet's
    (2, 16384, 8, 40)) is K1's wgmma body with K2's softmax convention: the
    exponentials set its floor, as for K1. Path B (d = 512; the VAE mid-block,
    (1, 4096, 1, 512) at 512px) splits the output width over blocks, one
    warpgroup each holding a 64 x 256 fp32 accumulator, so that 4096 rows of one
    head fill the card.
  - In fp32 the products stay true fp32 FFMA, and the FFMA peak is the floor. K1
    and K2 share one register-blocked body (head widths 40, 80, 160, and 192 for
    K2), each with its own softmax convention: a lane keeps its tile of scores,
    its rows' (m, l) and its outputs in registers over one online sweep, with K/V
    tiles in a ``cp.async`` ring. K2 at d = 512 keeps Q and O in registers and
    reduce-scatters the scores over the warp by shuffles.

The source's header says what each kernel's design does about its bound.

A wrapper launches its kernel for CUDA tensors (or raises) and computes the plain
version for CPU tensors; each wrapper counts its launches in ``.launches``. The
kernels have no backward, and neither have the JAX kernels they port: on CUDA
tensors a wrapper raises ``RuntimeError`` when autograd would record its output
(grad mode on and q, k or v requiring grad), since that output would carry no
gradient. Training selects the plain path by name
(:func:`minsdtf_tpu_torch.ops.attention.plain_scope`); the CPU branch stays the
differentiable plain version.
Tensors are ``(B, S, H, D)`` and may be strided, with a contiguous D axis. Each
kernel is built for a few head widths (:data:`KERNEL_WIDTHS`: the SD1.5 levels
over 8 heads, and K2's VAE widths) and reads 16-byte rows: any other width, or a
tensor whose pointer or strides are not 16-byte multiples, goes through a
zero-padded contiguous copy (:func:`pad_head_dim`; zero columns change no score
and add nothing to p v) and the output is sliced back. The pipelines' tensors,
fused ``to_qkv`` views included, need no copy.

Routing keeps the JAX split (``supports`` / ``_use_onepass``): causal or kv < 512
stays on the plain path (:func:`minsdtf_tpu_torch.ops.attention.plain_attention`),
kv <= 4096 with d <= 160 goes to K1, the rest to K2. The TPU's VMEM block budgets
(``_pick_blocks``, ``_onepass_block_q``, the fp32 ``kv > 2048`` rule) are not part
of the contract on this card.
"""

from __future__ import annotations

import ctypes

import torch

from minsdtf_tpu_torch import kernels

LOG2E = 1.4426950408889634
MIN_KV = 512
ONEPASS_MAX_KV = 4096
ONEPASS_MAX_D = 160
ONLINE_MAX_D = 512
# The head widths each kernel is built for, by dtype: K1's; K2's bf16 path A, then
# path B; K2's fp32 body, then its d = 512 kernel.
KERNEL_WIDTHS = {
    ("onepass", torch.bfloat16): (40, 80, 160),
    ("onepass", torch.float32): (40, 80, 160),
    ("online", torch.bfloat16): (40, 80, 160, 512),
    ("online", torch.float32): (40, 80, 160, 192, 512),
}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURE = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_ONLINE_SIGNATURE = _SIGNATURE + [ctypes.c_void_p]  # + the workspace
_LIB = None


def route(q_len: int, kv_len: int, head_dim: int, causal: bool = False) -> str:
    """``"onepass"`` (K1), ``"online"`` (K2) or ``"plain"``."""
    if causal or kv_len < MIN_KV:
        return "plain"
    if kv_len <= ONEPASS_MAX_KV and head_dim <= ONEPASS_MAX_D:
        return "onepass"
    return "online"


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the type the plain versions accumulate in: fp32, or fp64 for fp64
    inputs, which evaluates a kernel's function with fp64 rounding (the on-card
    checks of the fp32 kernels hold them against that)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B, Sq, H, D) x (B, Sk, H, D) -> (B, H, Sq, Sk): exact products of the
    input-type values, fp32 sums (what the kernels' fp32 accumulation computes;
    fp64 for fp64 inputs)."""
    return torch.einsum("bqhd,bkhd->bhqk", _acc(q), _acc(k))


def _weighted_sum(p_rounded: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, H, Sq, Sk) x (B, Sk, H, D) -> (B, Sq, H, D)."""
    return torch.einsum("bhqk,bkhd->bqhd", _acc(p_rounded), _acc(v))


def onepass_attention_plain(q, k, v, scale: float) -> torch.Tensor:
    """K1's function in plain PyTorch: scale*log2(e) folded into q and rounded to
    the input type, p = exp2(s - max) in fp32, p rounded to the V type, output
    ``sum(p v) / sum(p)`` over the rounded p, in the input type."""
    qs = (_acc(q) * (scale * LOG2E)).to(q.dtype)
    s = _scores(qs, k)
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True)).to(v.dtype)
    num = _weighted_sum(p, v)
    den = _acc(p).sum(dim=-1).transpose(1, 2).unsqueeze(-1)  # (B, Sq, H, 1)
    return (num / den).to(q.dtype)


def online_attention_plain(q, k, v, scale: float) -> torch.Tensor:
    """K2's function in plain PyTorch: s = q k^T * scale in fp32, p = exp(s - max),
    ``sum(p v) / sum(p)`` with p rounded to the V type for the product and the fp32
    p summed, output in the input type."""
    s = _scores(q, k) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    num = _weighted_sum(p.to(v.dtype), v)
    den = p.sum(dim=-1).transpose(1, 2).unsqueeze(-1)
    return (num / den).to(q.dtype)


def kernel_width(kernel: str, dtype: torch.dtype, head_dim: int) -> int:
    """The head width ``kernel`` ("onepass" or "online") runs a ``head_dim``-wide
    call at in ``dtype``: the narrowest of :data:`KERNEL_WIDTHS` that holds it."""
    return next(w for w in KERNEL_WIDTHS[kernel, dtype] if w >= head_dim)


def pad_head_dim(t: torch.Tensor, width: int) -> torch.Tensor:
    """A contiguous copy of the (B, S, H, D) tensor ``t`` with D zero-padded to
    ``width``."""
    out = t.new_zeros(*t.shape[:-1], width)
    out[..., :t.shape[-1]] = t
    return out


def _rows_16b(t: torch.Tensor) -> bool:
    """Whether every (B, S, H) row of ``t`` starts on 16 bytes."""
    return t.data_ptr() % 16 == 0 and all(s * t.element_size() % 16 == 0
                                          for s in t.stride()[:3])


def _lib():
    global _LIB
    if _LIB is None:
        _LIB = bind(kernels.load("flash_attention"))
    return _LIB


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the argument and result types of the library's C functions."""
    lib.minsdtf_flash_onepass.argtypes = _SIGNATURE
    lib.minsdtf_flash_online.argtypes = _ONLINE_SIGNATURE
    lib.minsdtf_online_workspace_bytes.argtypes = [ctypes.c_int] * 6
    lib.minsdtf_online_workspace_bytes.restype = ctypes.c_longlong
    for fn in (lib.minsdtf_flash_onepass, lib.minsdtf_flash_online):
        fn.restype = ctypes.c_int
    for fn in (lib.minsdtf_onepass_bf16_blocks_per_sm, lib.minsdtf_online_bf16_blocks_per_sm):
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_int
    return lib


def _check(q, k, v, max_d: int) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name}: {t.device}/{t.dtype}, expected {q.device}/{q.dtype}")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name}: expected a (B, S, H, D) tensor with a contiguous "
                             f"D axis, got shape {tuple(t.shape)} strides {t.stride()}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {q.dtype}: the kernels take bf16 and fp32")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if d > max_d:
        raise ValueError(f"head dim {d} > {max_d}")
    if min(q.shape[1], k.shape[1]) == 0:
        raise ValueError("empty sequence")


def _refuse_grad(name: str, q, k, v) -> None:
    """Raises if autograd would record the kernel's output: it is written through a
    raw pointer and has no backward, so every projection before it would get no
    gradient and an optimizer would skip those weights without a word."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward (nor has the JAX kernel it ports), "
            "so its output would carry no gradient. Select the plain path for training "
            "with minsdtf_tpu_torch.ops.attention.plain_scope(), or call it under "
            "torch.no_grad() / torch.inference_mode().")


def _launch(fn, q, k, v, scale: float, *extra) -> torch.Tensor:
    b, sq, h, d = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, h, sq, k.shape[1], d, strides, float(scale), _DTYPE_CODES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream, *extra)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError {err}")
    return out


def _launch_onepass(q, k, v, scale: float) -> torch.Tensor:
    return _launch(_lib().minsdtf_flash_onepass, q, k, v, scale)


def _launch_online(q, k, v, scale: float) -> torch.Tensor:
    """K2's entry, with the fp32 workspace it asks for (path B's KV parts)."""
    lib = _lib()
    b, sq, h, d = q.shape
    nbytes = lib.minsdtf_online_workspace_bytes(b, h, sq, k.shape[1], d, _DTYPE_CODES[q.dtype])
    ws = torch.empty(nbytes, dtype=torch.uint8, device=q.device) if nbytes else None
    return _launch(lib.minsdtf_flash_online, q, k, v, scale, ws.data_ptr() if nbytes else None)


def _launch_padded(launch, q, k, v, scale: float, width: int) -> torch.Tensor:
    """``launch`` for a kernel built for head width ``width``: inputs of another
    width, or whose rows do not start on 16 bytes, go through :func:`pad_head_dim`,
    and the output is sliced back."""
    d = q.shape[-1]
    if width != d or not all(map(_rows_16b, (q, k, v))):
        q, k, v = (pad_head_dim(t, width) for t in (q, k, v))
    out = launch(q, k, v, scale)
    return out if width == d else out[..., :d].contiguous()


def onepass_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float) -> torch.Tensor:
    """K1 on (B, S, H, D) tensors; the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return onepass_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"onepass_attention: unsupported device {q.device}")
    _refuse_grad("onepass_attention", q, k, v)
    _check(q, k, v, ONEPASS_MAX_D)
    out = _launch_padded(_launch_onepass, q, k, v, scale,
                         kernel_width("onepass", q.dtype, q.shape[-1]))
    onepass_attention.launches += 1
    return out


def positive_scale(k: torch.Tensor, scale: float) -> tuple[torch.Tensor, float]:
    """(k', scale') with ``scale' > 0`` whose scores (q k'^T) scale' equal (q k^T)
    scale bit for bit: a negative scale negates k, a zero scale zeroes it (both
    exact). K2's kernels keep the running max on the unscaled scores, which is the
    max of the scaled ones only for scale > 0."""
    if scale < 0:
        return -k, -scale
    if scale == 0:
        return torch.zeros_like(k), 1.0
    return k, scale


def online_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """K2 on (B, S, H, D) tensors; the plain version for CPU tensors. A scale of
    any sign runs as a positive one (:func:`positive_scale`)."""
    if q.device.type == "cpu":
        return online_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"online_attention: unsupported device {q.device}")
    _refuse_grad("online_attention", q, k, v)
    _check(q, k, v, ONLINE_MAX_D)
    k, scale = positive_scale(k, scale)
    out = _launch_padded(_launch_online, q, k, v, scale,
                         kernel_width("online", q.dtype, q.shape[-1]))
    online_attention.launches += 1
    return out


onepass_attention.launches = 0
online_attention.launches = 0
