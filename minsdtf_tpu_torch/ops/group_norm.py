"""GroupNorm (+ SiLU) over channels-last activations on the H100: hand-written CUDA
kernels (``csrc/group_norm.cu`` ``minsdtf_group_norm_nhwc``: statistics, their
final sum, the normalisation).

It replaces no TPU kernel: the JAX package leaves GroupNorm to XLA. The port's
plain composition (:func:`minsdtf_tpu_torch.ops.basic.group_norm_plain`) casts to
fp32, runs PyTorch's GroupNorm, which takes only NCHW memory on CUDA, casts back
and applies SiLU in two more passes; with the models' activations channels-last
it would also transpose twice a call. The kernel computes the same function,
statistics summed in fp64 about a shift (deterministic: the same bits every run),
the affine in fp32, SiLU fused when asked, one rounding to the activation dtype,
reading the NHWC input twice and writing once. The source's header says what
bounds it and how.

:func:`takes` says which calls :func:`minsdtf_tpu_torch.ops.basic.group_norm`
routes here: CUDA tensors in bf16 or fp32 with 32 groups, C a multiple of 32 and
at most ``MAX_C``, and no autograd to record (the kernel has no backward; training
keeps the plain composition). :func:`group_norm_nhwc` raises on a tensor whose
memory is not dense NHWC: it never copies into the layout it takes. Its
``launches`` counts the kernels it launched, three a call.
"""

from __future__ import annotations

import ctypes

import torch

from minsdtf_tpu_torch import kernels

GROUPS = 32
MAX_C = 2560
KERNELS = 3  # a call's launches: statistics, their final sum, the normalisation
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        _LIB = bind(kernels.load("group_norm"))
    return _LIB


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the argument and result types of the library's C functions."""
    lib.minsdtf_group_norm_nhwc.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.minsdtf_group_norm_nhwc.restype = ctypes.c_int
    lib.minsdtf_group_norm_workspace_bytes.argtypes = [ctypes.c_int] * 4
    lib.minsdtf_group_norm_workspace_bytes.restype = ctypes.c_longlong
    return lib


def takes(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int) -> bool:
    """Whether :func:`minsdtf_tpu_torch.ops.basic.group_norm` runs the kernel on
    ``x``: by its device, dtype, channel count and groups, and not where autograd
    would record the output. The layout is not asked: a CUDA tensor that passes
    this and is not NHWC in memory makes :func:`group_norm_nhwc` raise."""
    return (x.device.type == "cuda" and x.dtype in _DTYPE_CODES and x.dim() == 4
            and num_groups == GROUPS and x.shape[1] % GROUPS == 0 and x.shape[1] <= MAX_C
            and not (torch.is_grad_enabled()
                     and (x.requires_grad or weight.requires_grad or bias.requires_grad)))


def group_norm_nhwc(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-5, silu: bool = False) -> torch.Tensor:
    """The kernel on the CUDA (B, C, H, W) tensor ``x`` whose memory is dense NHWC
    (``x.is_contiguous(memory_format=torch.channels_last)``), with fp64 statistics
    and an fp32 affine; the output has NHWC strides written out, also where C = 1
    or H = W = 1 would leave them ambiguous. Adds ``KERNELS`` to
    ``group_norm_nhwc.launches``."""
    if x.device.type != "cuda" or x.dtype not in _DTYPE_CODES or x.dim() != 4:
        raise ValueError(f"group_norm_nhwc: a 4-D CUDA bf16 or fp32 tensor, got "
                         f"{x.dim()}-D {x.dtype} on {x.device}")
    b, c, h, w = x.shape
    if not x.is_contiguous(memory_format=torch.channels_last) or x.data_ptr() % 16:
        raise ValueError(f"group_norm_nhwc: x must be dense NHWC in memory on 16 bytes, got "
                         f"shape {tuple(x.shape)} strides {x.stride()} at {x.data_ptr() % 16} "
                         "bytes past 16")
    if c % GROUPS or c > MAX_C or weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"group_norm_nhwc: {c} channels (a multiple of {GROUPS} up to {MAX_C}), "
                         f"weight {tuple(weight.shape)}, bias {tuple(bias.shape)}")
    lib = _lib()
    code = _DTYPE_CODES[x.dtype]
    gamma = weight.to(device=x.device, dtype=torch.float32).contiguous()
    beta = bias.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device, memory_format=torch.channels_last)
    ws = torch.empty(lib.minsdtf_group_norm_workspace_bytes(b, h * w, c, code), dtype=torch.uint8,
                     device=x.device)
    err = lib.minsdtf_group_norm_nhwc(
        x.data_ptr(), out.data_ptr(), gamma.data_ptr(), beta.data_ptr(), ws.data_ptr(),
        b, h * w, c, GROUPS, float(eps), int(silu), code,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"minsdtf_group_norm_nhwc launch failed: cudaError {err}")
    group_norm_nhwc.launches += KERNELS
    return out


group_norm_nhwc.launches = 0
