"""Profiling and utilization reporting on the card.

``trace(log_dir)`` records the card's activity with ``torch.profiler`` (CUDA
activity only: the host's events cost most of the profiler's processing time and
no number here reads them) and writes a Chrome trace; ``op_report`` sums a
finished profile's device time by kernel name or by kernel group
(:func:`kernel_group`); ``utilization_report`` sets a measured time against the
analytic FLOP count of a generation and the card's bf16 peak.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

# Analytic workload model: the SD1.5 UNet is ~340 GFLOP per 512x512 forward and
# the VAE decode ~1.2 TFLOP at 512x512; both scale with the pixel count.
UNET_GFLOP_512 = 340.0
DECODE_GFLOP_512 = 1200.0

# Dense bf16 tensor-core peaks by card name (NVIDIA's data sheet): the H100 SXM
# part, at its full 700 W power limit.
PEAK_BF16 = {"H100 80GB HBM3": 989e12}

# kernel group -> lowercase marks of its kernels' names; the first match wins
KERNEL_GROUPS = (
    ("attention K1/K2", ("flash_onepass", "flash_online", "flash_bf16")),
    ("convolution", ("conv", "fprop", "implicit", "dgrad", "winograd")),
    # torch._int_mm's int8 x int8 -> int32 products (the int8 path's convs and
    # dense sites), e.g. cutlass_80_tensorop_i16832gemm_s8_128x64_128x3_tn_align16
    ("int8 gemm", ("gemm_s8", "s8s8", "imma")),
    ("gemm", ("gemm", "nvjet", "cutlass", "matmul")),
    ("norm", ("norm",)),
    ("memcpy/memset", ("memcpy", "memset")),
)


def kernel_group(name: str) -> str:
    """The group of a device operation by its name; "elementwise/other" where no
    group's mark is in it."""
    lowered = name.lower()
    for group, marks in KERNEL_GROUPS:
        if any(m in lowered for m in marks):
            return group
    return "elementwise/other"


def chip_peak_flops(name: Optional[str] = None) -> float:
    """The dense bf16 peak of the card called ``name`` (by default card 0's name);
    ``ValueError`` for a card whose peak is not recorded here."""
    name = torch.cuda.get_device_name(0) if name is None else name
    for key, val in PEAK_BF16.items():
        if key in name:
            return val
    raise ValueError(f"no bf16 peak recorded for {name!r}; known: {sorted(PEAK_BF16)}")


def generation_flops(height: int, width: int, steps: int, batch: int = 1,
                     cfg: bool = True) -> float:
    scale = (height * width) / (512.0 * 512.0)
    unet = UNET_GFLOP_512 * 1e9 * scale * steps * (2 if cfg else 1)
    return (unet + DECODE_GFLOP_512 * 1e9 * scale) * batch


def utilization_report(sec_per_batch: float, height: int, width: int, steps: int,
                       batch: int = 1, cfg: bool = True, name: Optional[str] = None) -> dict:
    """A measured ``sec_per_batch`` against :func:`generation_flops` and the card's
    bf16 peak (:func:`chip_peak_flops` of ``name``)."""
    flops = generation_flops(height, width, steps, batch, cfg)
    achieved = flops / sec_per_batch
    peak = chip_peak_flops(name)
    return {
        "sec_per_image": sec_per_batch / batch,
        "achieved_tflops": achieved / 1e12,
        "peak_tflops": peak / 1e12,
        "utilization": achieved / peak,
    }


@contextlib.contextmanager
def trace(log_dir: str):
    """Record the card's activity inside the block with ``torch.profiler`` (yielded,
    for :func:`op_report`) and write it to ``log_dir/trace.json`` (Chrome trace
    format)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profile written to {path} (chrome://tracing or Perfetto)")


def op_report(prof, by: str = "name", device: str = "cuda", top: Optional[int] = 25) -> dict:
    """``{key: (ms, count)}``, largest first, over the events of the finished
    profile ``prof``: each kernel's device time on ``device="cuda"``, or each
    operator's self CPU time on ``device="cpu"`` (a CPU-only profile), summed by
    name (``by="name"``) or by :func:`kernel_group` (``by="group"``). Prints the
    total and the ``top`` rows (none when ``top`` is None)."""
    from torch.autograd import DeviceType

    if by not in ("name", "group"):
        raise ValueError(f"by must be 'name' or 'group', got {by!r}")
    want = {"cuda": DeviceType.CUDA, "cpu": DeviceType.CPU}[device]
    buckets = {}
    for e in prof.events():
        if e.device_type != want:
            continue
        ms = (e.device_time_total if want == DeviceType.CUDA else e.self_cpu_time_total) / 1e3
        key = e.name if by == "name" else kernel_group(e.name)
        total, count = buckets.get(key, (0.0, 0))
        buckets[key] = (total + ms, count + 1)
    rows = dict(sorted(buckets.items(), key=lambda kv: -kv[1][0]))
    if top is not None:
        busy = sum(t for t, _ in rows.values())
        print(f"{device} time total: {busy:.3f} ms ({by} buckets)")
        for key, (t, n) in list(rows.items())[:top]:
            print(f"  {t:10.3f} ms  n={n:6d}  {key[:100]}")
    return rows


@contextlib.contextmanager
def timed(label: str = "block", device: str = "cuda"):
    """Host-clock seconds of the block, into the yielded dict's ``"seconds"``; on a
    CUDA ``device`` the block's end waits for the card (``synchronize``)."""
    out = {}
    t0 = time.perf_counter()
    yield out
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    out["seconds"] = time.perf_counter() - t0
    print(f"[{label}] {out['seconds']:.3f}s")
