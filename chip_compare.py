"""Companion runs to ``chip_smoke.py`` on one NVIDIA card (H100), for comparisons
that the smoke run does not make itself.

    python3 chip_compare.py tree DIR    # DIR: the root of a checkout, this one (.) or another
    python3 chip_compare.py mutants
    python3 chip_compare.py seeds

``tree`` times DIR's K2 wrapper (``online_attention``) at the shapes of
``chip_smoke.py`` phase 4, with this checkout's ``time_ms`` (a CUDA graph of
calls), and runs DIR's txt2img at 1024x1024 and 512x512 (25 steps, CFG 7.5, bf16,
one cold image and WARM warm ones), printing the median s/img of each. Run it on
two checkouts in one call, in turns (A, B, B, A), to compare them on one card.

``mutants`` builds broken copies of ``csrc/flash_attention.cu`` under
``build/mutants/``, each with one kernel skipping its last KV tile: K2's bf16 path
A (d <= 160) and path B (d = 512), K1's fp32 kernel, K2's fp32 body (d <= 192)
and its d = 512 kernel. It runs every phase-3 case of that kernel against the
mutant with ``chip_smoke.py``'s inputs and limits. Each case must fail; the run
exits 1 if one passes.

``seeds`` runs every phase-3 case with its inputs drawn from SEEDS other base
seeds (``chip_smoke.check_case``); the run exits 1 if a case fails at any.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import chip_smoke as cs  # noqa: E402

WARM = 3
SEEDS = range(1, 9)
# Inserted at the top of each kernel's KV loop body, after the next tile's loads
# are issued: the mutant computes nothing for the last tile. The text before which
# it goes must be in the source once; the run stops if it is not. Each mutant
# names the phase-3 cases it must fail: (kernel, dtype, the head width the
# wrapper runs the case at).
MUTANTS = {
    "A": ("    const uint32_t kb = smem_u32(sK + (it % STAGES) * T::KV_BYTES);\n",
          "    if (MODE == EXP_FP32_SUM && it == ntiles - 1) continue;\n",
          lambda name, dtype, width: name == "online" and dtype == torch.bfloat16 and width <= 160),
    "B": ("    const uint32_t kb = smem_u32(sK + (it % STAGES) * W::K_BYTES);\n",
          "    if (tile_of(it) == (p.Sk + BK - 1) / BK - 1) continue;\n",
          lambda name, dtype, width: name == "online" and dtype == torch.bfloat16 and width == 512),
    "F1": ("    const float* kt = sK + (it % T::STAGES) * T::K_FLOATS + cg * KS;\n",
           "    if (MODE == EXP2_ROUNDED_SUM && it == ntiles - 1) continue;\n",
           lambda name, dtype, width: name == "onepass" and dtype == torch.float32),
    "F2": ("    const float* kt = sK + (it % T::STAGES) * T::K_FLOATS + cg * KS;\n",
           "    if (MODE == EXP_FP32_SUM && it == ntiles - 1) continue;\n",
           lambda name, dtype, width: name == "online" and dtype == torch.float32 and width <= 192),
    "F3": ("    const float* kt = sK + (it % W::STAGES) * W::KV_FLOATS + 4 * lane;\n",
           "    if (it == ntiles - 1) continue;\n",
           lambda name, dtype, width: name == "online" and dtype == torch.float32 and width == 512),
}


def log(*args):
    print(*args, flush=True)


def run_tree(root: str) -> None:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    from minsdtf_tpu_torch import StableDiffusion
    from minsdtf_tpu_torch.ops import flash_attention as fa

    assert os.path.dirname(os.path.abspath(fa.__file__)).startswith(root), fa.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"tree {root}: {torch.cuda.get_device_name(0)}, {cs.phase_card()[0]}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, s, h, d in ((1, 4096, 1, 512), (2, 16384, 8, 40), (1, 16384, 1, 512)):
        q, k, v = cs.qkv(b, s, s, h, d, torch.bfloat16, gen,
                         "fused_qkv" if d <= 160 else "contiguous")
        ms = cs.time_ms(lambda: fa.online_attention(q, k, v, d ** -0.5), 20)
        log(f"tree K2 B{b} S{s} H{h} D{d} bf16: {ms:.4f} ms (graph of 20 calls)")
    with tempfile.TemporaryDirectory(prefix="chip-compare-") as tmp:
        bpe = cs.synthetic_merges(tmp)
        for size in (1024, 512):
            t0 = time.perf_counter()
            pipe = StableDiffusion(size, size, bpe_path=bpe)
            pipe.text_to_image(cs.PROMPT, num_steps=25, unconditional_guidance_scale=7.5,
                               seed=1234)
            torch.cuda.synchronize()
            log(f"tree {size}x{size} cold: {time.perf_counter() - t0:.3f} s")
            samples = []
            for _ in range(WARM):
                t0 = time.perf_counter()
                pipe.text_to_image(cs.PROMPT, num_steps=25, unconditional_guidance_scale=7.5,
                                   seed=1234)
                torch.cuda.synchronize()
                samples.append(time.perf_counter() - t0)
            log(f"tree {size}x{size} 25 steps CFG 7.5 bf16: median "
                f"{statistics.median(samples):.4f} s/img of {[round(t, 4) for t in samples]}")
            del pipe


def build_mutants(out_dir: str) -> dict:
    """Builds one copy of ``csrc/flash_attention.cu`` per entry of ``MUTANTS``, all
    nvcc runs at once, and returns {path: bound library}."""
    from minsdtf_tpu_torch import kernels
    from minsdtf_tpu_torch.ops import flash_attention as fa

    src = open(os.path.join(kernels.CSRC, "flash_attention.cu")).read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for path, (anchor, skip, _) in MUTANTS.items():
        if src.count(anchor) != 1:
            raise RuntimeError(f"mutant {path}: its anchor is not in the source once: {anchor!r}")
        cu = os.path.join(out_dir, f"mutant_{path}.cu")
        with open(cu, "w") as f:
            f.write(src.replace(anchor, skip + anchor))
        procs[path] = (cu[:-3] + ".so", subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", cu[:-3] + ".so", cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for path, (so, proc) in procs.items():
        output = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"mutant {path}: nvcc failed\n{output}")
        libs[path] = fa.bind(ctypes.CDLL(so))
    return libs


def run_mutants() -> int:
    from minsdtf_tpu_torch.ops import flash_attention as fa

    cs.phase_card()
    libs = build_mutants(os.path.join(HERE, "build", "mutants"))
    passed = []
    for path, lib in libs.items():
        fa._LIB = lib
        for case in cs.CASES:
            name, d, dtype = case[0], case[5], case[6]
            if not MUTANTS[path][2](name, dtype, fa.kernel_width(name, dtype, d)):
                continue
            ok, err, line = cs.check_case(case)
            log(f"mutant {path} (skips its last KV tile): {line}")
            if ok:
                passed.append((path, case[1:6], case[7]))
    fa._LIB = None
    log(f"mutants: {'every case failed' if not passed else f'PASSED (not caught): {passed}'}")
    return 1 if passed else 0


def run_seeds() -> int:
    cs.phase_card()
    failed = []
    for case in cs.CASES:
        for seed in SEEDS:
            ok, err, line = cs.check_case(case, seed)
            log(f"seed {seed}: {line}")
            if not ok:
                failed.append((seed, case))
    log(f"seeds {list(SEEDS)}: {len(cs.CASES) * len(SEEDS) - len(failed)} of "
        f"{len(cs.CASES) * len(SEEDS)} checks passed; failed: {failed}")
    return 1 if failed else 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device visible", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["tree"] and len(sys.argv) == 3:
        run_tree(sys.argv[2])
        return 0
    if sys.argv[1:] == ["mutants"]:
        return run_mutants()
    if sys.argv[1:] == ["seeds"]:
        return run_seeds()
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
