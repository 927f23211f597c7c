"""On-card kernel parity check: K1 and K2, built for and run on the current card at
the 512px SD1.5 UNet's self-attention shapes, against their plain PyTorch versions
on the same inputs, with the limits of ``chip_smoke.py``'s phase 3.

    python -m minsdtf_tpu_torch.tools.selfcheck

A shape that the routing keeps off the kernels (kv < 512) is skipped. On the CPU
the wrappers compute the plain version itself, so the check would compare it with
itself and prove nothing: it raises there instead.
"""

from __future__ import annotations

import torch

# (B, S, H, D): the three self-attention shapes of the 512px UNet under CFG
PRODUCTION_SHAPES = [
    (2, 4096, 8, 40),
    (2, 1024, 8, 80),
    (2, 256, 8, 160),
]
# (rtol, atol) against the plain version. With randn q, k, v and scale d**-0.5 the
# output's rms is about sqrt(e / Sk), 0.026 at Sk = 4096, so atol sits well below
# it. Another fp32 summation order (an online rescale, another tile order) can move
# the final rounding to bf16 by one ulp, up to 2**-7 = 7.8e-3 of the output: rtol
# covers that one ulp. fp32 errs by < 1e-6. A kernel that skips its last KV tile
# fails every case of chip_smoke.py's phase 3 (PERF.md).
TOL = {torch.bfloat16: (8e-3, 2e-3), torch.float32: (2e-5, 2e-5)}
# The bf16 checks also allow for p's rounding. A p that a kernel rounds to bf16 at
# another running max than the plain version, or that lands across a rounding
# boundary (the scores differ in their last fp32 bits), differs from the plain
# version's by at most one bf16 ulp, 2**-7 of p. That moves an output o by at most
# 2**-7 sum_j c_j, c_j = w_j (|v_j| + |o|) with w = p / l (the |o| term: K1's l sums
# the rounded p). Over many terms these errors mostly cancel, so the slack per
# element is 2**-7 min(sum_j c_j, P_ROUND_RSS sqrt(sum_j c_j**2)). Where a few keys
# carry a row (adversarial inputs), that is one ulp of their terms, which an output
# near zero made of large terms of opposite sign can need.
P_ROUND_RSS = 4


def rounding_slack(name, q, k, v, scale, want) -> torch.Tensor:
    """Per output element of kernel ``name`` ("onepass" or "online"), the most that
    p rounded to bf16 at another point than in the plain version can move it
    (``P_ROUND_RSS``); (B, Sq, H, D) fp32."""
    from minsdtf_tpu_torch.ops import flash_attention as fa

    if name == "onepass":
        qs = (q.float() * (scale * fa.LOG2E)).to(q.dtype)
        s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
        w = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    else:
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
        w = torch.exp(s - s.amax(dim=-1, keepdim=True))
    del s
    w /= w.sum(dim=-1, keepdim=True)
    o, va = want.float().abs(), v.float().abs()
    total = torch.einsum("bhqk,bkhd->bqhd", w, va) + o  # sum_j w_j = 1
    w.square_()
    w2_sum = w.sum(dim=-1).transpose(1, 2).unsqueeze(-1)  # (B, Sq, H, 1)
    # sum_j w_j**2 (|v_j| + |o|)**2, expanded
    rss = (torch.einsum("bhqk,bkhd->bqhd", w, va.square())
           + 2 * o * torch.einsum("bhqk,bkhd->bqhd", w, va) + o.square() * w2_sum).sqrt()
    return 2.0 ** -7 * torch.minimum(total, P_ROUND_RSS * rss)


def kernel_cases(shapes=None):
    """``[(kernel, (B, S, H, D))]``: K1 ("onepass") where it takes the shape, and
    K2 ("online", path A at d <= 160, path B at d = 512) at every shape whose
    self-attention the routing sends to a kernel."""
    from minsdtf_tpu_torch.ops import flash_attention as fa

    cases = []
    for b, s, h, d in shapes or PRODUCTION_SHAPES:
        if fa.route(s, s, d) == "plain":
            continue
        if s <= fa.ONEPASS_MAX_KV and d <= fa.ONEPASS_MAX_D:
            cases.append(("onepass", (b, s, h, d)))
        cases.append(("online", (b, s, h, d)))
    return cases


def check_flash_attention(shapes=None, dtype=torch.bfloat16, device="cuda", verbose=True):
    """Each of :func:`kernel_cases` on ``device`` against its plain version, within
    ``TOL`` (and :func:`rounding_slack` in bf16). Returns ``[(kernel, shape,
    max_abs_err)]``; raises ``AssertionError`` on a disagreement and
    ``ValueError`` on a device that is not a card."""
    from minsdtf_tpu_torch.ops import flash_attention as fa

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"selfcheck needs a CUDA device, not {device}: on the CPU the "
                         "wrappers compute the plain version, which would be compared "
                         "with itself")
    cases = kernel_cases(shapes)
    if verbose:
        for t in shapes or PRODUCTION_SHAPES:
            if all(shape != t for _, shape in cases):
                print(f"selfcheck: skip (B{t[0]} S{t[1]} H{t[2]} D{t[3]}) — plain path")
    rtol, atol = TOL[dtype]
    results = []
    for name, (b, s, h, d) in cases:
        gen = torch.Generator(device=device).manual_seed(s + d)
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device=device).to(dtype)
                   for _ in range(3))
        scale = d ** -0.5
        kernel = getattr(fa, f"{name}_attention")
        plain = getattr(fa, f"{name}_attention_plain")
        out = kernel(q, k, v, scale).float()
        want = plain(q, k, v, scale)
        slack = (rounding_slack(name, q, k, v, scale, want) if dtype == torch.bfloat16
                 else torch.zeros((), device=device))
        want = want.float()
        err = (out - want).abs()
        ok = bool(torch.isfinite(out).all()) and bool(
            (err <= atol + rtol * want.abs() + slack).all())
        max_err = err.max().item()
        results.append((name, (b, s, h, d), max_err))
        if verbose:
            print(f"selfcheck: {name} B{b} S{s} H{h} D{d} {str(dtype)[6:]}: max abs err "
                  f"{max_err:.3e} (ref max {want.abs().max().item():.2f}) "
                  f"{'OK' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version at (B{b} S{s} "
                                 f"H{h} D{d}): max abs err {max_err:.3e}")
    return results


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("selfcheck: no CUDA device visible")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)
    print(f"selfcheck on {name}")
    check_flash_attention(device=device)
    print("selfcheck OK: the kernels agree with their plain versions")


if __name__ == "__main__":
    main()
