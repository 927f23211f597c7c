"""The control of the comparison that decides ``correct``: the reference put in
the program's place (the family's ``ReferencePipe``) and computed one precision
below the configuration's (bfloat16 -> float8 e4m3, every product's inputs
rounded with a per-tensor scale), run through the harness's own run
(``harness.run``): its window, its sample of requests, its comparison with the
fp32 reference and its verdict. Its readings are the upper end of each limit; it
must come out not correct. The benchmark's runs do not run it.

    python3 sdbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

prints one JSON line a seed: the run's verdict, its requests and the numbers it
compared beside their limits. ``--seconds`` is the window: long enough for the
stand-in to complete the cell's ``compare`` requests. Exits 1 where a control
came out correct.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
CONTROL_OPS = {"bfloat16": "Fp8Ops"}  # the configuration's dtype -> the products one precision below


def make_pipe(cfg: dict, weights: dict, mix: dict, device, merges: str, compute_dtype=None):
    """``harness.Cell``'s ``make_pipe``: the family's reference on the
    benchmark's weights, its products one precision below the configuration's."""
    from sdbench import families  # noqa: PLC0415
    from sdbench.reference import models  # noqa: PLC0415

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    family = families.load(cfg)
    ops = getattr(models, CONTROL_OPS[cfg["dtype"]])()
    return family.ReferencePipe(family.Reference(cfg, weights, merges, device, ops), mix, device)


def run(cell: dict, cfg: dict, mix: dict, settings: dict, seed: int, seconds: float, device="cuda") -> dict:
    """One run of the harness with the control in the program's place; its
    result line's object. Set-up warms nothing up: the reference compiles
    nothing."""
    from sdbench import harness  # noqa: PLC0415

    return harness.run(cell, cfg, mix, dict(settings, warmup=0), [], seed, seconds, False, time.perf_counter(),
                       device=device, make_pipe=make_pipe)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    from sdbench import families, traffic  # noqa: PLC0415

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    cfg = families.read(ROOT / next(c["file"] for c in bench["configs"] if c["name"] == cell["config"]))
    settings = json.loads((ROOT / "sdbench" / "workloads" / f"{cell['name']}.json").read_text())
    passed = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = run(cell, cfg, traffic.load(cell["traffic"]), settings, seed, args.seconds)
        passed.append(out["correct"])
        print(json.dumps({"workload": cell["name"], "seed": seed, "correct": out["correct"],
                          "attempted": out["attempted"], "failed": out["failed"], "checks": out["checks"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 1 if any(passed) else 0


if __name__ == "__main__":
    sys.exit(main())
