"""Runs one cell of the benchmark once and prints its result as the last line of
standard output:

    python3 sdbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its per-layer
metrics with the device's busy and traced seconds and a breakdown. Every run
checks the images against the plain reference (``correct``). Exits non-zero,
printing no result, where no CUDA card (or fewer than the cell takes) is visible,
or where JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton"}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args()

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no cell {args.workload!r}; cells: {sorted(cells)}", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    for var, sub in CACHES.items():  # every build cache at a fixed place in the checkout
        os.environ[var] = str(ROOT / "build" / "sdbench" / sub)
    os.environ["USE_FLAX"] = "0"

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"the cell takes {cell['chips']} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2

    sys.path.insert(0, str(ROOT))
    from sdbench import families, harness, traffic

    cfg = families.read(ROOT / next(c["file"] for c in bench["configs"] if c["name"] == cell["config"]))
    settings = json.loads((harness.HERE / "workloads" / f"{cell['name']}.json").read_text())
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = [m for m in bench[kind] if cell["name"] in m.get("workloads", [cell["name"]])]
    out = harness.run(cell, cfg, traffic.load(cell["traffic"]), settings, metrics, args.seed, args.seconds,
                      bool(args.trace), T_START)
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
