"""The sweep that sets an open-loop cell's rate: one set-up, the time of one
full merged batch through the worker, then one window at each rate, on the
cell's own arrival order (the mix's ``arrival_seed``, the window's stream), each
with requests of its own. For each rate it prints the requests due and
finished, the latency percentiles, the longest wait, and whether the queue held:
every request finished and none waited longer than ``WAIT_BATCHES`` full
batches (the one in flight ahead of it and its own). A backlog that grows
through the window pushes the longest wait past that.

    python3 sdbench/sweep.py --workload <cell> --seed <n> --seconds <s> --rates <r> [<r> ...]

The knee is the highest rate at and below which every line ``holds``; the
cell's mix holds a rate of about four fifths of it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
WAIT_BATCHES = 2
BATCH_STREAM = 9  # the requests of the timed full batch


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--rates", type=float, nargs="+", required=True)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    from sdbench import families, harness, traffic  # noqa: PLC0415

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    cfg = families.read(ROOT / next(c["file"] for c in bench["configs"] if c["name"] == cell["config"]))
    settings = json.loads((ROOT / "sdbench" / "workloads" / f"{cell['name']}.json").read_text())
    mix = traffic.load(cell["traffic"])
    run = harness.Cell(cell, cfg, mix, settings, args.seed)
    run.setup(time.perf_counter())
    full = harness._take(traffic.closed(mix, args.seed, BATCH_STREAM), run.worker.max_batch)
    t0 = time.perf_counter()
    run._serve_burst(full)
    wait_bound = WAIT_BATCHES * (time.perf_counter() - t0)
    print(json.dumps({"full_batch": len(full), "wait_bound_s": wait_bound}), flush=True)
    holds = True
    for i, rate in enumerate(args.rates):
        mix["rate_per_s"] = rate
        due, done, late = run.open_window(args.seconds, stream=10 + i, order_stream=traffic.WINDOW)
        lat = harness.latencies(due, done)
        ok = np.isfinite(lat)
        longest = float(lat[ok].max()) if ok.any() else None
        holds = holds and bool(ok.all()) and longest <= wait_bound
        print(json.dumps({"rate_per_s": rate, "due": len(due), "finished": int(ok.sum()),
                          "latency_p50_s": harness.percentile(lat, 50),
                          "latency_p90_s": harness.percentile(lat, 90),
                          "latency_max_s": longest, "holds": holds,
                          "latest_send_s": max(late)}), flush=True)
    run.teardown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
