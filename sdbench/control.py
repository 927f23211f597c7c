"""The control of the comparison that decides ``correct``: the reference put in
the program's place and computed one precision below the configuration's
(bfloat16 -> float8 e4m3, every product's inputs rounded with a per-tensor
scale), run through the harness's own run (``harness.run``): its window, its
sample of requests, its comparison with the fp32 reference and its verdict. Its
readings are the upper end of each limit; it must come out not correct. The
benchmark's runs do not run it.

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

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
CONTROL_OPS = {"bfloat16": "Fp8Ops"}  # the configuration's dtype -> the products one precision below


class ReferencePipe:
    """The reference in the program's place: the library's entry points that
    the harness (``text_to_image``) and the serving worker (``_encode_text_dev``,
    ``encode_text``, ``generate_image``) call, with the library's meaning of
    their arguments."""

    def __init__(self, ref, mix: dict, device):
        self.ref, self.mix = ref, mix
        self.img_height, self.img_width = mix["height"], mix["width"]
        self.device = torch.device(device)
        self.bpe_path = "reference"
        self.sampler = mix.get("scheduler", "ddim")

    def _encode_text_dev(self, prompt: str) -> torch.Tensor:
        return self.ref.context(prompt)

    def encode_text(self, prompt: str) -> np.ndarray:
        return self.ref.context(prompt).cpu().numpy()

    def text_to_image(self, prompt, batch_size=1, num_steps=50, unconditional_guidance_scale=7.5,
                      guidance_rescale=0.7, seed=None, control_net_image=None):
        return self.ref.text_to_image(prompt, seed, self.img_height, self.img_width, num_steps,
                                      unconditional_guidance_scale, guidance_rescale, control_net_image,
                                      batch_size, self.sampler)

    def generate_image(self, encoded_text, negative_prompt=None, batch_size=1, num_steps=50,
                       unconditional_guidance_scale=7.5, diffusion_noise=None, seed=None, guidance_rescale=0.0,
                       _defer_fetch=False):
        from sdbench.reference import philox  # noqa: PLC0415

        if negative_prompt:
            raise ValueError("the control takes no negative prompt")
        context = torch.as_tensor(encoded_text, dtype=torch.float32).to(self.device)
        context = context[None] if context.dim() == 2 else context
        noise = (np.asarray(diffusion_noise, np.float32) if diffusion_noise is not None else
                 philox.stateless_normal((batch_size, self.img_height // 8, self.img_width // 8, 4), seed))
        return self.ref.generate(context, noise, num_steps, unconditional_guidance_scale, guidance_rescale,
                                 sampler=self.sampler, step_seed=seed)


def make_pipe(cfg: dict, weights: dict, mix: dict, device, merges: str, compute_dtype=None) -> ReferencePipe:
    """``harness.Cell``'s ``make_pipe``: the reference on the benchmark's weights,
    its products one precision below the configuration's."""
    from sdbench.reference import models  # noqa: PLC0415
    from sdbench.reference.pipeline import Reference  # noqa: PLC0415

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ops = getattr(models, CONTROL_OPS[cfg["dtype"]])()
    return ReferencePipe(Reference(cfg, weights, merges, device, ops), mix, device)


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
    from sdbench import traffic  # noqa: PLC0415

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    cfg = json.loads((ROOT / next(c["file"] for c in bench["configs"] if c["name"] == cell["config"])).read_text())
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
