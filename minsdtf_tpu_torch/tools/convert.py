"""CLI: convert PyTorch / safetensors checkpoints into the port's converted-weights
caches ahead of time.

    python -m minsdtf_tpu_torch.tools.convert --unet model.safetensors \
        --vae vae.safetensors --text-encoder te.safetensors [--controlnet cn.pth] \
        [--lora lora.safetensors] [--out-dir converted/]

Writes ``<checkpoint>.minsdtf-torch-<kind>.pt`` beside each source file (not with
``--lora``: a LoRA-merged load is never cached), so a pipeline's first load maps
the converted fp32 ``state_dict`` instead of converting. ``--out-dir`` also writes
each converted (LoRA-merged, with ``--lora``) ``state_dict`` there as
``<kind>.pt`` with ``torch.save``; the VAE's is an ``(encoder, decoder)`` pair.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--unet")
    parser.add_argument("--vae")
    parser.add_argument("--text-encoder", dest="text_encoder")
    parser.add_argument("--controlnet")
    parser.add_argument("--lora")
    parser.add_argument("--out-dir", dest="out_dir", default=None,
                        help="also write the converted state dicts here")
    args = parser.parse_args(argv)

    import torch

    from minsdtf_tpu_torch.weights import convert, lora as lora_lib

    te_lora = unet_lora = None
    if args.lora:
        te_lora, unet_lora = lora_lib.load_lora(args.lora)
        print(f"lora: {len(te_lora)} text-encoder + {len(unet_lora)} unet deltas")

    jobs = [
        ("unet", args.unet, unet_lora),
        ("vae", args.vae, None),
        ("text_encoder", args.text_encoder, te_lora),
        ("controlnet", args.controlnet, None),
    ]
    for kind, path, lora in jobs:
        if not path:
            continue
        print(f"converting {kind} from {path}")
        state = convert.convert_cached(kind, path, lora=lora)
        parts = state if isinstance(state, tuple) else (state,)
        n = sum(t.numel() for part in parts for t in part.values())
        print(f"  {kind}: {sum(len(p) for p in parts)} tensors, {n / 1e6:.1f}M params")
        if args.out_dir:
            os.makedirs(args.out_dir, exist_ok=True)
            out = os.path.join(args.out_dir, f"{kind}.pt")
            torch.save(state, out)
            print(f"  wrote {out}")


if __name__ == "__main__":
    main()
