"""Dry run of the multi-device programs on a ``(data, model)`` mesh of n ranks, at
tiny widths: the counterpart of ``__graft_entry__.py`` ``dryrun_multichip``.

    python -m minsdtf_tpu_torch.parallel.dryrun --n 8 [--device cpu]

Spawns n ranks (``gloo``; by default every rank on the current CUDA card, with
``--device cpu`` on the CPU) on ``model = 2`` when n is even, else 1, and runs:

1. the train step under DP x TP (UNet widths (32, 64, 128, 128), fp32);
2. the serving sampler with CFG and the VAE decode, under the same DP x TP
   sharding: its step loop (``sampler._generate_eager``), as the pipeline runs
   it on a mesh;
3. sequence-parallel generation (when model > 1): spatial SP over the model axis
   at a 16x16 latent with ``min_seq=256``, weights whole: the UNet's level 0 and
   every level of the decoder H-sharded, halo-row convs, GroupNorm over the
   axis, the sharded ring; rank 0 also prints the count of each kind of
   collective it made.

Rank 0 prints the JAX script's lines; the exit code is 0 when every part ran.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

SMALL = dict(widths=(32, 64, 128, 128), temb_dim=128)
VAE_DEC = (64, 64, 32, 32)


def _rank(n: int, model: int, device: str) -> list:
    """One rank's three parts; returns the lines rank 0 prints."""
    from minsdtf_tpu_torch import sampler
    from minsdtf_tpu_torch import scheduler as sched_lib
    from minsdtf_tpu_torch.models import unet as unet_lib
    from minsdtf_tpu_torch.models import vae as vae_lib
    from minsdtf_tpu_torch.ops import attention
    from minsdtf_tpu_torch.parallel import comm, sharding
    from minsdtf_tpu_torch.parallel.mesh import make_mesh
    from minsdtf_tpu_torch.training import train_step as ts

    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else torch.device(device)
    lines = []
    mesh = make_mesh(data=n // model, model=model)
    lines.append(f"dryrun_multichip: mesh data={n // model} model={model}")

    # 1. the train step: each rank draws the whole batch from one seed, keeps its rows
    unet = sharding.shard_module(unet_lib.init(dev, seed=0, **SMALL), mesh)
    init_fn, step_fn = ts.make_train_step(mesh=mesh)
    opt = init_fn(unet)
    batch = ts.sample_batch(max(2, n // model), latent_hw=8, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
    batch = ts.TrainBatch(*(sharding.shard_batch(t, mesh) for t in batch))
    loss = step_fn(unet, opt, batch)
    if not torch.isfinite(loss):
        raise RuntimeError(f"train step loss {loss.item()}")
    lines.append(f"dryrun_multichip train step OK: loss={loss.item():.5f}")

    # 2. the serving sampler under DP x TP
    unet = unet_lib.init(dev, seed=2, **SMALL).eval()
    decoder = vae_lib.init_decoder(dev, seed=3, dec_widths=VAE_DEC).eval()
    schedule = sched_lib.build_denoise_schedule(sched_lib.Scheduler(active_tcd=False), 2)
    t_embs = torch.from_numpy(sched_lib.timestep_embedding(schedule.timesteps, dim=32)).to(dev)
    rng = np.random.RandomState(0)
    batch_b = max(2, n // model)
    latent0, ctx, unc = (torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(dev)
                         for shape in ((batch_b, 8, 8, 4), (batch_b, 77, 768),
                                       (batch_b, 77, 768)))

    def serve(u, d, l0, c, uc):  # the step loop: a mesh's collectives cannot be captured
        return sampler._generate_eager(u, d, l0, c, uc, t_embs, schedule.rows, 7.5, 0.7)

    sharded_unet = sharding.shard_module(unet, mesh)
    sharded_decoder = sharding.shard_module(decoder, mesh)
    img, _ = serve(sharded_unet, sharded_decoder,
                   *(sharding.shard_batch(t, mesh) for t in (latent0, ctx, unc)))
    img = sharding.gather_batch(img, mesh)
    if img.shape != (batch_b, 64, 64, 3) or img.dtype != torch.uint8:
        raise RuntimeError(f"serving image {tuple(img.shape)} {img.dtype}")
    lines.append(f"dryrun_multichip serving (sampler.generate, DP x TP) OK: image "
                 f"{tuple(img.shape)}")

    # 3. spatial sequence parallelism over the model axis
    if model > 1:
        unet = sharding.replicate_module(unet_lib.init(dev, seed=2, **SMALL).eval(), mesh)
        decoder = sharding.replicate_module(decoder, mesh)
        lat_sp = torch.from_numpy(rng.normal(0, 1, (1, 16, 16, 4)).astype(np.float32)).to(dev)
        comm.reset_stats()
        with attention.sequence_parallel_scope(mesh, "model", min_seq=256):
            img_sp, _ = serve(unet, decoder, lat_sp, ctx[:1], unc[:1])
        if img_sp.shape != (1, 128, 128, 3) or comm.stats["halo"]["calls"] == 0:
            raise RuntimeError(f"sequence-parallel image {tuple(img_sp.shape)}, "
                               f"{comm.stats['halo']['calls']} halo exchanges")
        lines.append(f"dryrun_multichip sequence-parallel (spatial, ring attention) OK: image "
                     f"{tuple(img_sp.shape)}")
        lines.append("dryrun_multichip sequence-parallel collectives: " + ", ".join(
            f"{kind} {entry['calls']}" for kind, entry in comm.stats.items()))
    lines.append("dryrun_multichip OK")
    return lines


def dryrun(n: int, device: str = "cuda", timeout_s: float = 600.0) -> list:
    """The three parts on ``n`` ranks; returns rank 0's lines."""
    from minsdtf_tpu_torch.parallel.mesh import run_ranks

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
    model = 2 if n % 2 == 0 and n > 1 else 1
    return run_ranks(_rank, n, args=(n, model, device), device=device,
                     timeout_s=timeout_s)[0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=8, help="ranks (default 8)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--timeout", type=float, default=600.0, help="seconds for all ranks")
    args = parser.parse_args(argv)
    for line in dryrun(args.n, args.device, args.timeout):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
