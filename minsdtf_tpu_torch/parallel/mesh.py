"""The ``(data, model)`` mesh, and the processes it runs on.

The counterpart of ``minsdtf_tpu/parallel/mesh.py``. The JAX package runs one
controller over GSPMD; the port runs SPMD over ``torch.distributed``: one process
per rank, each making the same calls (the ``torchrun`` model). Axes:

  - ``data``: the image batch; DP, no weight traffic;
  - ``model``: attention heads and the feed-forward hidden width; Megatron TP
    (:mod:`minsdtf_tpu_torch.parallel.sharding`), or, for sequence-parallel
    generation, the self-attention token axis (:mod:`ops.ring_attention`).

:func:`init_process` joins a process to its group, :func:`make_mesh` lays the
world out as a :class:`torch.distributed.device_mesh.DeviceMesh`, and
:func:`run_ranks` starts one process per rank and collects what each returns.
NCCL takes one GPU per rank; ranks that share a GPU (the one-card machine) run
``gloo``.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from minsdtf_tpu_torch.parallel import comm

DATA_AXIS = "data"
MODEL_AXIS = "model"


def init_process(rank: int, world: int, init_method: str, backend: str = "gloo",
                 device: str = "cpu") -> torch.device:
    """Join the process group as ``rank`` of ``world`` (``init_method`` is a
    ``file://`` or ``tcp://localhost:<port>`` store) and return this rank's device:
    the CPU, or the current CUDA device (``device="cuda"``; ``"cuda:i"`` selects
    card i first). The group's timeout is :data:`.comm.TIMEOUT`, as every wait of
    :mod:`.comm` is."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is not None:
            torch.cuda.set_device(dev)
        dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=comm.TIMEOUT)
    return dev


def make_mesh(data: Optional[int] = None, model: int = 1,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A ``(data, model)`` mesh over the initialized world; ``data`` defaults to
    world // model. ``device_type`` defaults to CUDA under NCCL and to the CPU
    under ``gloo``, whose groups take CPU and CUDA tensors alike (the mesh's
    device type only places DTensors, which the port does not use)."""
    n = dist.get_world_size()
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (data, model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def _rank_main(rank: int, fn: Callable, args: Sequence, world: int, init_method: str,
               backend: str, device: str, out_dir: str) -> None:
    torch.set_num_threads(1)  # ranks share the host's cores
    init_process(rank, world, init_method, backend, device)
    try:
        result = fn(*args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, args: Sequence = (), backend: str = "gloo",
              device: str = "cpu", timeout_s: float = 600.0) -> List[Any]:
    """Run ``fn(*args)`` in ``world`` new processes (``torch.multiprocessing``,
    spawned), each joined to one group over a ``file://`` store in a temporary
    directory, with one torch thread; returns each rank's result in rank
    order. ``fn`` must be importable by name and return something ``torch.save``
    takes. Any rank's failure, or ``timeout_s`` passing, ends every rank and
    raises."""
    with tempfile.TemporaryDirectory(prefix="minsdtf-ranks-") as tmp:
        store = "file://" + os.path.join(tmp, "store")
        ctx = mp.start_processes(
            _rank_main, args=(fn, tuple(args), world, store, backend, device, tmp),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"run_ranks: {world} ranks still running after "
                                       f"{timeout_s:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(10)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
