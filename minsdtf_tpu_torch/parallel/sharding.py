"""Sharding rules: how weights and activations map onto the ``(data, model)`` mesh.

The counterpart of ``minsdtf_tpu/parallel/sharding.py``, as SPMD:

  - **DP** over ``data``: each rank takes its rows of the batch
    (:func:`shard_batch`) and the results are gathered back (:func:`gather_batch`);
    weights are whole on every data rank.
  - **TP** over ``model``: Megatron column/row parallelism on every attention and
    feed-forward product, in the UNet, the ControlNet and CLIP; convolutions and
    norms stay whole. :func:`shard_module` puts a :class:`ColumnParallelLinear` or
    :class:`RowParallelLinear` holding this rank's slice in place of each matched
    ``nn.Linear``. Megatron's ``f`` (identity forward, all-reduce backward) runs
    before a column product and ``g`` (all-reduce forward, identity backward) after
    a row product, which gives the train step its TP backward.

``param_spec`` and its suffix tables are the JAX package's, name for name. Torch
``Linear`` weights are ``(out, in)``, so the JAX column spec ``P(None, model)``
shards torch dim 0 and the row spec ``P(model, None)`` dim 1 (:func:`shard_dim`).

Three layouts differ from the JAX package's, and no result does:

  - GEGLU: ``ff.net.0.proj`` is column-parallel, but its output is split into a
    value half and a gate half. Rank r holds slice r of *both* halves, and
    ``ff.net.2`` the matching slice of its input; GSPMD reshards JAX's contiguous
    slice for the split, the port slices so that nothing needs resharding.
  - An attention whose head count ``model`` does not divide stays whole: its
    q/k/v/out products run on every rank. That is the single-head VAE attention
    (which ``param_spec`` marks column/row-parallel; it keeps K2 path B, where
    GSPMD splits the head's 512 dims and all-reduces partial scores) and CLIP's
    12 heads at model = 8, where GSPMD shards the 768 columns 96 to a device and
    reshards them for the heads. This is a difference in layout, not in results:
    every rank computes the same attention, and the rest of the layer (the MLP)
    is sharded as in JAX.
  - Fused projections (``to_qkv``/``to_kv``) are refused: under a mesh the
    pipeline does not fuse, as the JAX pipeline fuses only without one.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from minsdtf_tpu_torch.ops.basic import dense
from minsdtf_tpu_torch.parallel import comm
from minsdtf_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_size

# Module-name suffixes that are column-parallel (output dim sharded) / row-parallel
# (input dim sharded) under TP.
_COLUMN_SUFFIXES = (
    ".to_q", ".to_k", ".to_v",
    ".self_attn.q_proj", ".self_attn.k_proj", ".self_attn.v_proj",
    ".ff.net.0.proj", ".mlp.fc1",
)
_ROW_SUFFIXES = (".to_out.0", ".self_attn.out_proj", ".ff.net.2", ".mlp.fc2")
_GEGLU_SUFFIX = ".ff.net.0.proj"  # output = [value | gate]


def param_spec(module: str, leaf: str, ndim: int) -> tuple:
    """The JAX ``PartitionSpec`` of ``params[module][leaf]`` as a tuple; ``()`` is
    replicated."""
    if leaf == "kernel" and ndim == 2:
        if module.endswith(_COLUMN_SUFFIXES):
            return (None, MODEL_AXIS)
        if module.endswith(_ROW_SUFFIXES):
            return (MODEL_AXIS, None)
    if leaf == "bias" and module.endswith(_COLUMN_SUFFIXES):
        return (MODEL_AXIS,)
    return ()


def shard_dim(key: str, ndim: int) -> Optional[int]:
    """The dim of the port's ``state_dict`` tensor ``key`` (``<module>.weight`` /
    ``.bias``) that TP shards, or None: :func:`param_spec` in the torch layout."""
    module, _, leaf = key.rpartition(".")
    spec = param_spec(module, "kernel" if leaf == "weight" else leaf, ndim)
    if not spec:
        return None
    return spec.index(MODEL_AXIS) if leaf == "bias" else 1 - spec.index(MODEL_AXIS)


def shard_tensor(key: str, t: torch.Tensor, rank: int, size: int) -> torch.Tensor:
    """Rank ``rank``'s slice, of ``size``, of the whole tensor ``t`` of ``key``: a
    contiguous slice of the sharded dim, or for GEGLU's projection slice ``rank``
    of each half; ``t`` itself where ``key`` is not sharded."""
    dim = shard_dim(key, t.dim())
    if dim is None or size == 1:
        return t
    halves = 2 if key.rpartition(".")[0].endswith(_GEGLU_SUFFIX) else 1
    parts = []
    for half in t.chunk(halves, dim):
        n = half.shape[dim]
        if n % size:
            raise ValueError(f"{key}: dim {dim} of {tuple(t.shape)} cannot be split "
                             f"over model={size}")
        parts.append(half.narrow(dim, rank * (n // size), n // size))
    return torch.cat(parts, dim).contiguous()


class _CopyToModel(torch.autograd.Function):
    """Megatron's ``f``: the identity forward, an all-reduce of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return comm.all_reduce_sum(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's ``g``: an all-reduce forward, the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return comm.all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class ParallelLinear(nn.Module):
    """This rank's slice of a TP-sharded ``nn.Linear`` (``weight`` is ``(out, in)``),
    named ``name`` in its model, over the process group ``group``."""

    def __init__(self, name: str, weight: torch.Tensor, bias: Optional[torch.Tensor],
                 group, requires_grad: bool = True):
        super().__init__()
        self.name = name
        self.group = group
        self.weight = nn.Parameter(weight, requires_grad=requires_grad)
        self.bias = None if bias is None else nn.Parameter(bias, requires_grad=requires_grad)


class ColumnParallelLinear(ParallelLinear):
    """Output features sharded: ``f`` then this rank's product."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(_CopyToModel.apply(x, self.group), self.weight, self.bias)


class RowParallelLinear(ParallelLinear):
    """Input features sharded: this rank's partial product, ``g``, then the whole
    bias."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _ReduceFromModel.apply(dense(x, self.weight), self.group)
        return y if self.bias is None else y + self.bias.to(y.dtype)


def tp_shard(model: nn.Module, rank: int, size: int, group) -> nn.Module:
    """Megatron TP of ``model`` in place: rank ``rank`` of ``size`` keeps its slice
    of every matched ``nn.Linear``, and every attention (a module with a
    ``num_heads`` attribute) its ``num_heads // size`` heads. An attention whose
    head count ``size`` does not divide stays whole (single-head ones, CLIP's 12
    heads at 8); a fused projection, or a width that ``size`` does not divide
    where the heads do, raise ``ValueError`` before anything changes."""
    if getattr(model, "tp_size", 1) != 1:
        raise ValueError(f"the module is already sharded over model={model.tp_size}")
    if size == 1:
        return model
    whole, heads = [], {}
    for name, m in model.named_modules():
        n = getattr(m, "num_heads", None)
        if n is None:
            continue
        if hasattr(m, "to_qkv") or hasattr(m, "to_kv"):
            raise ValueError(f"{name}: fused attention projections cannot be sharded; "
                             "build the model unfused under a mesh")
        if n % size == 0:
            heads[name] = n // size
        else:
            whole.append(name + ".")
    swaps = {}
    for name, m in model.named_modules():
        if not isinstance(m, nn.Linear) or name.startswith(tuple(whole)):
            continue
        dim = shard_dim(f"{name}.weight", 2)
        if dim is None:
            continue
        weight = shard_tensor(f"{name}.weight", m.weight.detach(), rank, size)
        bias = None if m.bias is None else m.bias.detach()
        if bias is not None:
            bias = shard_tensor(f"{name}.bias", bias, rank, size)
        cls = ColumnParallelLinear if dim == 0 else RowParallelLinear
        swaps[name] = cls(name, weight, bias, group, m.weight.requires_grad)
    for name, n in heads.items():
        model.get_submodule(name).num_heads = n
    for name, layer in swaps.items():
        model.set_submodule(name, layer)
    if swaps:  # a module with nothing to shard (the VAE) stays whole
        model.tp_size = size
    return model


def _check_same_weights(model: nn.Module) -> None:
    """Raises unless every rank of the world holds the same weights as this one:
    a float64 fingerprint of each tensor's sum and sum of squares, weighted by its
    position, all-gathered. SPMD ranks build their weights each on their own (from
    one seed or one file); ranks that did not would compute nonsense quietly."""
    tensors = list(model.state_dict().values())
    if not tensors:
        return
    device = tensors[0].device
    stats = torch.stack([torch.stack([t.double().sum(), t.double().square().sum()]) * (i + 1)
                         for i, t in enumerate(tensors)]).sum(0).to(device)
    every = comm.all_gather(stats[None], None)
    if not bool((every == stats).all()):
        raise ValueError(f"ranks hold different weights: fingerprints {every.tolist()}")


def shard_module(model: nn.Module, mesh) -> nn.Module:
    """:func:`tp_shard` of ``model`` over ``mesh``'s model axis, after checking
    that every rank holds the same weights. Returns ``model``."""
    _check_same_weights(model)
    return tp_shard(model, mesh.get_local_rank(MODEL_AXIS), axis_size(mesh, MODEL_AXIS),
                    mesh.get_group(MODEL_AXIS))


def replicate_module(model: nn.Module, mesh) -> nn.Module:
    """``model`` whole on every rank (sequence parallelism, where the model axis
    carries tokens, not weight shards), after checking that every rank holds the
    same weights. Returns ``model``."""
    if getattr(model, "tp_size", 1) != 1:
        raise ValueError(f"the module is sharded over model={model.tp_size}")
    _check_same_weights(model)
    return model


def shard_batch(x: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """This data rank's rows of ``x`` along ``dim``; ``ValueError`` where the data
    axis does not divide them."""
    n, r = axis_size(mesh, DATA_AXIS), mesh.get_local_rank(DATA_AXIS)
    if x.shape[dim] % n:
        raise ValueError(f"a batch of {x.shape[dim]} cannot be split over data={n}")
    part = x.shape[dim] // n
    return x.narrow(dim, r * part, part)


def gather_batch(x: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """Every data rank's rows of ``x`` along ``dim``, in data-rank order."""
    if axis_size(mesh, DATA_AXIS) == 1:
        return x
    return comm.all_gather(x, mesh.get_group(DATA_AXIS), dim)
