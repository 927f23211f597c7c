"""Spatial sequence parallelism: operations on H-sharded (B, C, H, W) activations,
channels-last in memory as the models keep them, and channels-last out.

Under :func:`minsdtf_tpu_torch.ops.attention.sequence_parallel_scope` every
activation at a resolution that :func:`~minsdtf_tpu_torch.ops.attention.spatial_sharded`
admits stays H-sharded over the SP axis: rank r of its group holds rows
``[r*H/n, (r+1)*H/n)``, and its (B, S, C) tokens are the matching contiguous
slice of S. This is what GSPMD makes of the JAX package's ``constrain_spatial``
and ``constrain_tokens`` anchors (``minsdtf_tpu/ops/attention.py:69-101``;
``tests/test_sequence_parallel_hlo.py`` pins it), written out:

  - :func:`halo_conv2d`: the rows a kernel needs from the neighbours arrive in
    one all-gather of edge rows (:func:`.comm.halo_exchange`), then the ordinary
    convolution runs with no H padding; zeros pad only the global top and bottom;
  - :func:`group_norm`: two passes as ``minsdtf_tpu/ops/basic.py:292-295`` makes
    them, the fp32 mean and then the fp32 variance each from a sum all-reduced
    over the group and divided by the global count;
  - :func:`upsample2x_conv3x3`: the upsampler into an eligible level computes
    this rank's output rows only;
  - :func:`local_rows` and :func:`gather_rows`: into and out of the layout.

The models decide which levels are sharded from the global size
(:func:`plan`) and pass a flag down; 1x1 convs, LayerNorm, GEGLU and the
elementwise work run on the local rows as they are. :data:`calls` counts each
function's calls (``reset_calls`` zeroes them); the collectives count in
:data:`.comm.stats`.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from minsdtf_tpu_torch.ops import attention
from minsdtf_tpu_torch.ops.basic import Padding, _pads, silu as silu_fn, stats_dtype
from minsdtf_tpu_torch.parallel import comm

calls = {name: 0 for name in ("local_rows", "gather_rows", "halo_conv2d", "group_norm",
                              "upsample2x_conv3x3")}


def reset_calls() -> None:
    for name in calls:
        calls[name] = 0


def plan(h: int, w: int, levels: int, up: bool = False) -> Tuple[bool, ...]:
    """Which of ``levels`` resolutions are H-sharded, from the global size ``h`` x
    ``w`` of level 0: each level halves it (``up``: doubles it)."""
    sizes = [(h << l, w << l) if up else (h >> l, w >> l) for l in range(levels)]
    return tuple(attention.spatial_sharded(*hw) for hw in sizes)


def _axis():
    """(group, n, r) of this thread's SP axis."""
    group = attention.sequence_parallel_group()
    if group is None:
        raise RuntimeError("an H-sharded activation outside sequence_parallel_scope")
    return group, dist.get_world_size(group), dist.get_rank(group)


def _rows(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Rows ``[lo, hi)`` of ``x``, zero rows where they fall outside it."""
    h = x.shape[2]
    out = x[:, :, max(lo, 0):min(hi, h)]
    if lo < 0 or hi > h:
        out = F.pad(out, (0, 0, max(-lo, 0), max(hi - h, 0)))
    return out


def local_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of the whole (B, C, H, W) ``x``. No transfer."""
    _, n, r = _axis()
    calls["local_rows"] += 1
    part = x.shape[2] // n
    return x[:, :, r * part:(r + 1) * part]


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The whole (B, C, H, W) tensor from every rank's rows: an all-gather along H,
    channels-last from channels-last rows (:func:`.comm.all_gather`), as the whole
    levels after it take it (their GroupNorm kernel on the card takes NHWC memory
    only)."""
    group, _, _ = _axis()
    calls["gather_rows"] += 1
    return comm.all_gather(x, group, dim=2)


def _conv_rows(conv, x: torch.Tensor, stride: int, left: int, right: int) -> torch.Tensor:
    """``conv`` over rows that already hold their halo: no H padding."""
    weight, bias = conv.weight.to(x.dtype), None if conv.bias is None else conv.bias.to(x.dtype)
    if left == right:
        return F.conv2d(x, weight, bias, stride=stride, padding=(0, left))
    return F.conv2d(F.pad(x, (left, right)), weight, bias, stride=stride)


def halo_conv2d(conv, x: torch.Tensor, stride: int = 1, padding: Padding = 1,
                whole_input: bool = False) -> torch.Tensor:
    """``conv`` (an ``nn.Conv2d``) on this rank's rows of an H-sharded
    activation, giving this rank's output rows in its layout. A kernel of k rows at stride s
    with top padding p needs p rows from the rank above and k - s - p from the
    rank below: 1 and 1 for the 3x3 stride-1 convs, 1 and 0 for the UNet's
    downsampler (stride 2, padding 1), 0 and 1 for the VAE encoder's (stride 2,
    padding ``((0, 1), (0, 1))``). With ``whole_input`` ``x`` is whole on every
    rank and the rows are read from it, with no transfer."""
    group, n, r = _axis()
    calls["halo_conv2d"] += 1
    (top, _), (left, right) = _pads(padding)
    bottom = conv.weight.shape[2] - stride - top
    if whole_input:
        part = x.shape[2] // n
        rows = _rows(x, r * part - top, (r + 1) * part + bottom)
    else:
        above, below = comm.halo_exchange(x, group, top, bottom)
        rows = comm.cat_rows([above, x, below])
    return _conv_rows(conv, rows, stride, left, right)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, silu: bool = False,
               num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm of an H-sharded activation with the whole image's statistics: the
    fp32 mean from the group's all-reduced sum, then the fp32 variance from the
    all-reduced sum of squared deviations, each over the global count; the affine
    in fp32, the cast, then SiLU when ``silu`` (as ``ops.basic.group_norm_silu``).
    Computed over the NHWC view, so channels-last rows are read in place, and the
    output is channels-last in any case."""
    group, n, _ = _axis()
    calls["group_norm"] += 1
    wide = stats_dtype(x.dtype)
    b, c, h, w = x.shape
    xf = x.to(wide).permute(0, 2, 3, 1).reshape(b, h * w, num_groups, c // num_groups)
    count = h * w * (c // num_groups) * n  # every rank holds H/n of the rows
    mean = comm.all_reduce_sum(xf.sum((1, 3)), group) / count
    dev = xf - mean[:, None, :, None]
    var = comm.all_reduce_sum(dev.square().sum((1, 3)), group) / count
    out = (dev * torch.rsqrt(var + eps)[:, None, :, None]).reshape(b, h, w, c)
    out = (out * weight.to(wide) + bias.to(wide)).to(x.dtype).permute(0, 3, 1, 2)
    return silu_fn(out) if silu else out


def upsample2x_conv3x3(conv, x: torch.Tensor, whole_input: bool) -> torch.Tensor:
    """The nearest-2x upsampler and its 3x3 conv into an H-sharded level: this
    rank's output rows. A whole ``x`` (a level that is not sharded) is read at this
    rank's input rows plus one on each side, with no transfer; a sharded ``x``
    takes those side rows from its neighbours (one halo exchange)."""
    group, n, r = _axis()
    calls["upsample2x_conv3x3"] += 1
    if whole_input:
        h = x.shape[2]
        rows = 2 * h // n
        a, b = r * rows, (r + 1) * rows  # this rank's upsampled rows; the conv reads a-1 .. b
        lo, hi = (a - 1) // 2, b // 2 + 1
        up = F.interpolate(_rows(x, lo, hi), scale_factor=2, mode="nearest")  # rows 2lo ..
        up = up[:, :, a - 1 - 2 * lo:b + 1 - 2 * lo]
    else:
        above, below = comm.halo_exchange(x, group, 1, 1)
        up = F.interpolate(comm.cat_rows([above, x, below]), scale_factor=2, mode="nearest")
        up = up[:, :, 1:-1]
    return _conv_rows(conv, up, 1, 1, 1)
