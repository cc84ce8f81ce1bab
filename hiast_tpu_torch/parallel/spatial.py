"""Image rows sharded over the ``space`` axis: halos, gathers and the
row-sharded forms of the layers that read across rows.

The port's counterpart of what GSPMD inserts for JAX's ``space`` axis
(``hiast_tpu/parallel/mesh.py:shard_batch`` puts every leaf of rank 3 or
more on ``P('data', 'space')``) and of ``hiast_tpu/parallel/hints.py``.
Each rank of a space group holds a contiguous slab of every image's rows,
all slabs of one height (``mesh.check_mesh``), in rank order.

- ``halo_rows`` joins the neighbours' border rows onto a slab (the image's
  top and bottom get a pad value), by one all-gather of border rows within
  the space group, which gloo and NCCL both run.  A halo deeper than a
  slab takes rows from as many ranks as it needs.  Its backward sends each
  halo row's gradient back to its owner (an all-reduce of the border
  gradients) and adds it onto the owner's rows.
- ``gather_rows`` returns the whole tensor in global row order (the SRA
  attention's K/V, the port's ``constrain_space_replicated``); its backward
  sums the gradient over the group and keeps the rank's own slab.
- ``convert_spatial`` makes a model's convolutions and max-pools read their
  halos (``SpatialConv2d``, ``SpatialMaxPool2d``) and DeepLab-v2's ASPP
  exchange its input once at its deepest dilation (``SpatialASPPV2``).
- ``resize_rows`` is the bilinear resize of a slab with global coordinates.

Every module and function here acts on slabs only while ``sharded_rows``
holds the group, a process-wide setting (the backward and a remat rerun
run on autograd's threads, and read it there too); outside it a converted
model is the plain one.  bf16 rows travel as bytes and gradients are
summed in float32.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

_state = {"group": None}


def rows_group():
    """The space group whose ranks hold row slabs of every image tensor, or
    None (images whole)."""
    return _state["group"]


@contextlib.contextmanager
def sharded_rows(group):
    """Image tensors are row slabs over ``group`` inside (None: a no-op)."""
    previous = _state["group"]
    _state["group"] = group
    try:
        yield
    finally:
        _state["group"] = previous


def slabs() -> int:
    """How many slabs each image's rows are split into."""
    group = rows_group()
    return 1 if group is None else dist.get_world_size(group)


def _ranks(group) -> tuple[int, int]:
    return dist.get_rank(group), dist.get_world_size(group)


def _all_gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``t`` in rank order (other types than gloo's as bytes)."""
    wire = t.contiguous()
    if wire.dtype not in (torch.float32, torch.float64, torch.int32, torch.int64, torch.uint8):
        wire = wire.view(torch.uint8)
    parts = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, wire, group=group)
    return [p.view(t.dtype) for p in parts]


def _summed(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``, in float32 or wider, in ``t``'s dtype."""
    wide = t.float() if t.dtype in (torch.bfloat16, torch.float16) else t.clone()
    dist.all_reduce(wide, group=group)
    return wide.to(t.dtype)


def sum_over_rows(t: torch.Tensor) -> torch.Tensor:
    """A per-image partial sum ``t`` (no gradient) summed over the slabs."""
    group = rows_group()
    return t if group is None else _summed(t, group)


def _halo_plan(h: int, s: int, n: int, above: int, below: int):
    """Where each halo row comes from: (top, bottom, rows_above,
    rows_below).  Each rank sends its first ``top`` rows (the halo below of
    the ranks over it) and its last ``bottom`` rows; each halo is a list of
    (owner, first, stop) ranges of the owner's ``top + bottom`` border rows
    (owner None: pad rows)."""
    top, bottom = min(below, h), min(above, h)

    def ranges(rows):
        out = []
        for g in rows:
            if g < 0 or g >= n * h:
                owner, i = None, 0
            else:
                owner = g // h
                i = g % h if g >= (s + 1) * h else top + g % h - (h - bottom)
            if out and out[-1][0] == owner and (owner is None or out[-1][2] == i):
                out[-1][2] += 1
            else:
                out.append([owner, i, i + 1])
        return out

    return top, bottom, ranges(range(s * h - above, s * h)), ranges(range((s + 1) * h, (s + 1) * h + below))


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, above, below, group, pad):
        s, n = _ranks(group)
        h = x.shape[2]
        top, bottom, rows_above, rows_below = _halo_plan(h, s, n, above, below)
        parts = _all_gather(torch.cat([x[:, :, :top], x[:, :, h - bottom:]], 2), group)

        def rows(ranges):
            return [x.new_full((*x.shape[:2], j - i, x.shape[3]), pad) if owner is None
                    else parts[owner][:, :, i:j] for owner, i, j in ranges]

        ctx.plan = (s, n, top, bottom, rows_above, rows_below, group)
        return torch.cat(rows(rows_above) + [x] + rows(rows_below), 2)

    @staticmethod
    def backward(ctx, dy):
        s, n, top, bottom, rows_above, rows_below, group = ctx.plan
        above = sum(j - i for _, i, j in rows_above)
        h = dy.shape[2] - above - sum(j - i for _, i, j in rows_below)
        dx = dy[:, :, above:above + h].clone()
        sent = dy.new_zeros((n, dy.shape[0], dy.shape[1], top + bottom, dy.shape[3]), dtype=torch.float32)
        at = 0
        for owner, i, j in rows_above + rows_below:
            if at == above:
                at += h  # past the slab
            if owner is not None:
                sent[owner, :, :, i:j] += dy[:, :, at:at + j - i].float()
            at += j - i
        dist.all_reduce(sent, group=group)
        mine = sent[s].to(dx.dtype)
        dx[:, :, :top] += mine[:, :, :top]
        dx[:, :, h - bottom:] += mine[:, :, top:]
        return dx, None, None, None, None


def halo_rows(x: torch.Tensor, above: int, below: int, pad: float = 0.0) -> torch.Tensor:
    """[B, C, h, W] slab -> [B, C, above + h + below, W]: the ``above`` rows
    over this slab and the ``below`` rows under it joined on, ``pad``
    beyond the image.  Every rank of ``rows_group()`` calls it with the
    same sizes."""
    return x if above == below == 0 else _Halo.apply(x, above, below, rows_group(), pad)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.n = dim, group, x.shape[dim]
        return torch.cat(_all_gather(x, group), dim)

    @staticmethod
    def backward(ctx, dy):
        s, _ = _ranks(ctx.group)
        return _summed(dy, ctx.group).narrow(ctx.dim, s * ctx.n, ctx.n), None, None


def gather_rows(x: torch.Tensor, dim: int = 2) -> torch.Tensor:
    """The whole tensor from the slabs of its ``dim`` axis, in global order
    (the identity with images whole)."""
    group = rows_group()
    return x if group is None else _Gather.apply(x, dim, group)


def resize_rows(x: torch.Tensor, out_h: int, out_w: int, align_corners: bool) -> torch.Tensor:
    """The bilinear resize of a slab: ``x`` [B, C, h, W] holds global rows
    [s h, (s + 1) h) of an image of ``n h`` rows, and the result output rows
    [s out_h, (s + 1) out_h) of ``n out_h``, in float32.  Each output row
    reads its two source rows by their global coordinates; the rows other
    slabs hold come through ``halo_rows``.  Columns first, as
    ``F.interpolate`` combines them."""
    from hiast_tpu_torch.ops.resize import resize_cols, source_index

    group = rows_group()
    s, n = _ranks(group)
    h = x.shape[2]
    x = resize_cols(x.float(), out_w, align_corners)
    if out_h == h:
        return x
    i0, i1, w1 = source_index(n * h, n * out_h, align_corners, torch.arange(n * out_h))
    first = [int(i0[r * out_h:(r + 1) * out_h].min()) for r in range(n)]
    last = [int(i1[r * out_h:(r + 1) * out_h].max()) for r in range(n)]
    above = max(max(r * h - first[r] for r in range(n)), 0)
    below = max(max(last[r] - ((r + 1) * h - 1) for r in range(n)), 0)
    xh = halo_rows(x, above, below)
    mine = slice(s * out_h, (s + 1) * out_h)
    offset = above - s * h
    w1 = w1[mine].to(x.device).view(1, 1, -1, 1)
    r0 = xh.index_select(2, (i0[mine] + offset).to(x.device))
    r1 = xh.index_select(2, (i1[mine] + offset).to(x.device))
    return r0 * (1.0 - w1) + r1 * w1


def conv_halo(kernel: int, stride: int, padding: int, dilation: int) -> tuple[int, int]:
    """(above, below): the rows a slab of a multiple of ``stride`` rows needs
    around it for a window of ``kernel`` taps ``dilation`` apart, at
    ``stride`` with ``padding``, to give its own output rows."""
    return padding, max((kernel - 1) * dilation - padding - stride + 1, 0)


def _check_stride(x: torch.Tensor, stride: int, what: str) -> None:
    if x.shape[2] % stride:
        raise ValueError(f"a slab of {x.shape[2]} rows does not start each rank's rows on the stride {stride} "
                         f"of {what}; use image rows that split into slabs of a multiple of the model's row stride")


class SpatialConv2d(nn.Conv2d):
    """``nn.Conv2d`` on a slab: its halo, then the convolution without row
    padding, the column padding as it was."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if rows_group() is None:
            return super().forward(x)
        if self.padding_mode != "zeros" or isinstance(self.padding, str):
            raise ValueError("a row-sharded convolution pads with zeros, by a number of rows")
        stride = self.stride[0]
        _check_stride(x, stride, "a convolution")
        above, below = conv_halo(self.kernel_size[0], stride, self.padding[0], self.dilation[0])
        y = F.conv2d(halo_rows(x, above, below), self.weight, self.bias, self.stride,
                     (0, self.padding[1]), self.dilation, self.groups)
        return y[:, :, :x.shape[2] // stride]


class SpatialMaxPool2d(nn.MaxPool2d):
    """``nn.MaxPool2d`` on a slab: a halo padded with -inf, as the pool's own
    padding is."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if rows_group() is None:
            return super().forward(x)
        pair = lambda v: (v, v) if isinstance(v, int) else tuple(v)  # noqa: E731
        (k, _), (stride, _), (p, pw), (d, _) = (pair(v) for v in (self.kernel_size, self.stride or self.kernel_size,
                                                                   self.padding, self.dilation))
        if self.ceil_mode:
            raise ValueError("a row-sharded max-pool takes floor mode")
        _check_stride(x, stride, "a max-pool")
        above, below = conv_halo(k, stride, p, d)
        y = F.max_pool2d(halo_rows(x, above, below, float("-inf")), self.kernel_size,
                         self.stride, (0, pw), self.dilation)
        return y[:, :, :x.shape[2] // stride]


def convert_spatial(module: nn.Module) -> nn.Module:
    """Make ``module`` run on slabs while ``sharded_rows`` holds a group, in
    place, keeping its parameters and names (the pattern of
    ``models/norm.py:convert_synced``): every ``nn.Conv2d`` that reads
    across rows becomes a ``SpatialConv2d``, every ``nn.MaxPool2d`` a
    ``SpatialMaxPool2d``, DeepLab-v2's ASPP a ``SpatialASPPV2``.  Modules
    that read no neighbouring row (1x1 convolutions at stride 1, Linear,
    LayerNorm) stay; BatchNorm is the synced one (``convert_synced``)."""
    from hiast_tpu_torch.models.deeplab_v2 import ASPPV2, SpatialASPPV2

    for m in module.modules():
        if type(m) is ASPPV2:
            m.__class__ = SpatialASPPV2
        elif type(m) is nn.Conv2d and (m.kernel_size[0] > 1 or m.stride[0] > 1):
            m.__class__ = SpatialConv2d
        elif type(m) is nn.MaxPool2d:
            m.__class__ = SpatialMaxPool2d
    return module
