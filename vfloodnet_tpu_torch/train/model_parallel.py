"""Column-parallel convolutions over the mesh's ``model`` axis: the
collectives behind the video trainer's tensor-parallel layout
(``train_video.param_sharding_rules`` / ``shard_train_state``, the JAX
trainer's GSPMD layout of its conv kernels over ``model``).

A sharded convolution keeps on each model rank a contiguous slice of
its output channels. Its forward convolves the full input with that
slice, all-gathers the slices along the channels over the model group
and adds the (replicated) bias after the gather, so every model rank
holds the full output and computes the rest of the network as
replicated work. In the backward pass the gather keeps the rank's slice
of the output's gradient (the kernel's gradient is thus the slice's),
and the input's gradient, partial on each rank, is summed over the
model group. :func:`gather_shards` rebuilds the full tensors (for
checkpoints, which hold full tensors so that a run resumes on any
mesh).
"""

from __future__ import annotations

import types
from typing import List

import torch
import torch.distributed as dist
import torch.nn as nn

from ..models.resnet import Conv2d


class _SumGradOverGroup(torch.autograd.Function):
    """The identity, whose gradient is summed over a process group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class _GatherChannels(torch.autograd.Function):
    """Every rank's slice of the channels (axis -3) of ``y``, concatenated
    in group-rank order; the gradient is this rank's slice."""

    @staticmethod
    def forward(ctx, y, group, index):
        n = dist.get_world_size(group)
        ctx.index, ctx.per = index, y.shape[-3]
        parts = [torch.empty_like(y) for _ in range(n)]
        dist.all_gather(parts, y.contiguous(), group=group)
        return torch.cat(parts, dim=-3)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.index * ctx.per
        return g[..., lo:lo + ctx.per, :, :].contiguous(), None, None


def _column_parallel_forward(self, x: torch.Tensor) -> torch.Tensor:
    """``forward`` of a sharded ``Conv2d`` (``self.weight`` is its slice
    of the output channels)."""
    cd = self.compute_dtype
    x = _SumGradOverGroup.apply(x.to(cd), self.model_group)
    y = self._conv_forward(x, self.weight.to(cd), None)
    y = _GatherChannels.apply(y, self.model_group, self.model_index)
    if self.bias is not None:
        y = y + self.bias.to(cd)[:, None, None]
    return y


def make_column_parallel(conv: Conv2d, group, index: int,
                         size: int) -> slice:
    """Keep slice ``index`` of ``size`` of ``conv``'s output channels as
    its weight and make its forward column-parallel over ``group``;
    returns the slice."""
    if not isinstance(conv, Conv2d) or conv.groups != 1 \
            or conv.padding_mode != "zeros":
        raise ValueError("only the models' plain Conv2d is sharded by its "
                         "output channels")
    per = conv.weight.shape[0] // size
    part = slice(index * per, (index + 1) * per)
    conv.weight = nn.Parameter(conv.weight.detach()[part].clone())
    conv.model_group, conv.model_index = group, index
    conv.forward = types.MethodType(_column_parallel_forward, conv)
    return part


def gather_shards(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Each tensor's slices (along axis 0) of every rank of ``group``,
    concatenated in group-rank order."""
    out = []
    n = dist.get_world_size(group)
    for t in tensors:
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.detach().contiguous(), group=group)
        out.append(torch.cat(parts))
    return out
