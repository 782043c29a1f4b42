"""Megatron tensor-parallel collectives over one tp process group.

A tp rank holds a slice of every split weight; these autograd functions
put the collectives where XLA derives them from the JAX package's
PartitionSpecs (capdec_tpu/parallel/mesh.py:57-98):

  * `copy_in`: identity forward, all-reduce backward. It sits where a
    replicated activation enters a split layer, so each rank's partial
    input gradient is summed.
  * `reduce_out`: all-reduce forward, identity backward. It sums the
    partial products of a layer whose input dimension is split (row
    parallel: GPT-2's two `c_proj`s), before the replicated bias.
  * `gather_out`: all-gather forward on the last dimension, this rank's
    slice backward. It joins the outputs of a layer whose output
    dimension is split (column parallel: the mapper's wide linears).

The functions run under `torch.no_grad` too (decode), where only their
forward matters. This module imports no model code, so parallel/mesh.py
and train/optim.py import it without a cycle.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


class TPGroup:
    """A tp process group with its size and this process's rank in it.
    A module that carries one keeps it through `copy.deepcopy` (the
    decode cast copies the decoder): a process group is not copied."""

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, size, rank

    def __deepcopy__(self, memo):
        return self

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyIn.apply(x, self)

    def reduce_out(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceOut.apply(x, self)

    def gather_out(self, x: torch.Tensor) -> torch.Tensor:
        return _GatherOut.apply(x, self)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.tp.group)
        return g, None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=tp.group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(tp.size)]
        dist.all_gather(parts, x, group=tp.group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        return g.chunk(tp.size, dim=-1)[tp.rank].contiguous(), None


class ColumnParallelLinear(torch.nn.Module):
    """An `nn.Linear` whose weight [out, in] holds this rank's rows of the
    output: y = gather(x @ W_t^T) + b, the bias replicated and added after
    the gather. Its parameters keep the names `weight` and `bias`, so the
    state_dict keys are the linear's."""

    def __init__(self, weight: torch.nn.Parameter,
                 bias: Optional[torch.nn.Parameter], tp: TPGroup):
        super().__init__()
        self.weight = weight
        self.bias = bias
        self.tp = tp

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.tp.gather_out(torch.nn.functional.linear(
            self.tp.copy_in(x), self.weight))
        return y if self.bias is None else y + self.bias
