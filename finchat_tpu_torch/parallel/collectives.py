"""Collectives that autograd differentiates: the ones GSPMD inserts for the
JAX package's sharded train step (``train/train_step.py`` over a mesh) and
that its pipeline's manual Megatron stage block issues by hand.

- ``copy_to_group(x, group)``: identity forward, the sum over ``group`` of
  the gradient backward (a bf16 one summed in fp32 and rounded once). It
  goes where a replicated activation enters a product sharded over
  ``group``: each rank's gradient of ``x`` is its part of the whole one.
- ``reduce_from_group(x, group)``: the sum over ``group`` forward (in place:
  ``x`` must be a fresh result), identity backward. It goes where the
  partial sums of a sharded product leave it.
- ``mean_grads(params, group)``: every leaf's ``.grad`` averaged over
  ``group`` in place (the data axis's gradient reduce); ``mean_over`` a
  value's mean (the global loss).

A group of one rank (or ``None``) does no arithmetic and issues nothing, so
a one-rank mesh stays bit-equal to no mesh. With autograd off (serving) or
on a tensor that needs no gradient, ``copy_to_group`` is ``x`` itself and
``reduce_from_group`` one plain all-reduce: no node, no copy.

``COLLECTIVES`` counts the collectives issued, by kind (beside
``ops/tp_overlap.COLLECTIVES``, which counts the row-parallel outputs and
the head's logits gather): ``copy_to_group`` one a backward call,
``reduce_from_group`` one a forward call, ``mean_grads`` one a leaf,
``mean_over`` one a call.

Every rank of a group must issue the same collectives in the same order:
the backward's (the autograd engine runs the same graph in the same order
on every rank) and remat's recomputation of a layer's forward included.
"""

from __future__ import annotations

from typing import Any

import torch

COLLECTIVES: dict[str, int] = {"copy_to_group": 0, "reduce_from_group": 0, "mean_grads": 0,
                               "mean_over": 0}


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


def group_size(group) -> int:
    """The number of ranks of ``group`` (1 for ``None``)."""
    if group is None:
        return 1
    import torch.distributed as dist

    return dist.get_world_size(group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    dist.all_reduce(x, group=group)
    return x


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        COLLECTIVES["copy_to_group"] += 1
        if g.dtype in (torch.bfloat16, torch.float16):  # summed in fp32, rounded once
            return _all_reduce(g.float(), ctx.group).to(g.dtype), None
        # the incoming gradient may be shared with another branch (an add
        # hands one tensor to both of its inputs): sum a copy
        return _all_reduce(g.clone(memory_format=torch.contiguous_format), ctx.group), None


class _SumInPlace(torch.autograd.Function):
    """The sum over a group in place, identity backward (uncounted: the
    callers count under their own kind)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.mark_dirty(x)
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` forward; backward, its gradient summed over ``group``."""
    if group_size(group) == 1 or not _tracked(x):
        return x
    return _CopyToGroup.apply(x, group)


def sum_in_place(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` in place, differentiable with an identity
    backward; a plain in-place all-reduce when autograd does not track
    ``x``. Issued on a group of any size, one rank's included (the
    row-parallel output and the logits gather count it themselves)."""
    if not _tracked(x):
        return _all_reduce(x, group)
    return _SumInPlace.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (in place) forward; backward, its gradient
    as it comes."""
    if group_size(group) == 1:
        return x
    COLLECTIVES["reduce_from_group"] += 1
    return sum_in_place(x, group)


def _grad_leaves(tree: Any):
    if isinstance(tree, dict):
        for value in tree.values():
            yield from _grad_leaves(value)
    elif isinstance(tree, torch.Tensor) and tree.grad is not None:
        yield tree


def mean_grads(params: Any, group) -> None:
    """Every leaf's ``.grad`` of the tree ``params`` averaged over ``group``,
    in place, one all-reduce a leaf in the tree's order."""
    n = group_size(group)
    if n == 1:
        return
    for leaf in _grad_leaves(params):
        COLLECTIVES["mean_grads"] += 1
        _all_reduce(leaf.grad, group).div_(n)


def mean_over(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` averaged over ``group`` (a new tensor; ``x`` itself for one
    rank), outside autograd."""
    n = group_size(group)
    if n == 1:
        return x
    COLLECTIVES["mean_over"] += 1
    return _all_reduce(x.detach().clone(), group).div_(n)
