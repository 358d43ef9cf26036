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

Sequence parallelism's collectives (serving's long-prompt prefill; forward
only, outside autograd) move a rank's block of the sequence over the mesh's
``seq`` axis:

- ``ring_shift(x, mesh)``: every rank's block to the next seq rank, the
  previous rank's block in (``lax.ppermute`` with ``perm = [(i, (i + 1) %
  n)]``): one block a hop, by a broadcast over each neighbour pair
  (``("seq", s)``) in pair order, which gloo takes for CUDA tensors and which
  no cycle of waits can deadlock;
- ``seq_to_heads`` / ``heads_to_seq``: the tiled all-to-alls of Ulysses
  attention, ``[B, S / n, h, D]`` to ``[B, S, h / n, D]`` and back;
- ``gather_seq``: every rank's block along the sequence (the KV cache is
  replicated over ``seq``, so every rank writes every token's row);
- ``broadcast_seq``: one seq rank's tensor on every seq rank (the last valid
  token's hidden row).

A group of one rank (or ``None``) does no arithmetic and issues nothing, so
a one-rank mesh stays bit-equal to no mesh. With autograd off (serving) or
on a tensor that needs no gradient, ``copy_to_group`` is ``x`` itself and
``reduce_from_group`` one plain all-reduce: no node, no copy.

``COLLECTIVES`` counts the collectives issued, by kind (beside
``ops/tp_overlap.COLLECTIVES``, which counts the row-parallel outputs and
the head's logits gather): ``copy_to_group`` one a backward call,
``reduce_from_group`` one a forward call, ``mean_grads`` one a leaf,
``mean_over`` one a call, and each sequence collective one a call (its
key made at its first count, so a process that runs none counts what it
always did).

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


# --- sequence parallelism (forward only) ----------------------------------------------


def _count(kind: str) -> None:
    COLLECTIVES[kind] = COLLECTIVES.get(kind, 0) + 1


def _seq(mesh, axis: str) -> tuple[int, int]:
    """(size, this rank's index) of ``axis`` (1, 0 with no mesh)."""
    if mesh is None:
        return 1, 0
    return mesh.shape.get(axis, 1), mesh.coords.get(axis, 0)


def ring_shift(x: torch.Tensor, mesh, axis: str = "seq") -> torch.Tensor:
    """The previous seq rank's ``x`` (every rank's to the next). Pair ``i``
    (seq ranks ``i`` and ``(i + 1) % n``) broadcasts from ``i``, pairs in
    order: rank ``i`` receives on pair ``i - 1`` before it sends on pair
    ``i`` (rank 0 sends first), so the hops chain and never wait in a
    cycle."""
    n, idx = _seq(mesh, axis)
    if n == 1:
        return x
    import torch.distributed as dist

    _count("ring_shift")
    x = x.contiguous()
    out = torch.empty_like(x)
    for i in range(n):
        if idx in (i, (i + 1) % n):
            dist.broadcast(x if idx == i else out, src=mesh.peer(axis, i),
                           group=mesh.group((axis, i)))
    return out


def _all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x [n, ...]``: block ``j`` to seq rank ``j``; returns the blocks
    from every rank, ``[n, ...]`` in rank order."""
    import torch.distributed as dist

    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=mesh.group(axis))
    return out


def seq_to_heads(x: torch.Tensor, mesh, axis: str = "seq") -> torch.Tensor:
    """``[B, S / n, h, D]`` (this rank's block of the sequence) to ``[B, S,
    h / n, D]`` (the whole sequence of this rank's head group, contiguous
    heads: ``lax.all_to_all(split_axis=2, concat_axis=1, tiled=True)``)."""
    n, _ = _seq(mesh, axis)
    if n == 1:
        return x
    _count("seq_to_heads")
    B, Sq, h, D = x.shape
    blocks = x.reshape(B, Sq, n, h // n, D).permute(2, 0, 1, 3, 4)
    got = _all_to_all(blocks, mesh, axis)  # [n, B, Sq, h / n, D], by seq block
    return got.permute(1, 0, 2, 3, 4).reshape(B, n * Sq, h // n, D)


def heads_to_seq(x: torch.Tensor, mesh, axis: str = "seq") -> torch.Tensor:
    """``seq_to_heads``'s inverse: ``[B, S, h / n, D]`` to ``[B, S / n, h,
    D]``."""
    n, _ = _seq(mesh, axis)
    if n == 1:
        return x
    _count("heads_to_seq")
    B, S, hg, D = x.shape
    blocks = x.reshape(B, n, S // n, hg, D).permute(1, 0, 2, 3, 4)
    got = _all_to_all(blocks, mesh, axis)  # [n, B, S / n, hg, D], by head group
    return got.permute(1, 2, 0, 3, 4).reshape(B, S // n, n * hg, D)


def gather_seq(x: torch.Tensor, mesh, axis: str = "seq", dim: int = 0) -> torch.Tensor:
    """Every seq rank's ``x`` concatenated along ``dim`` in rank order."""
    n, _ = _seq(mesh, axis)
    if n == 1:
        return x
    import torch.distributed as dist

    _count("gather_seq")
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=mesh.group(axis))
    return torch.cat(parts, dim=dim)


def broadcast_seq(x: torch.Tensor, mesh, src: int, axis: str = "seq") -> torch.Tensor:
    """Seq rank ``src``'s ``x`` on every seq rank (``x`` is the buffer the
    others receive into, of the same shape and dtype)."""
    n, _ = _seq(mesh, axis)
    if n == 1:
        return x
    import torch.distributed as dist

    _count("broadcast_seq")
    x = x.contiguous()
    dist.broadcast(x, src=mesh.peer(axis, src), group=mesh.group(axis))
    return x
