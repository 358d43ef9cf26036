"""The row-parallel layer output under tensor parallelism, with the
collective overlapped with the matmul (the JAX package's
``ops/tp_overlap.py``).

Under TP each decoder layer ends in two all-reduces: the attention output
projection and the MLP down projection (``models/llama._layer``). Serially
the matmul must finish before the collective starts, and the collective
before the residual add. ``row_parallel_dense`` with ``overlap=True``
chunks the matmul along its OUTPUT columns and issues each chunk's
all-reduce as soon as that chunk's product is done, so the collective of
chunk c runs while chunk c + 1 multiplies.

- The serial schedule (the default, every backend) is one plain in-place
  all-reduce of the whole output.
- Each output element keeps the same full-K product and the same one
  reduction over the ranks. The chunked sums agree byte for byte with a
  whole row's only if each element's partials are added in an order that
  does not depend on the buffer: a ring all-reduce starts each segment of
  the buffer at another rank, and a chunk's segments are not the whole
  row's. Two ranks add in the one order there is (a + b == b + a), so up to
  two ranks a chunk is a plain all-reduce and the knob changes no bit. From
  three ranks on the overlapped schedule gathers every rank's partial
  exactly (each into a zero slot of its own, all-reduced: x + 0 = x) and
  sums them in rank order on every rank: it is then byte-identical to its
  own one-chunk form (``n_chunks=1``), not to the plain all-reduce, and
  moves ``tp`` times its bytes. Only a caller that turns the knob on pays
  that; the serial schedule never does.
- ``COLLECTIVES`` counts the collectives issued, by kind (the JAX package's
  test counts ``psum`` equations in the jaxpr): ``n_chunks`` a chunked call,
  one a serial call.
- Under autograd (training over a mesh, plain weights) the output is
  differentiable with the row-parallel rule: the sum over the ranks
  forward, the gradient as it comes backward. Over more than one rank both
  schedules are one node (``_RowParallel``) whose backward is the plain
  product's own (the same two matmuls on the whole output gradient), so the
  knob changes no bit of a gradient either; a bf16 rank's part is taken
  with an fp32 result and summed in fp32, rounded once, as one device
  rounds its whole contraction once (summing rounded parts would move a
  routed MoE token's experts on near ties). On one rank the serial schedule
  is autograd's own product, bit-equal to no mesh.
- A quantized weight is chunked WITHOUT unpacking, and once, at placement
  (``chunk_row_parallel``): each chunk is a contiguous weight of its own, so
  the fused dequant matmul gets contiguous, aligned operands on every call.
  An unprepared weight is sliced per call (``_slice_out_cols``).

Gate: ``engine.tp_overlap`` / ``FINCHAT_TP_OVERLAP`` (default off) and
``engine.tp_overlap_chunks``, read by the TP engine. The JAX package's
GSPMD serve never reads the knob (only its manual-TP pipeline stages do);
in the port, up to two ranks, it changes the serve only by the order of
its launches, never by its bits; from three ranks its bits are those of
the same knob at one chunk.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from finchat_tpu_torch.models.quant import Q4Tensor, QTensor, dense, dense_fp32
from finchat_tpu_torch.parallel.collectives import group_size, sum_in_place
from finchat_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# collectives issued, by kind: "row_parallel" (row_parallel_dense) and
# "logits_gather" (models/llama.lm_head under TP)
COLLECTIVES: dict[str, int] = {"row_parallel": 0, "logits_gather": 0}


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


@dataclass(frozen=True)
class TPShard:
    """A rank's place in the tensor-parallel group (``LlamaConfig.tp``):
    the ``model`` axis's process group, its size, this rank's index on it,
    and the ``tp_overlap`` knob with its chunk count. An MoE layer's
    experts split over ``expert`` too: ``expert_group`` is the
    ``("expert", "model")`` group its output sums over, ``ep_size`` and
    ``ep_rank`` this rank's place on ``expert``."""

    group: Any
    size: int
    rank: int
    overlap: bool = False
    n_chunks: int = 4
    expert_group: Any = None
    ep_size: int = 1
    ep_rank: int = 0


@dataclass(frozen=True)
class ColumnChunks:
    """A row-parallel weight cut once into ``len(parts)`` output-column
    chunks, each a contiguous leaf of its own (a tensor, ``QTensor`` or
    ``Q4Tensor``). Indexes like the stacked leaf it replaces."""

    parts: tuple

    def __getitem__(self, i) -> "ColumnChunks":
        return ColumnChunks(tuple(p[i] for p in self.parts))

    @property
    def shape(self) -> tuple[int, ...]:
        first = self.parts[0].shape
        return tuple(first[:-1]) + (sum(p.shape[-1] for p in self.parts),)


def _slice_out_cols(w, start: int, size: int):
    """Slice the OUTPUT (last) axis of a plain or quantized weight (a
    ``Q4Tensor``'s nibble pairs run along K, so a column slice never splits
    a byte)."""
    if isinstance(w, (QTensor, Q4Tensor)):
        return type(w)(q=w.q[..., start:start + size], scale=w.scale[..., start:start + size])
    return w[..., start:start + size]


def _contiguous(w):
    if isinstance(w, (QTensor, Q4Tensor)):
        return type(w)(q=w.q.contiguous(), scale=w.scale.contiguous())
    return w.contiguous()


def chunk_row_parallel(w, n_chunks: int):
    """``w`` cut once into ``n_chunks`` contiguous output-column chunks
    (``ColumnChunks``), or ``w`` itself for one chunk or when the chunks do
    not divide its output dim (the call then runs serial)."""
    N = w.shape[-1]
    if n_chunks <= 1 or N % n_chunks:
        return w
    size = N // n_chunks
    return ColumnChunks(tuple(_contiguous(_slice_out_cols(w, c * size, size))
                              for c in range(n_chunks)))


def row_parallel_dense(x: torch.Tensor, w, group, *, overlap: bool = False,
                       n_chunks: int = 4) -> torch.Tensor:
    """``all_reduce(x @ w)`` over ``group``: the row-parallel layer output.
    ``x`` is this rank's slice of the contraction dim, ``w`` its
    ``[K_local, N]`` shard (plain or quantized; ``ColumnChunks`` for the
    overlapped schedule only). Serial (``overlap=False``): one ``dense`` and
    one plain all-reduce in place. Overlapped: ``n_chunks`` output-column
    chunks, each chunk's sum issued as soon as its product is done
    (asynchronously, except under CUDA graph capture, where each is issued
    in stream order), waited on together, then concatenated; from three
    ranks each sum is taken in rank order (``_ordered_sum``). An output dim
    the chunks do not divide runs serial, with a warning."""
    N = w.shape[-1]
    chunks = 0
    if overlap and not isinstance(w, ColumnChunks):
        if n_chunks >= 1 and N % n_chunks == 0:
            chunks = n_chunks
        else:
            logger.warning("tp_overlap: output dim %d not divisible into %d chunks; running the "
                           "serial collective", N, n_chunks)
    if (isinstance(w, torch.Tensor) and torch.is_grad_enabled()
            and (x.requires_grad or w.requires_grad)
            and (chunks or group_size(group) > 1)):
        return _RowParallel.apply(x, w, group, chunks)
    if overlap and isinstance(w, ColumnChunks):
        return _chunked(x, w.parts, group)
    if chunks:
        return _chunked(x, _column_parts(w, chunks), group)
    y = dense(x, w)  # under autograd on one rank: autograd's own product, as with no mesh
    COLLECTIVES["row_parallel"] += 1
    return sum_in_place(y, group)


def _column_parts(w, chunks: int) -> tuple:
    """``w`` as ``chunks`` output-column slices (itself for one)."""
    if chunks == 1:
        return (w,)
    size = w.shape[-1] // chunks
    return tuple(_slice_out_cols(w, c * size, size) for c in range(chunks))


def _chunked(x: torch.Tensor, parts: tuple, group, product=dense) -> torch.Tensor:
    """The overlapped schedule over the weight's column chunks ``parts``."""
    async_op = not (x.is_cuda and torch.cuda.is_current_stream_capturing())
    pending = [_ordered_sum(product(x, p), group, async_op) for p in parts]
    if len(pending) == 1:
        return pending[0]()
    return torch.cat([finish() for finish in pending], dim=-1)


class _RowParallel(torch.autograd.Function):
    """The row-parallel output as one autograd node: serial (``chunks`` 0:
    one product, one sum) or overlapped. Over more than one rank a bf16
    part is taken with an fp32 result and summed in fp32, then rounded once.
    Its backward is the plain product's (``x @ w`` folds ``x`` to ``[T,
    K]`` and autograd takes ``g @ w^T`` and ``x^T @ g``), whatever the
    schedule."""

    @staticmethod
    def forward(ctx, x, w, group, chunks):
        ctx.save_for_backward(x, w)
        wide = x.dtype != torch.float32 and group_size(group) > 1
        product = dense_fp32 if wide else dense
        if chunks:
            y = _chunked(x, _column_parts(w, chunks), group, product)
        else:
            y = product(x, w)
            COLLECTIVES["row_parallel"] += 1
            sum_in_place(y, group)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, w.shape[-1])
        gx = g2.mm(w.t()).view(x.shape) if ctx.needs_input_grad[0] else None
        gw = x.reshape(-1, w.shape[0]).t().mm(g2) if ctx.needs_input_grad[1] else None
        return gx, gw, None, None


def _ordered_sum(y: torch.Tensor, group, async_op: bool):
    """Issue the sum of ``y`` over ``group``'s ranks in an order that does
    not depend on the buffer (one collective, counted); returns the function
    that waits for it and gives the sum. Up to two ranks a plain all-reduce
    in place; from three on the exact gather into rank slots, then the
    partials added in rank order."""
    import torch.distributed as dist

    COLLECTIVES["row_parallel"] += 1
    tp = dist.get_world_size(group)
    if tp <= 2:
        work = dist.all_reduce(y, group=group, async_op=async_op)

        def plain() -> torch.Tensor:
            if work is not None:
                work.wait()
            return y

        return plain
    slots = y.new_zeros((tp,) + tuple(y.shape))
    slots[dist.get_rank(group)] = y
    work = dist.all_reduce(slots, group=group, async_op=async_op)

    def in_rank_order() -> torch.Tensor:
        if work is not None:
            work.wait()
        total = slots[0].clone()
        for r in range(1, tp):
            total += slots[r]
        return total

    return in_rank_order
