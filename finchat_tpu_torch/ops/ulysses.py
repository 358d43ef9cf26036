"""Ulysses sequence parallelism: the all-to-all head scatter (the JAX
package's ``ops/ulysses.py``).

The other SP mode beside ring attention (``ops/ring_attention.py``), after
DeepSpeed-Ulysses: instead of rotating K/V blocks around the ring, one
all-to-all turns a rank's block of the sequence ``[B, S / n, H, D]`` into
the whole sequence of its head group ``[B, S, H / n, D]``
(``parallel/collectives.seq_to_heads``), each rank runs ordinary
full-sequence attention over its group, and a second all-to-all restores
the sequence blocks. Two collectives in all against the ring's ``n - 1``
hops, at the cost of ``heads % n == 0`` and a whole sequence of attention
on every rank.

GQA: the K/V heads scatter over the same axis, so ``n`` must divide
``n_kv_heads`` too (else the engine falls back to ring). Contiguous head
groups stay aligned with the GQA groups.

As in ``ops/ring_attention.py``, each function runs on one rank, SPMD, over
its block of the sequence and its tensor-parallel heads. The full-sequence
attention is the contiguous one (``ops/dispatch.contiguous_attention``: K7
on the card, its plain version on the CPU); the segment variant keeps the
reference's blockwise online fold in fp32.
"""

from __future__ import annotations

import torch

from finchat_tpu_torch.ops.ring_attention import (
    _carry,
    _finish,
    fold_prefix_blocks,
    online_fold,
)
from finchat_tpu_torch.parallel.collectives import heads_to_seq, seq_to_heads


def ulysses_supported(n_heads: int, n_kv_heads: int, mesh, axis: str = "seq",
                      head_axis: str | None = None) -> bool:
    """THE divisibility predicate of the head scatter, shared by the ops'
    check and the engine's ``sp_mode`` resolution: the heads of a
    tensor-parallel shard (``head_axis``), query and KV, must divide by the
    ``axis`` extent. ``n_heads`` and ``n_kv_heads`` are the whole model's."""
    n = mesh.shape.get(axis, 1)
    tp = mesh.shape.get(head_axis, 1) if head_axis else 1
    return not (n_heads % tp or n_kv_heads % tp
                or (n_heads // tp) % n or (n_kv_heads // tp) % n)


def _check(q: torch.Tensor, k: torch.Tensor, mesh, axis: str, head_axis: str | None) -> None:
    """Raise on heads the scatter cannot split (``q``, ``k`` hold a
    tensor-parallel shard's heads when ``head_axis`` shards them)."""
    tp = mesh.shape.get(head_axis, 1) if head_axis else 1
    H, Hkv = q.shape[2] * tp, k.shape[2] * tp
    if not ulysses_supported(H, Hkv, mesh, axis=axis, head_axis=head_axis):
        raise ValueError(
            f"ulysses needs per-shard heads divisible by the seq axis: H={H}, Hkv={Hkv}, "
            f"mesh={mesh.shape} — use ring attention instead")


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, mesh,
                      axis: str = "seq", head_axis: str | None = None,
                      causal: bool = True) -> torch.Tensor:
    """Sequence-parallel attention of this rank's block by head scatter:
    ``q`` [B, S / n, H, D], ``k``, ``v`` [B, S / n, Hkv, D]; returns this
    rank's block of the output [B, S / n, H, D]. Raises ``ValueError`` when
    the seq axis does not divide a shard's heads."""
    from finchat_tpu_torch.ops.dispatch import contiguous_attention

    _check(q, k, mesh, axis, head_axis)
    q_h = seq_to_heads(q, mesh, axis)  # [B, S, H / n, D]: the whole sequence, my group
    k_h = seq_to_heads(k, mesh, axis)
    v_h = seq_to_heads(v, mesh, axis)
    out_h = contiguous_attention(q_h.contiguous(), k_h.contiguous(), v_h.contiguous(),
                                 causal=causal)
    return heads_to_seq(out_h, mesh, axis)


def ulysses_attention_with_prefix(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  k_prefix: torch.Tensor, v_prefix: torch.Tensor,
                                  prefix_len: int, *, mesh, axis: str = "seq",
                                  head_axis: str | None = None, causal: bool = True,
                                  seg_block: int = 1024) -> torch.Tensor:
    """Ulysses attention for ONE SEGMENT of a longer sequence: the segment
    scattered to head groups as usual, then this rank's head group of the
    cached prefix ``k_prefix``, ``v_prefix`` [B, P, Hkv, D] (the whole
    prefix on every seq rank, padded past ``prefix_len``) folded into the
    online-softmax carry before the segment's own causal attention, which
    folds blockwise (``seg_block`` keys a block). Raises ``ValueError`` as
    ``ulysses_attention`` does."""
    _check(q, k, mesh, axis, head_axis)
    n = mesh.shape.get(axis, 1)
    idx = mesh.coords.get(axis, 0)
    q_h = seq_to_heads(q, mesh, axis)
    k_h = seq_to_heads(k, mesh, axis)
    v_h = seq_to_heads(v, mesh, axis)
    B, S, Hg, D = q_h.shape
    hkv_g = k_prefix.shape[2] // n  # contiguous groups keep the GQA groups aligned
    kp = k_prefix[:, :, idx * hkv_g:(idx + 1) * hkv_g]
    vp = v_prefix[:, :, idx * hkv_g:(idx + 1) * hkv_g]
    q32 = q_h.float()
    scale = D ** -0.5
    m, l, acc = fold_prefix_blocks(q32, kp, vp, prefix_len, *_carry(q_h), scale=scale, H=Hg)
    SB = min(seg_block, S)
    while S % SB:
        SB -= 1
    q_pos = torch.arange(S, device=q.device)
    for b in range(S // SB):
        kv_pos = b * SB + torch.arange(SB, device=q.device)
        invalid = (kv_pos[None, None, None, :] > q_pos[None, None, :, None]) if causal else None
        m, l, acc = online_fold(q32, k_h[:, b * SB:(b + 1) * SB], v_h[:, b * SB:(b + 1) * SB],
                                m, l, acc, scale=scale, H=Hg, invalid=invalid)
    return heads_to_seq(_finish(acc, l, q.dtype), mesh, axis)
