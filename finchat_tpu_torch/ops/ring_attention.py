"""Ring attention over the ``seq`` mesh axis (the JAX package's
``ops/ring_attention.py``).

Long-prefill RAG prompts (unbounded history plus up to 10k retrieved
transactions) are the scaling axis this product has. Ring attention shards
the sequence over the ``seq`` ranks: each rank keeps its Q block and the K/V
blocks rotate around the ring (``parallel/collectives.ring_shift``), folded
into a blockwise online softmax, so a rank's activations stay O(S / n).

Each function here runs on ONE rank, SPMD: ``q`` [B, S / n, H, D] and ``k``,
``v`` [B, S / n, Hkv, D] are this rank's block of the sequence (block ``idx
= mesh.coords["seq"]``, its rows at global positions ``idx * S / n + i``)
and of its tensor-parallel heads; the result is this rank's block of the
output. Every rank of a seq line issues the same collectives in the same
order.

The math is the reference's, in fp32: the streaming-softmax recurrence,
masked logits set to ``-1e30`` and their probabilities zeroed explicitly
(never an ``exp`` of a -inf difference), so a block wholly in a query's
future contributes exactly nothing, and ``acc / max(l, 1e-30)`` at the end.
It is plain PyTorch, as the reference body is plain ``jnp`` with no Pallas
kernel.
"""

from __future__ import annotations

import torch

from finchat_tpu_torch.ops.refs import gqa_repeat
from finchat_tpu_torch.parallel.collectives import ring_shift

_NEG = -1e30


def online_fold(q32: torch.Tensor, k_blk: torch.Tensor, v_blk: torch.Tensor, m: torch.Tensor,
                l: torch.Tensor, acc: torch.Tensor, *, scale: float, H: int,
                invalid: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One streaming-softmax step, shared by every body that merges several
    K/V sources (ring hops, cached-prefix blocks, causal segment blocks):
    fold ``k_blk``/``v_blk`` [B, K, Hkv, D] into the carry (``m``, ``l`` [B,
    H, Sq], ``acc`` [B, H, Sq, D]) for queries ``q32`` [B, Sq, H, D] fp32.
    ``invalid`` broadcasts against the [B, H, Sq, K] logits (``None``: every
    key valid, the same numbers with no mask passes)."""
    k_rep = gqa_repeat(k_blk, H).float()
    v_rep = gqa_repeat(v_blk, H).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", q32, k_rep) * scale
    if invalid is not None:
        logits = logits.masked_fill(invalid, _NEG)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    p = torch.exp(logits - m_new[..., None])
    if invalid is not None:
        p = p.masked_fill(invalid, 0.0)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v_rep)
    return m_new, l_new, acc_new


def fold_prefix_blocks(q32: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor, prefix_len: int,
                       m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor, *, scale: float,
                       H: int, prefix_block: int = 1024
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fold a cached, possibly padded K/V prefix [B, P, Hkv, D] into the
    carry, blockwise, so [Sq, P] logits never materialize at the whole
    prefix's length. Every prefix position precedes every query; only the
    ``pos >= prefix_len`` padding tail masks."""
    P = kp.shape[1]
    PB = min(prefix_block, P)
    while P % PB:  # blocks tile the prefix exactly
        PB -= 1
    for b in range(P // PB):
        pos = b * PB + torch.arange(PB, device=q32.device)
        invalid = (pos >= prefix_len)[None, None, None, :]
        m, l, acc = online_fold(q32, kp[:, b * PB:(b + 1) * PB], vp[:, b * PB:(b + 1) * PB], m,
                                l, acc, scale=scale, H=H, invalid=invalid)
    return m, l, acc


def _carry(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The empty carry (m, l, acc) for queries ``q`` [B, Sq, H, D]."""
    B, Sq, H, D = q.shape
    dev = q.device
    return (torch.full((B, H, Sq), _NEG, dtype=torch.float32, device=dev),
            torch.zeros((B, H, Sq), dtype=torch.float32, device=dev),
            torch.zeros((B, H, Sq, D), dtype=torch.float32, device=dev))


def _finish(acc: torch.Tensor, l: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``acc / max(l, 1e-30)`` as [B, Sq, H, D] in ``dtype``."""
    return (acc / l.clamp(min=1e-30)[..., None]).transpose(1, 2).to(dtype)


def _ring_body(q: torch.Tensor, k0: torch.Tensor, v0: torch.Tensor, *, mesh, axis: str,
               n_blocks: int, causal: bool, scale: float, prefix=None,
               prefix_block: int = 1024) -> torch.Tensor:
    """This rank's ring. It holds block ``(idx - t) % n`` at step ``t``;
    ``n - 1`` hops in all (K and V ride one hop together), the last block
    folded without a trailing hop. A block wholly in this Q block's future
    skips its fold, never its hop: every rank issues the same hops in the
    same order. A block wholly in its past folds with no mask.

    ``prefix``: ``(k_prefix, v_prefix, prefix_len)``, already-cached earlier
    tokens (replicated over ``seq``; every position before every Q row),
    folded into the carry before the ring (the segmented serving prefill)."""
    B, Sq, H, D = q.shape
    idx = mesh.coords[axis] if n_blocks > 1 else 0
    dev = q.device
    q_pos = idx * Sq + torch.arange(Sq, device=dev)
    q32 = q.float()
    m, l, acc = _carry(q)
    if prefix is not None:
        kp, vp, prefix_len = prefix
        m, l, acc = fold_prefix_blocks(q32, kp, vp, prefix_len, m, l, acc, scale=scale, H=H,
                                       prefix_block=prefix_block)
    kv = torch.stack([k0, v0])  # one block a hop
    for t in range(n_blocks):
        src = (idx - t) % n_blocks
        if not causal or src < idx:
            m, l, acc = online_fold(q32, kv[0], kv[1], m, l, acc, scale=scale, H=H,
                                    invalid=None)
        elif src == idx:
            kv_pos = src * Sq + torch.arange(kv.shape[2], device=dev)
            invalid = kv_pos[None, None, None, :] > q_pos[None, None, :, None]
            m, l, acc = online_fold(q32, kv[0], kv[1], m, l, acc, scale=scale, H=H,
                                    invalid=invalid)
        if t < n_blocks - 1:
            kv = ring_shift(kv, mesh, axis)
    return _finish(acc, l, q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, mesh,
                   axis: str = "seq", head_axis: str | None = None,
                   causal: bool = True) -> torch.Tensor:
    """Sequence-parallel attention of this rank's block: ``q`` [B, S / n, H,
    D], ``k``, ``v`` [B, S / n, Hkv, D] (the heads a tensor-parallel shard's
    when ``head_axis`` shards them; the ring needs nothing of it). Returns
    this rank's block of the output, [B, S / n, H, D] in ``q``'s dtype."""
    del head_axis  # the heads are this rank's already
    n_blocks = mesh.shape.get(axis, 1) if mesh is not None else 1
    return _ring_body(q, k, v, mesh=mesh, axis=axis, n_blocks=n_blocks, causal=causal,
                      scale=q.shape[-1] ** -0.5)


def ring_attention_with_prefix(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               k_prefix: torch.Tensor, v_prefix: torch.Tensor,
                               prefix_len: int, *, mesh, axis: str = "seq",
                               head_axis: str | None = None,
                               causal: bool = True) -> torch.Tensor:
    """Ring attention for ONE SEGMENT of a longer sequence: the segment's
    blocks ride the ring as in ``ring_attention`` (causality inside a
    segment does not depend on its offset) while the cached prefix
    ``k_prefix``, ``v_prefix`` [B, P, Hkv, D] (the whole prefix on every seq
    rank, padded past ``prefix_len``) is folded into each rank's carry
    first. This is what lets the serving prefill run in segments between
    decode steps without losing attention to the earlier segments."""
    del head_axis
    n_blocks = mesh.shape.get(axis, 1) if mesh is not None else 1
    return _ring_body(q, k, v, mesh=mesh, axis=axis, n_blocks=n_blocks, causal=causal,
                      scale=q.shape[-1] ** -0.5, prefix=(k_prefix, v_prefix, prefix_len))
