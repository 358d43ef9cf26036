"""Plain PyTorch reference attention (port of the JAX package's ops/refs.py).

The correctness oracle for the attention kernels and the CPU serving path.
Numerics policy: fp32 logits and softmax, softmax weights cast to the value
dtype before the weighted sum, output in the query dtype — the policy the
CUDA kernels implement.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30  # large-negative mask value; avoids NaN from (-inf) - (-inf)


def gqa_repeat(kv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Broadcast KV heads up to the query head count for grouped-query
    attention. kv: [..., n_kv_heads, head_dim] -> [..., n_heads, head_dim]."""
    n_kv = kv.shape[-2]
    if n_kv == n_heads:
        return kv
    assert n_heads % n_kv == 0, (n_heads, n_kv)
    return torch.repeat_interleave(kv, n_heads // n_kv, dim=-2)


def attention_mask(B: int, Sq: int, Sk: int, device, *, causal: bool,
                   q_offset: torch.Tensor | int = 0,
                   kv_len: torch.Tensor | None = None) -> torch.Tensor:
    """[B, 1, Sq, Sk] bool, True where query row i (absolute position
    ``q_offset + i``) may NOT see key j: a causal-future key, or one at or
    past ``kv_len``."""
    kv_pos = torch.arange(Sk, device=device)[None, None, None, :]
    mask = torch.zeros((B, 1, Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        if isinstance(q_offset, int):
            q_pos = (q_offset + torch.arange(Sq, device=device)).expand(B, Sq)
        else:
            q_pos = q_offset.long()[:, None] + torch.arange(Sq, device=device)[None, :]
        mask = mask | (kv_pos > q_pos[:, None, :, None])
    if kv_len is not None:
        mask = mask | (kv_pos >= kv_len.long()[:, None, None, None])
    return mask


def masked_logits(q: torch.Tensor, k: torch.Tensor, mask: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """fp32 ``scale * q . k`` [B, H, Sq, Sk] over GQA-repeated keys, masked
    positions set to ``NEG_INF``."""
    k = gqa_repeat(k, q.shape[2])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    return torch.where(mask, torch.full_like(logits, NEG_INF), logits)


def mha_reference(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, Hkv, D]
    v: torch.Tensor,  # [B, Sk, Hkv, D]
    *,
    causal: bool = True,
    q_offset: torch.Tensor | int = 0,  # absolute position of q[0] in the kv axis
    kv_len: torch.Tensor | None = None,  # [B] valid kv length (rest is padding)
    scale: float | None = None,
) -> torch.Tensor:
    """Masked multi-head attention with GQA, fp32 softmax.

    Query row i has absolute position ``q_offset + i`` and may attend to kv
    positions <= its own; ``kv_len`` masks right-padding per batch element.
    A row with every position masked gets uniform weights (the mask value is
    finite), exactly as the JAX reference does.
    """
    B, Sq, H, D = q.shape
    scale = scale if scale is not None else D ** -0.5
    mask = attention_mask(B, Sq, k.shape[1], q.device, causal=causal, q_offset=q_offset,
                          kv_len=kv_len)
    weights = torch.softmax(masked_logits(q, k, mask, scale), dim=-1)
    v = gqa_repeat(v, H)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype).float(), v.float())
    return out.to(q.dtype)
