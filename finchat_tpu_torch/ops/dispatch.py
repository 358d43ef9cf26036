"""Kernel dispatch for the engine: the kernel for a CUDA tensor, the plain
version for a CPU tensor.

The JAX package resolves a backend switch (``FINCHAT_ATTN``,
``FINCHAT_QUANT_MATMUL``) once per engine. Here the tensor's device is the
switch, and this module is the only place that reads it: a CUDA tensor
always goes to the hand-written kernel's wrapper (which launches or
raises), a CPU tensor to its plain PyTorch version. There is no environment
variable and no fallback from a failed kernel to the plain version. An int8
KV cache is detected from the page dtype, as the JAX dispatch does; its
scale planes must then be given.
"""

from __future__ import annotations

import torch

from finchat_tpu_torch.models.quant import Q4Tensor, QTensor
from finchat_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref
from finchat_tpu_torch.ops.kv_append import (
    KVRows,
    paged_kv_append,
    paged_kv_append_q8,
    paged_kv_append_q8_ref,
    paged_kv_append_ref,
    paged_kv_write,
    paged_kv_write_ref,
)
from finchat_tpu_torch.ops.paged_attention import (
    paged_attention_q8_ref,
    paged_attention_ref,
    paged_flash_attention,
    paged_flash_attention_q8,
)
from finchat_tpu_torch.ops.quant_matmul import (
    quant_matmul_int4,
    quant_matmul_int8,
    quant_matmul_ref,
)
from finchat_tpu_torch.ops.ragged_paged_attention import (
    RaggedPlan,
    ragged_flash_attention,
    ragged_flash_attention_q8,
    ragged_paged_attention_ref,
)


def _int8_cache(k_pages: torch.Tensor, k_scales, v_scales) -> bool:
    quantized = k_pages.dtype == torch.int8
    if quantized and (k_scales is None or v_scales is None):
        raise ValueError("an int8 KV cache needs its k_scales / v_scales planes")
    return quantized


def paged_attention(
    q: torch.Tensor,  # [B, C, H, D]
    k_pages: torch.Tensor,  # [L, P, page_size, Hkv*D] — full-depth cache (or int8)
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [B, max_pages]
    q_offset: torch.Tensor,  # [B]
    kv_len: torch.Tensor,  # [B]
    layer: int,
    *,
    page_size: int,
    n_kv: int,
    k_scales: torch.Tensor | None = None,  # int8 cache: [L, P, scale_rows, page_size] fp32
    v_scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """Paged-KV attention (ops/paged_attention.py)."""
    kw = dict(page_size=page_size, n_kv=n_kv)
    if _int8_cache(k_pages, k_scales, v_scales):
        fn = paged_flash_attention_q8 if q.is_cuda else paged_attention_q8_ref
        return fn(q, k_pages, v_pages, k_scales, v_scales, page_table, q_offset, kv_len,
                  layer, **kw)
    fn = paged_flash_attention if q.is_cuda else paged_attention_ref
    return fn(q, k_pages, v_pages, page_table, q_offset, kv_len, layer, **kw)


def kv_append(
    kv_new: torch.Tensor,  # [B, 1, 2*Hkv*D] — fused k row ++ v row per sequence
    k_pages: torch.Tensor,  # [L, P, page_size, Hkv*D]
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [B, max_pages]
    pos: torch.Tensor,  # [B]
    n_valid: torch.Tensor,  # [B]
    layer: int,
    *,
    page_size: int,
    n_kv: int | None = None,  # KV heads: needed by the int8 cache
    k_scales: torch.Tensor | None = None,
    v_scales: torch.Tensor | None = None,
) -> None:
    """In-place decode KV append (ops/kv_append.py); an int8 cache
    quantizes the rows per head and writes their scales."""
    if _int8_cache(k_pages, k_scales, v_scales):
        if n_kv is None:
            raise ValueError("an int8 KV append needs n_kv")
        fn = paged_kv_append_q8 if k_pages.is_cuda else paged_kv_append_q8_ref
        fn(kv_new, k_pages, v_pages, k_scales, v_scales, page_table, pos, n_valid, layer,
           page_size=page_size, n_kv=n_kv)
        return
    fn = paged_kv_append if k_pages.is_cuda else paged_kv_append_ref
    fn(kv_new, k_pages, v_pages, page_table, pos, n_valid, layer, page_size=page_size)


def kv_write(
    plan: KVRows,  # the step's rows (ops/kv_append.plan_kv_rows / plan_kv_rows_ragged)
    k: torch.Tensor,  # [N, Hkv*D] — the layer's K rows (after rope), N = plan.rows.numel()
    v: torch.Tensor,  # [N, Hkv*D]
    k_pages: torch.Tensor,  # [L, P, page_size, Hkv*D] (or int8)
    v_pages: torch.Tensor,
    layer: int,
    *,
    n_kv: int,
    k_scales: torch.Tensor | None = None,
    v_scales: torch.Tensor | None = None,
) -> None:
    """Write one layer's K/V rows of a step into the paged cache, in place
    (ops/kv_append.py): the KV-row writer on the card, the chunk scatter on
    the CPU; an int8 cache quantizes each head row and writes its scale."""
    scales = dict(k_scales=k_scales, v_scales=v_scales, n_kv=n_kv)
    _int8_cache(k_pages, k_scales, v_scales)
    if k.is_cuda:
        paged_kv_write(plan.rows, k, v, k_pages, v_pages, layer, **scales)
    else:
        paged_kv_write_ref(plan, k, v, k_pages, v_pages, layer, **scales)


def ragged_paged_attention(
    q: torch.Tensor,  # [T, H, D] — packed ragged token buffer
    k_pages: torch.Tensor,  # [L, P, page_size, Hkv*D] (or int8)
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [R, max_pages] — per-ROW physical page lists
    tok_row: torch.Tensor,  # [T] — owning row per packed token (R = padding)
    tok_pos: torch.Tensor,  # [T] — absolute position per packed token
    kv_len: torch.Tensor,  # [R] — valid KV per row incl. this dispatch's tokens
    layer: int,
    *,
    page_size: int,
    n_kv: int,
    kv_gap: torch.Tensor | None = None,  # [R] — bounded-KV window offset per row
    k_scales: torch.Tensor | None = None,
    v_scales: torch.Tensor | None = None,
    plan: RaggedPlan | None = None,  # the round's descriptors (plan_ragged), built once
) -> torch.Tensor:
    """Ragged paged-KV attention (ops/ragged_paged_attention.py). With a
    ``plan``, the kernels take its descriptors and the plain version its
    compacted positions and lengths (the same numbers either way)."""
    kw = dict(page_size=page_size, n_kv=n_kv, kv_gap=kv_gap)
    if _int8_cache(k_pages, k_scales, v_scales):
        if q.is_cuda:
            return ragged_flash_attention_q8(q, k_pages, v_pages, k_scales, v_scales,
                                             page_table, tok_row, tok_pos, kv_len, layer,
                                             plan=plan, **kw)
    elif q.is_cuda:
        return ragged_flash_attention(q, k_pages, v_pages, page_table, tok_row, tok_pos, kv_len,
                                      layer, plan=plan, **kw)
    if plan is not None:  # the plan holds the compacted coordinates
        tok_pos, kv_len, kw["kv_gap"] = plan.tok_pos, plan.kv_len, None
    return ragged_paged_attention_ref(q, k_pages, v_pages, page_table, tok_row, tok_pos, kv_len,
                                      layer, k_scales=k_scales, v_scales=v_scales, **kw)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Full contiguous causal attention (training, one-shot forward): K7's
    differentiable kernel on the card, the plain ``flash_attention_ref``
    (plain autograd) on the CPU."""
    if q.is_cuda:
        return flash_attention(q, k, v, causal=True)
    return flash_attention_ref(q, k, v, causal=True)[0]


def quant_matmul(x: torch.Tensor, w: QTensor | Q4Tensor,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x @ dequant(w)`` (ops/quant_matmul.py): the int8 or int4 kernel on
    the card, ``quant_matmul_ref`` on the CPU; ``out_dtype=torch.float32``
    for the lm_head's logits."""
    if not x.is_cuda:
        return quant_matmul_ref(x, w, out_dtype=out_dtype)
    fn = quant_matmul_int4 if isinstance(w, Q4Tensor) else quant_matmul_int8
    return fn(x, w.q, w.scale, out_dtype=out_dtype)
