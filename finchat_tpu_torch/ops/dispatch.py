"""Kernel dispatch for the engine: the kernel for a CUDA tensor, the plain
version for a CPU tensor.

The JAX package resolves a backend switch (``FINCHAT_ATTN``) once per
engine. Here the tensor's device is the switch, and this module is the only
place that reads it: a CUDA tensor always goes to the hand-written kernel's
wrapper (which launches or raises), a CPU tensor to its plain PyTorch
version. There is no environment variable and no fallback from a failed
kernel to the plain version.
"""

from __future__ import annotations

import torch

from finchat_tpu_torch.ops.kv_append import paged_kv_append, paged_kv_append_ref
from finchat_tpu_torch.ops.paged_attention import paged_attention_ref, paged_flash_attention
from finchat_tpu_torch.ops.ragged_paged_attention import (
    ragged_flash_attention,
    ragged_paged_attention_ref,
)


def paged_attention(
    q: torch.Tensor,  # [B, C, H, D]
    k_pages: torch.Tensor,  # [L, P, page_size, Hkv*D] — full-depth cache
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [B, max_pages]
    q_offset: torch.Tensor,  # [B]
    kv_len: torch.Tensor,  # [B]
    layer: int,
    *,
    page_size: int,
    n_kv: int,
) -> torch.Tensor:
    """Paged-KV attention (ops/paged_attention.py)."""
    fn = paged_flash_attention if q.is_cuda else paged_attention_ref
    return fn(q, k_pages, v_pages, page_table, q_offset, kv_len, layer,
              page_size=page_size, n_kv=n_kv)


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
) -> tuple[torch.Tensor, torch.Tensor]:
    """In-place decode KV append (ops/kv_append.py)."""
    fn = paged_kv_append if k_pages.is_cuda else paged_kv_append_ref
    return fn(kv_new, k_pages, v_pages, page_table, pos, n_valid, layer, page_size=page_size)


def ragged_paged_attention(
    q: torch.Tensor,  # [T, H, D] — packed ragged token buffer
    k_pages: torch.Tensor,  # [L, P, page_size, Hkv*D]
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
) -> torch.Tensor:
    """Ragged paged-KV attention (ops/ragged_paged_attention.py)."""
    fn = ragged_flash_attention if q.is_cuda else ragged_paged_attention_ref
    return fn(q, k_pages, v_pages, page_table, tok_row, tok_pos, kv_len, layer,
              page_size=page_size, n_kv=n_kv, kv_gap=kv_gap)
